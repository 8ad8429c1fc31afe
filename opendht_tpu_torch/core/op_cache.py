"""Listen-operation dedup caches (reference src/op_cache.{h,cpp}).

A copy of the JAX package's ``core/op_cache.py`` with its behaviour unchanged.

Identical/overlapping ``listen`` calls share one network subscription:

- :class:`OpValueCache` — ref-counts values across the underlying
  subscriptions feeding it (a value announced by several network ops
  expires only when all of them expire it).
- :class:`OpCache` — one network op + its local listeners; lingers 60 s
  after the last listener leaves so a quick re-listen reuses it.
- :class:`SearchCache` — maps Query → OpCache per search, routing a new
  listen to an existing op whose query satisfies it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..utils import TIME_MAX
from .listener import LocalListener, ValueCallback
from .value import Filter, Filters, Query, Value

OP_LINGER = 60.0                 # op_cache.h:120: EXPIRATION


@dataclass
class _RefSlot:
    data: Value
    ref_count: int = 1


class OpValueCache:
    """(op_cache.h:26-67, op_cache.cpp:25-80)"""

    def __init__(self, callback: ValueCallback):
        self._values: Dict[int, _RefSlot] = {}
        self._callback = callback

    @staticmethod
    def cache_callback(cb: ValueCallback) -> ValueCallback:
        """Wrap a user callback so repeated adds/partial expires collapse
        (used around Dht.listen user cbs, dht.cpp:836)."""
        cache = OpValueCache(cb)
        return cache.on_value

    def on_value(self, vals: List[Value], expired: bool) -> bool:
        return self.on_values_expired(vals) if expired else self.on_values_added(vals)

    def on_values_added(self, vals: List[Value]) -> bool:
        new_values = []
        for v in vals:
            slot = self._values.get(v.id)
            if slot is None:
                self._values[v.id] = _RefSlot(v)
                new_values.append(v)
            else:
                slot.ref_count += 1
        if not new_values:
            return True
        # only an explicit False unsubscribes (None stays subscribed,
        # matching LocalListener.notify)
        return self._callback(new_values, False) is not False

    def on_values_expired(self, vals: List[Value]) -> bool:
        gone = []
        for v in vals:
            slot = self._values.get(v.id)
            if slot is not None:
                slot.ref_count -= 1
                if slot.ref_count == 0:
                    gone.append(slot.data)
                    del self._values[v.id]
        if not gone:
            return True
        return self._callback(gone, True) is not False

    def get(self, f: Optional[Filter] = None) -> List[Value]:
        return Filters.apply(f, (s.data for s in self._values.values()))

    def get_by_id(self, vid: int) -> Optional[Value]:
        slot = self._values.get(vid)
        return slot.data if slot else None

    def get_values(self) -> List[Value]:
        return [s.data for s in self._values.values()]


class OpCache:
    """One shared network listen + its local listeners
    (op_cache.h:70-127)."""

    def __init__(self, now: float = 0.0, clock=None):
        self.cache = OpValueCache(self._dispatch)
        self._listeners: Dict[int, LocalListener] = {}
        self._last_removed = now
        self._clock = clock
        self.search_token = 0       # token of the underlying network op

    def on_value(self, vals: List[Value], expired: bool) -> bool:
        """Feed from the network op.  Always True: the shared op must
        survive the 60 s listener-less linger so a quick re-listen reuses
        a live subscription — teardown happens only through
        SearchCache.expire/cancel_all cancelling ``search_token``."""
        self.cache.on_value(vals, expired)
        return True

    def _dispatch(self, vals: List[Value], expired: bool) -> bool:
        # A callback returning False unsubscribes (the ValueCallback
        # contract, listener.py); notify() also skips listeners whose
        # filter leaves nothing.
        for token, l in list(self._listeners.items()):
            if not l.notify(vals, expired):
                self._listeners.pop(token, None)
                if self._clock is not None:
                    self._last_removed = self._clock()
        return True

    def add_listener(self, token: int, cb: ValueCallback, query: Optional[Query],
                     f: Optional[Filter], now: float = 0.0) -> None:
        """Register + replay current cache state (op_cache.h:87-90).
        Replay goes through notify(): nothing fires when the cache holds
        nothing the filter passes, and an explicit False return
        unsubscribes immediately (one-shot listener satisfied from
        cache)."""
        l = LocalListener(query, f, cb)
        self._listeners[token] = l
        if not l.notify(self.cache.get(), False):
            self._listeners.pop(token, None)
            self._last_removed = now

    def remove_listener(self, token: int, now: float) -> bool:
        self._last_removed = now
        return self._listeners.pop(token, None) is not None

    def remove_all(self) -> None:
        self._listeners.clear()

    def is_done(self) -> bool:
        return not self._listeners

    def get_expiration(self) -> float:
        return TIME_MAX if self._listeners else self._last_removed + OP_LINGER

    def is_expired(self, now: float) -> bool:
        # inclusive boundary, matching SearchCache.expire: an op whose
        # linger ends exactly now IS expired (a strict '<' here would
        # re-inherit the exp == now virtual-clock live-lock)
        return not self._listeners and self.get_expiration() <= now

    def get(self, f: Optional[Filter] = None) -> List[Value]:
        return self.cache.get(f)


class SearchCache:
    """Query-keyed registry of shared listen ops (op_cache.h:129-153).
    ``clock`` (e.g. ``scheduler.time``) timestamps listener removals that
    happen inside value dispatch, so the linger window is measured from
    the true last removal."""

    def __init__(self, clock=None):
        self._ops: Dict[Query, OpCache] = {}
        self._clock = clock
        self._next_token = 1
        self._next_expiration = TIME_MAX

    def listen(self, get_cb: ValueCallback, query: Query, f: Optional[Filter],
               on_listen: Callable[[Query, ValueCallback], int],
               now: float = 0.0) -> int:
        """Attach a listener, creating the network op only if no
        existing op's query satisfies this one (op_cache.cpp:166-193).
        ``on_listen(query, cb)`` starts the network op and returns its
        token."""
        op = self._ops.get(query)
        if op is None:
            for q, cand in self._ops.items():
                if query.is_satisfied_by(q):
                    op = cand
                    break
        if op is None:
            op = OpCache(now, clock=self._clock)
            self._ops[query] = op
            op.search_token = on_listen(query, op.on_value)
        token = self._next_token
        self._next_token += 1
        if self._next_token == 0:
            self._next_token = 1
        op.add_listener(token, get_cb, query, f, now)
        return token

    def cancel_listen(self, token: int, now: float) -> bool:
        for op in self._ops.values():
            if op.remove_listener(token, now):
                self._next_expiration = min(self._next_expiration,
                                            op.get_expiration())
                return True
        return False

    def cancel_all(self, on_cancel: Callable[[int], None]) -> None:
        for op in self._ops.values():
            op.remove_all()
            on_cancel(op.search_token)
        self._ops.clear()

    def expire(self, now: float, on_cancel: Callable[[int], None]) -> float:
        """Drop ops whose linger has elapsed; returns next expiration
        (op_cache.cpp:161-178).

        Boundary is INCLUSIVE (``exp <= now``), unlike the reference's
        strict ``<``: the expire job re-arms itself at the returned
        time, and a surviving op with ``exp == now`` would re-arm the
        job at the CURRENT instant — a live-lock under a virtual clock
        that only advances between events (observed: a search's
        expire_ops job spinning at one timestamp until the test
        harness's event budget drained).  Real monotonic clocks advance
        between scheduler runs, which is the only reason the strict
        form terminates in the reference."""
        self._next_expiration = TIME_MAX
        for q in list(self._ops):
            op = self._ops[q]
            exp = op.get_expiration()
            if exp <= now:
                del self._ops[q]
                on_cancel(op.search_token)
            else:
                self._next_expiration = min(self._next_expiration, exp)
        return self._next_expiration

    def get_expiration(self) -> float:
        return self._next_expiration

    def get(self, f: Optional[Filter] = None) -> List[Value]:
        if len(self._ops) == 1:
            return next(iter(self._ops.values())).get(f)
        seen: Dict[int, Value] = {}
        for op in self._ops.values():
            for v in op.get(f):
                seen.setdefault(v.id, v)
        return list(seen.values())

    def get_by_id(self, vid: int) -> Optional[Value]:
        for op in self._ops.values():
            v = op.cache.get_by_id(vid)
            if v is not None:
                return v
        return None

    def __len__(self) -> int:
        return len(self._ops)
