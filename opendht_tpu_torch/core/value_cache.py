"""Per-(node, query) listen-side value cache (reference src/value_cache.h).

A copy of the JAX package's ``core/value_cache.py`` with its behaviour unchanged.

Tracks values a remote peer has pushed over a listen subscription, with
created/expiration bookkeeping per value type; emits add/expire events
through one callback ``cb(values, expired)``.  Handles the peer's
refreshed/expired id lists from value-update packets, caps at 4096
values (oldest evicted), and reports the next expiration time so the
owner can schedule an expiry job.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..utils import TIME_MAX
from .value import TypeStore, Value

MAX_VALUES = 4096               # value_cache.h:131

#: cb(values, expired)
ValueStateCallback = Callable[[List[Value], bool], None]


@dataclass
class _CacheSlot:
    data: Value
    created: float
    expiration: float


class ValueCache:
    def __init__(self, callback: Optional[ValueStateCallback]):
        self._values: Dict[int, _CacheSlot] = {}
        self._callback = callback

    # -- event entry point (value_cache.h:102-122) -------------------------
    def on_values(self, values: Sequence[Value], refreshed: Sequence[int],
                  expired: Sequence[int], types: TypeStore, now: float) -> float:
        """Apply one update from the peer: new/refreshed full values,
        refreshed ids, expired ids; then sweep expirations.  Returns the
        next expiration time (TIME_MAX if cache empty)."""
        pending: List[tuple[List[Value], bool]] = []
        if values:
            added = self._add_values(values, types, now)
            if added:
                pending.append((added, False))
        for vid in refreshed:
            self._refresh_value(vid, types, now)
        for vid in expired:
            gone = self._expire_value(vid)
            if gone:
                pending.append((gone, True))
        nxt, swept = self._sweep(now)
        if swept:
            pending.append((swept, True))
        cb = self._callback
        if cb:
            for vals, exp in pending:
                cb(vals, exp)
        return nxt

    def expire_values(self, now: float) -> float:
        """Standalone expiry sweep (value_cache.h:56-63)."""
        return self.on_values((), (), (), TypeStore(), now)

    def clear(self) -> None:
        """Flush everything, signalling expiration (value_cache.h:40-54)."""
        vals = [s.data for s in self._values.values()]
        self._values.clear()
        if vals and self._callback:
            self._callback(vals, True)

    def get_values(self) -> List[Value]:
        return [s.data for s in self._values.values()]

    def __len__(self) -> int:
        return len(self._values)

    # -- internals ---------------------------------------------------------
    def _add_values(self, new_values: Sequence[Value], types: TypeStore,
                    now: float) -> List[Value]:
        """(value_cache.h:144-165)"""
        fresh = []
        for v in new_values:
            slot = self._values.get(v.id)
            if slot is None:
                self._values[v.id] = _CacheSlot(
                    v, now, now + types.get_type(v.type).expiration)
                fresh.append(v)
            else:
                slot.created = now
                slot.expiration = now + types.get_type(slot.data.type).expiration
        return fresh

    def _refresh_value(self, vid: int, types: TypeStore, now: float) -> None:
        slot = self._values.get(vid)
        if slot is not None:
            slot.created = now
            slot.expiration = now + types.get_type(slot.data.type).expiration

    def _expire_value(self, vid: int) -> List[Value]:
        slot = self._values.pop(vid, None)
        return [slot.data] if slot is not None else []

    def _sweep(self, now: float) -> tuple[float, List[Value]]:
        """Expire due values; enforce the size cap by dropping oldest
        (value_cache.h:66-99).  Returns (next expiration, dropped)."""
        nxt = TIME_MAX
        dropped: List[Value] = []
        for vid in list(self._values):
            slot = self._values[vid]
            if slot.expiration <= now:
                dropped.append(slot.data)
                del self._values[vid]
            else:
                nxt = min(nxt, slot.expiration)
        while len(self._values) > MAX_VALUES:
            oldest_vid = min(self._values, key=lambda k: self._values[k].created)
            dropped.append(self._values.pop(oldest_vid).data)
        return nxt, dropped
