"""Listener records (reference src/listener.h).

A copy of the JAX package's ``core/listener.py`` with its behaviour unchanged.

- :class:`Listener` — a foreign node subscribed to updates of a key
  (held in Storage.listeners, refreshed by repeated listen RPCs).
- :class:`LocalListener` — one local ``listen`` op: query + filter + cb.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .value import Filter, Query, Value

#: cb(values, expired) -> bool; returning False unsubscribes
ValueCallback = Callable[[List[Value], bool], bool]


class Listener:
    """Remote listener state {time, query} (listener.h:31-42)."""

    __slots__ = ("time", "query", "sid")

    def __init__(self, t: float, query: Query, sid: int = 0):
        self.time = t
        self.query = query
        self.sid = sid      # the peer's push socket id for value updates

    def refresh(self, t: float, query: Query) -> None:
        self.time = t
        self.query = query


@dataclass
class LocalListener:
    """One local listen op (listener.h:45-51)."""
    query: Optional[Query]
    filter: Optional[Filter]
    get_cb: ValueCallback

    def notify(self, values: List[Value], expired: bool) -> bool:
        """Deliver the filtered batch; False means 'unsubscribe me'.
        Only an explicit ``False`` return unsubscribes — a callback that
        returns None (the usual Python default) stays subscribed."""
        from .value import Filters
        vals = Filters.apply(self.filter, values)
        if not vals:
            return True
        return self.get_cb(vals, expired) is not False
