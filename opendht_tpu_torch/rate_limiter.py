"""Sliding-window rate limiter (reference include/opendht/rate_limiter.h:26-48).

A copy of the JAX package's ``rate_limiter.py`` with its behaviour unchanged.

Used by the network engine for the global (1600/s) and per-IP (200/s)
ingress quotas.  A deque of admission timestamps; ``limit(now)`` admits
iff fewer than ``quota`` records fall inside the trailing ``period``.
"""

from __future__ import annotations

from collections import deque


class RateLimiter:
    __slots__ = ("quota", "period", "_records")

    def __init__(self, quota: int, period: float = 1.0):
        self.quota = quota
        self.period = period
        self._records: deque[float] = deque()

    def maintain(self, now: float) -> int:
        """Drop outdated records; return current usage (rate_limiter.h:28-34)."""
        limit = now - self.period
        rec = self._records
        while rec and rec[0] < limit:
            rec.popleft()
        return len(rec)

    def limit(self, now: float) -> bool:
        """False if the quota is spent, else record the hit and admit
        (rate_limiter.h:36-42)."""
        if self.maintain(now) >= self.quota:
            return False
        self._records.append(now)
        return True

    def empty(self) -> bool:
        return not self._records
