"""Time-ordered job scheduler — the single-threaded runtime driver.

A copy of the JAX package's ``scheduler.py`` with its behaviour unchanged.

Counterpart of the reference ``Scheduler`` (include/opendht/scheduler.h:37-122):
every periodic behavior in the network engine and DHT core is a job keyed
by a time point; ``run()`` executes everything due and reports the next
wakeup so the owning loop can sleep exactly that long.

Python-idiomatic design: a heapq of (time, seq, Job) entries with lazy
deletion — ``cancel``/``edit`` just drop the callable, and stale heap
entries are skipped when popped (the reference reschedules by re-emplacing
into a multimap, same effect).  Lazy deletion alone lets a cancel-heavy
workload (listen churn, request retries racing replies) grow the heap
without bound, so the scheduler counts its stale entries (exposed as the
``dht_scheduler_stale_entries`` gauge) and compacts the heap in place
once more than half of a non-trivial heap is dead.

Telemetry (one gauge store / histogram observe per ``run()``, handles
cached at construction): ``dht_scheduler_queue_depth`` /
``dht_scheduler_stale_entries`` gauges, ``dht_scheduler_tick_lag_seconds``
(how late the due job at the head fired — the tick-lag surface)
and ``dht_scheduler_heap_compactions_total``.  Multiple schedulers in
one process share the series (last writer wins on the gauges).
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Callable, Optional

from . import telemetry
from .utils import TIME_MAX

#: compaction policy: rebuild when the heap is beyond this size AND more
#: than half of it is cancelled entries
_COMPACT_MIN = 64


class Job:
    """A scheduled callable. ``cancel()`` clears it (scheduler.h:41-44).
    ``time`` tracks the pending fire time (None once popped/parked) so
    callers can compare against an intended reschedule."""

    __slots__ = ("func", "time", "_sched")

    def __init__(self, func: Optional[Callable[[], None]]):
        self.func = func
        self.time: Optional[float] = None
        self._sched: "Scheduler | None" = None

    def cancel(self) -> None:
        if self.func is not None:
            self.func = None
            # tell the owning scheduler its heap entry went stale so the
            # lazy-deletion debt is observable (and compactable)
            if self._sched is not None and self.time is not None:
                self._sched._note_stale()

    @property
    def cancelled(self) -> bool:
        return self.func is None


class Scheduler:
    def __init__(self, clock: Callable[[], float] = _time.monotonic):
        self._clock = clock
        self._now = clock()
        self._heap: list[tuple[float, int, Job]] = []
        self._seq = itertools.count()
        self._stale = 0                 # cancelled entries still heaped
        reg = telemetry.get_registry()
        self._m_depth = reg.gauge("dht_scheduler_queue_depth")
        self._m_stale = reg.gauge("dht_scheduler_stale_entries")
        self._m_lag = reg.histogram("dht_scheduler_tick_lag_seconds")
        self._m_compactions = reg.counter(
            "dht_scheduler_heap_compactions_total")

    # -- stale accounting --------------------------------------------------
    def _note_stale(self) -> None:
        self._stale += 1

    def _note_popped(self, job: Job) -> None:
        """A heap entry left the heap; if its job was cancelled it was
        part of the stale debt.  Clamped: a job double-queued via
        ``queue()`` owns several entries but counts one stale — the
        periodic compaction re-zeroes the count exactly."""
        if job.cancelled and self._stale > 0:
            self._stale -= 1

    @property
    def stale_entries(self) -> int:
        """Cancelled jobs still occupying heap slots (lazy deletion)."""
        return self._stale

    def _maybe_compact(self) -> None:
        """Drop cancelled entries in place when they dominate the heap —
        bounds heap growth under cancel-heavy workloads (the regression
        tests pin this)."""
        heap = self._heap
        if len(heap) > _COMPACT_MIN and 2 * self._stale > len(heap):
            dropped = len(heap) - sum(1 for e in heap
                                      if not e[2].cancelled)
            self._heap = [e for e in heap if not e[2].cancelled]
            heapq.heapify(self._heap)
            self._stale = 0
            self._m_compactions.inc()
            # flight recorder: compactions are a first-class
            # postmortem signal alongside the counter
            from . import tracing
            tr = tracing.get_tracer()
            if tr.enabled:
                tr.event("scheduler_compaction", dropped=dropped,
                         kept=len(self._heap))

    # -- queue ops ---------------------------------------------------------
    def add(self, t: float, func: Callable[[], None]) -> Job:
        """Schedule ``func`` at time ``t``; returns the Job handle
        (scheduler.h:53-58). t == TIME_MAX means 'parked': the job exists
        but is not queued."""
        job = Job(func)
        job._sched = self
        if t != TIME_MAX:
            job.time = t
            heapq.heappush(self._heap, (t, next(self._seq), job))
        return job

    def queue(self, job: Job, t: float) -> None:
        """Re-enqueue an existing job at ``t`` (scheduler.h:60-63)."""
        if t != TIME_MAX:
            job._sched = self
            job.time = t
            heapq.heappush(self._heap, (t, next(self._seq), job))

    def edit(self, job: Optional[Job], t: float) -> Optional[Job]:
        """Reschedule: cancel the old entry, return a fresh Job at ``t``
        (scheduler.h:70-80 — the reference also invalidates the old
        shared_ptr's callable and re-adds)."""
        if job is None:
            return None
        func = job.func
        if func is not None and job.time is not None:
            self._note_stale()      # the old heap entry is now dead weight
        job.func = None
        job.time = None
        return self.add(t, func) if func is not None else None

    # -- execution ---------------------------------------------------------
    def run(self) -> float:
        """Run all jobs due as of now; return next wakeup time
        (scheduler.h:87-106).  Jobs scheduled for a time strictly after the
        synced 'now' are left for the next run, so a job that reschedules
        itself for 'now + d' cannot starve the loop."""
        self.sync_time()
        heap = self._heap
        # drop cancelled heads first so the lag observation below never
        # reports lateness for a job that was never going to fire
        while heap and heap[0][2].cancelled:
            self._note_popped(heap[0][2])
            heapq.heappop(heap)
        if heap and heap[0][0] <= self._now:
            # tick lag: how late the head job fires relative to its
            # requested time point (scheduler health under load)
            self._m_lag.observe(self._now - heap[0][0])
        # Snapshot the due entries first: a job that re-adds itself for
        # "now" during this sweep waits for the next run() instead of
        # spinning the loop (the reference relies on real time advancing
        # for the same guarantee, scheduler.h:90-95).
        due = []
        while heap and heap[0][0] <= self._now:
            t, _, job = heapq.heappop(heap)
            self._note_popped(job)
            job.time = None
            due.append((t, job))
        try:
            while due:
                _, job = due.pop(0)
                func = job.func
                if func is not None:
                    func()
        finally:
            # If a job raised, the not-yet-run due jobs go back on the
            # heap instead of being silently lost with the local list.
            for t, job in due:
                heapq.heappush(heap, (t, next(self._seq), job))
                if job.cancelled:
                    self._stale += 1
        self._maybe_compact()
        self._m_depth.set(len(self._heap))
        self._m_stale.set(self._stale)
        return self.next_job_time()

    def next_job_time(self) -> float:
        heap = self._heap
        while heap and heap[0][2].cancelled:
            self._note_popped(heap[0][2])
            heapq.heappop(heap)
        return heap[0][0] if heap else TIME_MAX

    # -- time reference ----------------------------------------------------
    def time(self) -> float:
        """The common synchronized time reference (scheduler.h:116)."""
        return self._now

    def sync_time(self) -> float:
        self._now = self._clock()
        return self._now

    def __len__(self) -> int:
        return sum(1 for *_, j in self._heap if not j.cancelled)
