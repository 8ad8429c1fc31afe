"""What a driver records while it runs: every call it timed, and the
benchmark's own spans around the calls into each layer of the program."""

from __future__ import annotations

import collections
import contextlib
import time

from torch.profiler import record_function


class Window:
    """The calls of one stretch of a run.  ``capture``: whether the
    driver keeps answers of this stretch for the check."""

    def __init__(self, capture: bool = False):
        self.capture = capture
        self.start = time.perf_counter()
        self.end = self.start
        #: (seconds from handoff to result on the host, lookups, lookups ok)
        self.calls: list = []
        self.spans: dict = collections.defaultdict(list)
        #: the program's counters and histograms over the stretch
        self.program: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block into ``spans[name]`` and label it
        ``dhtbench.<name>`` for the profiler."""
        with record_function("dhtbench." + name):
            t = time.perf_counter()
            yield
            self.spans[name].append(time.perf_counter() - t)

    def call(self, handoff: float, lookups: int, ok: int) -> None:
        """A call whose result reached the host now, handed to the
        program at ``handoff`` (``time.perf_counter``)."""
        self.end = time.perf_counter()
        self.calls.append((self.end - handoff, lookups, ok))

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def attempted(self) -> int:
        return sum(c[1] for c in self.calls)

    @property
    def ok(self) -> int:
        return sum(c[2] for c in self.calls)
