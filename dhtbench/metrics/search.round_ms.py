"""search.round_ms: the program's own round time over the window: its
``dht_search_round_seconds`` histogram, which ``core/search.py``
``record_wave`` feeds each wave's wall time over its deepest hop count,
averaged over the window's waves.  Read from the measured window, not the
traced calls, so that the profiler's cost per launch stays out of it."""

SERIES = 'dht_search_round_seconds{mode="single"}'


def read(run):
    p = run.window.program
    n = p.get(SERIES + ":count")
    return 1e3 * p[SERIES + ":sum"] / n if n else None
