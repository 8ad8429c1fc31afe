"""search.launch_ms: host ms per loop iteration of the search engine
spent issuing it: the program's ``dht_search_stage_seconds`` over the
stages ``select``, ``reply``, ``gather``, ``merge`` and ``done`` in the
measured window, over its ``dht_search_rounds_total`` (stalled
iterations included)."""

from dhtbench.metrics._stages import ROUNDS, ms_per


def read(run):
    return ms_per(run.window.program,
                  ("select", "reply", "gather", "merge", "done"), ROUNDS)
