"""search.sync_wait_ms: host ms per loop iteration of the search engine
blocked on the loop condition's device→host read: the program's
``dht_search_stage_seconds{stage="sync"}`` in the measured window over
its ``dht_search_rounds_total``."""

from dhtbench.metrics._stages import ROUNDS, ms_per


def read(run):
    return ms_per(run.window.program, ("sync",), ROUNDS)
