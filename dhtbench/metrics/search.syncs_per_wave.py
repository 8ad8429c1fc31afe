"""search.syncs_per_wave: the search engine's host syncs per wave: the
program's ``dht_search_host_syncs_total`` in the measured window (the
positioning tier's read, each loop condition's read, a compaction's
``nonzero``, on the card the inputs' upload and the closing
synchronize, the hops' copy back) over its waves.  None where the
program keeps no such counter."""

from dhtbench.metrics._stages import WAVES

SYNCS = 'dht_search_host_syncs_total{mode="single"}'


def read(run):
    p = run.window.program
    s, n = p.get(SYNCS), p.get(WAVES)
    return s / n if s is not None and n else None
