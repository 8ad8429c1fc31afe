"""search.wave_fixed_ms: host ms per wave of the search engine outside
its loop: the program's ``dht_search_stage_seconds`` over the stages
``upload``, ``prepare``, ``bootstrap``, ``finish`` and ``record`` in
the measured window, over its waves (the count of
``dht_search_wave_seconds``)."""

from dhtbench.metrics._stages import WAVES, ms_per


def read(run):
    return ms_per(run.window.program,
                  ("upload", "prepare", "bootstrap", "finish", "record"),
                  WAVES)
