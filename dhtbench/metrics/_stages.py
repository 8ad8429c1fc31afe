"""The search engine's stage clock as the program's telemetry gives it
over the measured window (``core/search.py`` ``record_wave``): host
seconds by stage, loop iterations, waves."""

ROUNDS = 'dht_search_rounds_total{mode="single"}'
WAVES = 'dht_search_wave_seconds{mode="single"}:count'


def ms_per(p: dict, stages: tuple, count: str):
    """Milliseconds the window spent in ``stages`` over the reading
    ``count``; None where the program timed none of them (no stage
    clock) or counted nothing."""
    got = [p.get(f'dht_search_stage_seconds{{mode="single",stage="{s}"}}'
                 ":sum") for s in stages]
    got = [g for g in got if g is not None]
    n = p.get(count)
    return 1e3 * sum(got) / n if got and n else None
