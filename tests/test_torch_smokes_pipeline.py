"""The pipeline's and chaos' smokes (``ingest``, ``pipeline``,
``pipeline_util``, ``chaos``) on both packages, on the CPU, in the
manner of tests/test_torch_smokes_observatory.py: each in a fresh
process, both exit 0 (the JAX ``chaos_smoke``'s racing chaos-off pin
pinned, ROADMAP C.3), the OK lines equal with hex ids and measured
quantities masked, the dhtmon codes exact; and their pure helpers and
the chaos tiers' plans at tolerance 0.
"""

from __future__ import annotations

import pytest

from test_torch_smokes_observatory import smoke_twin

PIPELINE = ("ingest_smoke", "pipeline_smoke", "pipeline_util_smoke",
            "chaos_smoke")


@pytest.mark.parametrize("name", PIPELINE)
def test_smoke_twin(name, tmp_path):
    smoke_twin(name, tmp_path)


def _modules(name: str) -> tuple:
    import importlib
    return (importlib.import_module("opendht_tpu.testing." + name),
            importlib.import_module("opendht_tpu_torch.testing." + name))


def test_constants_equal_the_jax_copies():
    for name, attrs in (("ingest_smoke", ("N_NODES", "N_KEYS",
                                          "OP_TIMEOUT")),
                        ("pipeline_smoke", ("N_NODES", "N_KEYS",
                                            "OP_TIMEOUT")),
                        ("pipeline_util_smoke", ("N_NODES", "N_COLD",
                                                 "ZIPF_ROUNDS",
                                                 "OP_TIMEOUT",
                                                 "BUBBLE_CAUSES")),
                        ("chaos_smoke", ("N_NODES", "TICK", "OP_TIMEOUT"))):
        jmod, pmod = _modules(name)
        for a in attrs:
            assert getattr(pmod, a) == getattr(jmod, a), (name, a)


class _Handle:
    """A launch handle that turns ready on the third poll."""

    shard_t = 1

    def __init__(self):
        self.polls = 0

    def ready(self):
        self.polls += 1
        return self.polls >= 3

    def consume(self):
        return ("rows", self.polls)


def test_slow_ready_holds_a_launch_alike():
    """``_SlowReady`` reports not ready while no newer launch exists (up
    to 50 ms), then defers to the real handle; ``consume`` is the real
    handle's."""
    jmod, pmod = _modules("pipeline_smoke")
    for newer in (False, True):
        trace = []
        for mod in (jmod, pmod):
            state = {"launches": 1}
            h = mod._SlowReady(_Handle(), state, 0)
            if newer:
                state["launches"] = 2
            polls = [h.ready() for _ in range(4)]
            trace.append((polls, h.shard_t, h.consume()))
        assert trace[1] == trace[0], trace


def test_waits_equal():
    for name in PIPELINE:
        jmod, pmod = _modules(name)
        if not hasattr(jmod, "_wait"):
            continue
        for pred in (lambda: True, lambda: 0, lambda: [1]):
            assert pmod._wait(pred, timeout=0.05, step=0.01) \
                == jmod._wait(pred, timeout=0.05, step=0.01)


@pytest.mark.parametrize("order", ["jax", "port"])
def test_chaos_smoke_baseline_clears_a_latched_stage_budget(order):
    """``chaos_smoke``'s healthy baseline after a slow window (the port's
    run failed it in a loaded run of the whole suite: verdict
    ``degraded``, causes ``['stage_budget']``, the signal's value None;
    ROADMAP C.3).
    A window whose stage p95 passes its budget latches the degrade-only
    ``stage_budget`` level, and a quiet node then makes no window of
    enough samples to clear it: the JAX copy's read four ticks later
    still finds it degraded; the port's ``healthy_baseline`` gets until
    fresh samples clear it.  The stage budgets are raised to 10 s for
    both nodes, so that the samples of this host's load, whatever it is,
    fall under them and only the injected 100 s samples trip them."""
    import time
    from opendht_tpu_torch import waterfall
    from opendht_tpu_torch.runtime import Config, DhtRunner, RunnerConfig
    _, C = _modules("chaos_smoke")
    tick = C.TICK
    budgets = {s: 10.0 for s in waterfall.STAGES}
    cfg = Config()
    cfg.health.period = tick
    cfg.history.period = tick
    cfg.waterfall.budgets = budgets
    quiet = Config()
    quiet.health.period = 0          # one evaluator reads the windows
    quiet.waterfall.budgets = budgets
    r, peer = DhtRunner(), DhtRunner()
    r.run(0, RunnerConfig(dht_config=cfg), device="cpu")
    peer.run(0, RunnerConfig(dht_config=quiet), device="cpu")
    try:
        peer.bootstrap("127.0.0.1", r.get_bound_port())
        assert C._wait(lambda: r.get_status().name
                       == peer.get_status().name == "CONNECTED")
        assert C._wait(lambda: r.get_health()["verdict"] == "healthy"), \
            r.get_health()
        prof = waterfall.get_profiler()
        assert prof.budgets == budgets
        for _ in range(8):
            prof.observe("queue_wait", 100.0)
        assert C._wait(lambda: r.get_health()["signals"]["stage_budget"]
                       ["level"] == "degraded"), r.get_health()
        if order == "jax":
            time.sleep(4 * tick)
            health = r.get_health()
            assert health["verdict"] == "degraded", health
            assert health["causes"] == ["stage_budget"]
            assert health["signals"]["stage_budget"]["unknown"]
        else:
            health = C.healthy_baseline(r)
            assert health["verdict"] == "healthy", health
    finally:
        r.join()
        peer.join()
        waterfall.get_profiler().configure(waterfall.WaterfallConfig())
