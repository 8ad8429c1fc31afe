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
