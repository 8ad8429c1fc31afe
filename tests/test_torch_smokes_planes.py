"""The planes' smokes (``keyspace``, ``cache``, ``listener``,
``reshard``) on both packages, on the CPU, in the manner of
tests/test_torch_smokes_observatory.py: each in a fresh process, both
exit 0, the OK lines equal with hex ids and measured quantities masked,
the dhtmon codes exact; and their pure helpers at tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_smokes_observatory import smoke_twin

PLANES = ("keyspace_smoke", "cache_smoke", "listener_smoke",
          "reshard_smoke")


@pytest.mark.parametrize("name", PLANES)
def test_smoke_twin(name, tmp_path):
    smoke_twin(name, tmp_path)


def _modules(name: str) -> tuple:
    import importlib
    return (importlib.import_module("opendht_tpu.testing." + name),
            importlib.import_module("opendht_tpu_torch.testing." + name))


def test_constants_equal_the_jax_copies():
    for name, attrs in (("keyspace_smoke", ("N_NODES", "N_COLD",
                                            "OP_TIMEOUT", "GATE_MARGIN")),
                        ("cache_smoke", ("N_NODES", "OP_TIMEOUT")),
                        ("listener_smoke", ("N_NODES", "N_KEYS", "PER_KEY",
                                            "N_SUBSCRIBE", "OP_TIMEOUT",
                                            "LAG_GATE", "STALL_S")),
                        ("reshard_smoke", ("N_NODES", "N_COLD", "OP_TIMEOUT",
                                           "GATE"))):
        jmod, pmod = _modules(name)
        for a in attrs:
            assert getattr(pmod, a) == getattr(jmod, a), (name, a)


@pytest.mark.parametrize("name", ["cache_smoke", "reshard_smoke"])
def test_value_sets_equal(name):
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu_torch.core.value import Value
    jmod, pmod = _modules(name)
    rng = np.random.default_rng(47)
    ids = rng.integers(1, 2**32, 12)
    datas = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 40, 12)]
    jv = [JValue(d, value_id=int(i)) for i, d in zip(ids, datas)]
    pv = [Value(d, value_id=int(i)) for i, d in zip(ids, datas)]
    assert pmod._vals(pv) == jmod._vals(jv)
    assert pmod._vals(pv + pv[:3]) == jmod._vals(jv + jv[:3])
    assert pmod._vals([]) == jmod._vals([]) == set()


def test_listener_series_equal():
    jmod, pmod = _modules("listener_smoke")
    rng = np.random.default_rng(53)
    lines = ["# HELP dht_listener_occupancy listeners",
             "# TYPE dht_listener_occupancy gauge"]
    for i, v in enumerate(rng.random(6) * 100):
        lines.append('dht_listener_occupancy{node="%d"} %r' % (i, float(v)))
    lines += ['dht_listener_lag_p95{node="0"} -1',
              'dht_listener_lag_p95{node="1"} NaN',
              "dht_listener_flushes_total 17",
              "dht_listener_matches_total not-a-number",
              "dht_listener_bare"]
    text = "\n".join(lines)
    for prefix in ("dht_listener_occupancy", "dht_listener_lag_p95",
                   "dht_listener_", "dht_listener_matches_total", "none"):
        got, want = pmod._series(text, prefix), jmod._series(text, prefix)
        assert repr(sorted(got.items())) == repr(sorted(want.items()))


def test_waits_equal():
    for name in PLANES:
        jmod, pmod = _modules(name)
        for pred in (lambda: True, lambda: 0, lambda: [1]):
            assert pmod._wait(pred, timeout=0.05, step=0.01) \
                == jmod._wait(pred, timeout=0.05, step=0.01)
