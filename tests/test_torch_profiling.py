"""The port's kernel cost ledger (``opendht_tpu_torch.profiling``) against
the JAX package's (``opendht_tpu.profiling``), twinning
tests/test_profiling.py.

- Every spec builds and runs on the CPU; its shape dict equals the JAX
  builder's, key for key; the port's twin function, handed the JAX
  builder's own inputs (as numpy), returns the JAX program's outputs bit
  for bit (tolerance 0; the maintenance sweeps' refresh targets come
  from ``jax.random`` on one side and a ``torch.Generator`` on the
  other, so they are held to their buckets instead).
- The counted fields are deterministic; the analytic byte bound is the
  inputs read once plus the outputs written once; the export surfaces
  (``dht_kernel_*`` gauges with the JAX names, ``maybe_export``'s
  gating, the wave-span attributes) behave as the JAX ledger's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opendht_tpu import profiling as JP
from opendht_tpu.testing.telemetry_smoke import parse_exposition
from opendht_tpu_torch import profiling, telemetry, tracing
from opendht_tpu_torch.ops import ids as TK
from opendht_tpu_torch.ops import swarm

SUBSET = ["expanded_topk", "fused_gather_planar", "maintenance_sweep",
          "simulate_lookups"]


@pytest.fixture(scope="module")
def ledger():
    led = profiling.get_ledger()
    led.clear()
    led.enabled = True
    led.compute(device="cpu")
    yield led
    led.enabled = True
    led.clear()


_JAX_BUILT: dict = {}


def _jax_spec(name):
    """(fn, args, kwargs, shape, outputs) of the JAX builder, once."""
    if name not in _JAX_BUILT:
        fn, args, kwargs, shape = JP.KERNEL_SPECS[name][0]()
        out = jax.block_until_ready(fn(*args, **kwargs))
        _JAX_BUILT[name] = (fn, args, kwargs, shape, out)
    return _JAX_BUILT[name]


def _keys(x):
    return TK.to_keys(np.asarray(x, np.uint32), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _table_args(args):
    s, e, nv, q, lut = args
    return (_keys(s), _keys(e), _t(nv), _keys(q), _t(lut))


def _sweep_args(args, seed):
    self_id, ids, valid, last, now, age, _key = args
    return (_keys(self_id), _keys(ids), _t(valid), _t(last), float(now),
            float(age), seed)


def _swarm_args(args):
    state = {k: np.asarray(v) for k, v in args[0].items()}
    rest = [np.asarray(a) if isinstance(a, jax.Array) else a
            for a in args[1:]]
    return (swarm.state_to_device(state, "cpu"), *rest)


#: name -> the JAX builder's args → the port twin's args
_CONVERT = {
    "find_closest_nodes_batched": _table_args,
    "wave_builder_lookup": _table_args,
    "expanded_topk": lambda a: (_keys(a[0]), _keys(a[1]), _t(a[2]),
                                _keys(a[3])),
    "sketch_update": lambda a: (_t(a[0]), _t(a[1]), _keys(a[2])),
    "cache_probe": lambda a: (_keys(a[0]), _t(a[1]), _keys(a[2])),
    "listener_match": lambda a: (_keys(a[0]), _t(a[1]), _keys(a[2])),
    "swarm_step": _swarm_args,
    # the JAX gather reads the transposed [5, N] table
    "fused_gather_planar": lambda a: (_keys(np.asarray(a[0]).T), _t(a[1])),
    "packed_churn_merge": lambda a: (tuple(_keys(p) for p in a[0]),
                                     _t(a[1]),
                                     tuple(_keys(p) for p in a[2]),
                                     _t(a[3])),
    # tombstone words are raw bits, not keys
    "churn_lookup_topk": lambda a: (
        _keys(a[0]), _keys(a[1]), _t(a[2]),
        _t(np.asarray(a[3]).view(np.int32)), _keys(a[4]), _keys(a[5]),
        _t(a[6]), _keys(a[7]), _t(a[8]), _t(a[9])),
    "maintenance_sweep": lambda a: _sweep_args(a, 18),
    "simulate_lookups": lambda a: (_keys(a[0]), _t(a[1]), _keys(a[2])),
    "tp_simulate_lookups": lambda a: (_keys(a[0]), _t(a[1]), _t(a[2]),
                                      int(np.asarray(a[3]).reshape(-1)[0]),
                                      _keys(a[4]), int(a[5])),
    "sharded_window_lookup": lambda a: (_keys(a[0]), _keys(a[1]), _t(a[2]),
                                        _t(a[3])),
    "reshard_state_build": lambda a: (_keys(a[0]), np.asarray(a[1])),
    "sharded_maintenance_sweep": lambda a: _sweep_args(a, 23),
}


def _port_args(name, args, kwargs):
    """(args, kwargs) of the port twin; a lut keyword rides along."""
    kw = {"lut": _t(kwargs["lut"])} if "lut" in kwargs else {}
    return _CONVERT[name](args), kw


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [x]


def _same(jax_leaf, port_leaf, what):
    j = np.asarray(jax_leaf)
    if isinstance(port_leaf, torch.Tensor):
        p = (TK.from_keys(port_leaf) if j.dtype == np.uint32
             else port_leaf.numpy())
    else:
        p = np.asarray(port_leaf)
    assert p.shape == j.shape, (what, p.shape, j.shape)
    np.testing.assert_array_equal(p, j, err_msg=what)


# ------------------------------------------------------------ the specs
def test_every_spec_runs_on_the_cpu(ledger):
    out = ledger.compute(device="cpu")
    assert set(out) == set(JP.KERNEL_SPECS) == set(profiling.KERNEL_SPECS)
    assert all("error" not in e for e in out.values()), out
    for e in out.values():
        assert e["platform"] == "cpu" and e["launches"] > 0
        assert "device_ms" not in e and "device_kernels" not in e


@pytest.mark.parametrize("name", sorted(JP.KERNEL_SPECS))
def test_shape_dict_equals_the_jax_builders(name, ledger):
    _fn, _args, _kw, jshape, _out = _jax_spec(name)
    assert ledger.compute([name], device="cpu")[name]["shape"] == jshape


@pytest.mark.parametrize("name", sorted(JP.KERNEL_SPECS))
def test_twin_returns_the_jax_outputs_on_the_jax_inputs(name):
    _fn, args, kwargs, _shape, jout = _jax_spec(name)
    fn, _pargs, _pkw, _pshape = profiling.KERNEL_SPECS[name][0](
        torch.device("cpu"))
    pargs, pkw = _port_args(name, args, kwargs)
    pout = fn(*pargs, **pkw)
    if name == "swarm_step":
        jstate, jmetrics = jout
        pstate = swarm.state_to_numpy(pout[0])
        for k in swarm.STATE_KEYS:
            np.testing.assert_array_equal(pstate[k], np.asarray(jstate[k]),
                                          err_msg=k)
        assert swarm.read_metrics(pout[1]) == {
            k: int(v) for k, v in jmetrics.items()}
        return
    if name in ("maintenance_sweep", "sharded_maintenance_sweep"):
        for what, a, b in zip(("counts", "last", "stale"), jout[:3],
                              pout[:3]):
            _same(a, b, what)
        me = _keys(args[0]).reshape(1, 5)
        cb = TK.common_bits(me, pout[3])
        assert torch.equal(cb, torch.arange(160, dtype=torch.int32))
        return
    if isinstance(jout, dict):
        keys = ("nodes", "dist", "hops", "converged")
        jout = {k: jout[k] for k in keys}
        pout = {k: pout[k] for k in keys}
    jl, pl = _leaves(jout), _leaves(pout)
    assert len(jl) == len(pl), (len(jl), len(pl))
    for i, (a, b) in enumerate(zip(jl, pl)):
        _same(a, b, f"{name} output {i}")


# ------------------------------------------------------- counted fields
def test_cost_fields_deterministic(ledger):
    fields = ("shape", "argument_bytes", "output_bytes", "launches",
              "launches_by_op", "views", "bytes_bound", "flops_model")
    a = ledger.compute(SUBSET, device="cpu")
    b = ledger.compute(SUBSET, force=True, device="cpu")
    for name in SUBSET:
        for f in fields:
            assert a[name][f] == b[name][f], (name, f)


def test_bytes_bound_is_inputs_read_once_plus_outputs(ledger):
    """Each spec's analytic byte count (written beside its builder, from
    the shape) equals its arguments' and outputs' measured bytes."""
    for name, e in ledger.compute(device="cpu").items():
        assert e["bytes_bound"] == e["argument_bytes"] + e["output_bytes"], \
            name
        assert e["flops_model"] > 0, name


def test_launch_split_sums_to_launches(ledger):
    for name, e in ledger.compute(device="cpu").items():
        split = e["launches_by_op"]
        assert sum(split.values()) == e["launches"], name
        assert all(k.startswith("aten::") for k in split), name
        assert e["views"] >= 0
    # the C.2.1 count: a canonical lookup dispatches hundreds of ops
    assert ledger.compute(["find_closest_nodes_batched"], device="cpu")[
        "find_closest_nodes_batched"]["launches"] > 100


def test_engine_flops_follow_the_rounds_it_ran(ledger):
    e = ledger.compute(["simulate_lookups"], device="cpu")["simulate_lookups"]
    fn, args, kw, shape = profiling.KERNEL_SPECS["simulate_lookups"][0](
        torch.device("cpu"))
    out = fn(*args, **kw)
    rounds = int(out["hops"].max())
    assert rounds > 0
    _b, ops = profiling._cost_engine(shape, out)
    assert ops == e["flops_model"]
    _b, ops0 = profiling._cost_engine(shape, {"hops": out["hops"] * 0})
    assert ops0 < ops


def test_measure_refuses_the_cpu(ledger):
    with pytest.raises(RuntimeError, match="card"):
        ledger.measure(["cache_probe"], device="cpu")


def test_measure_raises_where_a_spec_cannot_be_timed(monkeypatch, ledger):
    """A card failure while timing (CUDA events, the peak read, the
    roofline) raises out of measure(); it is never stored as a field
    that a caller could pass over."""
    from opendht_tpu_torch import _device
    monkeypatch.setattr(_device, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(profiling, "platform_peaks", lambda dev=None: {})

    def boom(self, *a):
        raise RuntimeError("event timing failed")
    monkeypatch.setattr(profiling.KernelLedger, "_measure_one", boom)
    with pytest.raises(RuntimeError, match="event timing failed"):
        ledger.measure(["cache_probe"])
    monkeypatch.undo()
    entry = ledger.compute(["cache_probe"], device="cpu")["cache_probe"]
    assert not any(k.startswith("measure") for k in entry)


class _Event:
    def __init__(self, key, count, us, cuda=True, annotation=False):
        self.key, self.count = key, count
        self.self_device_time_total = self.device_time_total = us
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def key_averages(self):
        return self._events


def test_device_totals_splits_kernels_copies_and_stages():
    """One counting rule for the ledger and chip_smoke.py: device events
    only, copies and fills apart from kernels, stage labels listed apart
    (their spans cover kernels already counted), all per call."""
    prof = _Prof([_Event("k_select", 6, 300.0), _Event("k_xor", 4, 100.0),
                  _Event("Memcpy HtoD", 2, 40.0),
                  _Event("Memset (Device)", 2, 20.0),
                  _Event("churn.base", 2, 400.0),
                  _Event("my_label", 2, 400.0, annotation=True),
                  _Event("aten::add", 9, 0.0, cuda=False)])
    tot = profiling.device_totals(prof, per=2)
    assert tot["kernels"] == 5 and tot["copies"] == 2
    assert tot["device_ms"] == 460.0 / 1e3 / 2
    assert [t["name"] for t in tot["top"]] == ["k_select", "k_xor",
                                               "Memcpy HtoD",
                                               "Memset (Device)"]
    assert tot["top"][0] == {"name": "k_select", "calls": 3.0,
                             "device_ms": 0.15}
    assert set(tot["stages"]) == {"churn.base", "my_label"}


@pytest.mark.parametrize("launches,calls", [(3, 200), (5, 120), (1000, 3)])
def test_profiled_window_scales_calls_and_reports_not_captured(
        monkeypatch, launches, calls):
    """A card ledger's window repeats a small spec's call up to ~600
    dispatched ops, behind a warm-up step of the same calls; a window
    with no device event for a call that dispatched ops is None (not
    captured), never a count of 0."""
    import torch.profiler as TP
    seen = {"n": 0}

    class FakeProfile:
        def __init__(self, activities, schedule, on_trace_ready):
            self.ready, self.steps = on_trace_ready, 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 2:            # warm-up, then the active step
                self.ready(_Prof(events))

    def fn():
        seen["n"] += 1

    monkeypatch.setattr(TP, "profile", FakeProfile)
    dev = torch.device("cpu")
    events = []
    assert profiling._profile_calls(fn, (), {}, dev, launches) is None
    assert seen["n"] == 2 * calls
    assert profiling._profile_calls(fn, (), {}, dev, 0)["kernels"] == 0
    events = [_Event("k", 2 * calls, 10.0 * calls)]
    tot = profiling._profile_calls(fn, (), {}, dev, launches)
    assert tot["kernels"] == 2 and tot["device_ms"] == pytest.approx(0.01)


def test_platform_peaks_rows():
    assert set(profiling.PLATFORM_PEAKS) == {"h100", "cpu"}
    h = profiling.PLATFORM_PEAKS["h100"]
    assert h["hbm_bytes_per_s"] == 3.35e12 and h["flops_per_s"] == 989e12
    assert h["power_limit_w"] == 700.0
    row = profiling.platform_peaks("cpu")
    assert row["peak_key"] == "cpu" and row["power_limit"] == "not measured"


def test_roofline_on_a_given_elapsed(ledger):
    e = ledger.compute(["fused_gather_planar"],
                       device="cpu")["fused_gather_planar"]
    peaks = profiling.platform_peaks("cpu")
    rl = ledger.roofline("fused_gather_planar", 1e-3, peaks)
    t_b = e["bytes_bound"] / peaks["hbm_bytes_per_s"]
    t_o = e["flops_model"] / peaks["ops32_per_s"]
    assert rl["hbm_pct_of_peak"] == pytest.approx(100 * t_b / 1e-3,
                                                  rel=1e-4)
    assert rl["flops_pct_of_peak"] == pytest.approx(100 * t_o / 1e-3,
                                                    rel=1e-4)
    assert rl["bound_ms"] == pytest.approx(max(t_b, t_o) * 1e3)
    assert rl["bound"] == ("memory" if t_b >= t_o else "compute")
    assert rl["peak_key"] == "cpu" and "power_limit" in rl
    assert ledger.roofline("fused_gather_planar", 0.0) == {}
    h100 = dict(profiling.PLATFORM_PEAKS["h100"], peak_key="h100",
                power_limit="700.00 W")
    rl2 = ledger.roofline("fused_gather_planar", 1e-3, h100)
    assert rl2["hbm_pct_of_peak"] == pytest.approx(
        100 * e["bytes_bound"] / 3.35e12 / 1e-3, rel=1e-4)
    assert rl2["power_limit"] == "700.00 W"


# ------------------------------------------------------- export surfaces
def test_export_gauges_use_the_jax_names(ledger):
    reg = telemetry.MetricsRegistry()
    n = ledger.export_to_registry(reg)
    assert n == len(profiling.KERNEL_SPECS)
    snap = reg.snapshot()["gauges"]
    e = ledger.compute(["expanded_topk"], device="cpu")["expanded_topk"]
    lab = '{kernel="expanded_topk"}'
    assert snap["dht_kernel_bytes_accessed" + lab] == e["bytes_bound"]
    assert snap["dht_kernel_flops" + lab] == e["flops_model"]
    assert snap["dht_kernel_hbm_bytes" + lab] == (e["argument_bytes"]
                                                  + e["output_bytes"])
    assert snap["dht_kernel_temp_bytes" + lab] == -1.0   # not measured
    assert snap["dht_kernel_launches" + lab] == e["launches"]
    series = parse_exposition(reg.prometheus())
    assert series["dht_kernel_flops" + lab] == e["flops_model"]
    # the JAX ledger's gauge families, all present
    jreg = telemetry.MetricsRegistry()
    fams = {"dht_kernel_flops", "dht_kernel_bytes_accessed",
            "dht_kernel_hbm_bytes", "dht_kernel_temp_bytes"}
    ledger.export_to_registry(jreg)
    got = {k.split("{")[0] for k in jreg.snapshot()["gauges"]}
    assert fams <= got


def test_maybe_export_is_gated(monkeypatch, ledger):
    monkeypatch.delenv("OPENDHT_TPU_LEDGER", raising=False)
    ledger.enabled = False
    try:
        reg = telemetry.MetricsRegistry()
        assert profiling.maybe_export(reg, device="cpu") == 0
        assert not reg.snapshot()["gauges"]
    finally:
        ledger.enabled = True
    fresh = profiling.KernelLedger()
    monkeypatch.setattr(profiling, "_ledger", fresh)
    reg = telemetry.MetricsRegistry()
    assert profiling.maybe_export(reg, device="cpu") == 0
    assert not fresh.computed()
    monkeypatch.setenv("OPENDHT_TPU_LEDGER", "1")
    assert profiling.maybe_export(reg, device="cpu") == len(
        profiling.KERNEL_SPECS)
    assert 'dht_kernel_flops{kernel="swarm_step"}' in \
        reg.snapshot()["gauges"]


def test_wave_attrs_scaling_and_gating(ledger):
    entry = ledger.compute(["simulate_lookups"],
                           device="cpu")["simulate_lookups"]
    w_c = entry["shape"]["W"]
    attrs = profiling.wave_attrs(2 * w_c, 3, 0.5)
    assert attrs["est_device_bytes"] == int(entry["bytes_bound"] * 6)
    assert attrs["est_device_flops"] == int(entry["flops_model"] * 6)
    assert attrs["peak_key"] == "cpu" and "est_hbm_pct_of_peak" in attrs
    tp = profiling.wave_attrs(w_c, 2, 0.5, mode="tp", mesh_t=4)
    tp_e = ledger.compute(["tp_simulate_lookups"],
                          device="cpu")["tp_simulate_lookups"]
    assert tp["est_device_bytes"] == int(tp_e["bytes_bound"] * 2 / 4)
    assert tp["table_shard_t"] == 4
    ledger.enabled = False
    try:
        assert profiling.wave_attrs(2 * w_c, 3, 0.5) == {}
        assert profiling.ingest_wave_attrs(64) == {}
    finally:
        ledger.enabled = True
    assert profiling.wave_attrs(w_c, 0, 0.5) == {}


def test_ingest_wave_attrs_scaling(ledger):
    e = ledger.compute(["wave_builder_lookup"],
                       device="cpu")["wave_builder_lookup"]
    q = e["shape"]["Q"]
    a = profiling.ingest_wave_attrs(q // 2)
    assert a["est_device_bytes"] == int(e["bytes_bound"] * 0.5)
    b = profiling.ingest_wave_attrs(q, mesh_t=2)
    assert b["est_device_bytes"] == int(e["bytes_bound"] / 2)
    assert "t=2" in b["cost_model"]


def test_snapshot_folds_live_series(ledger):
    reg = telemetry.get_registry()
    reg.histogram("dht_maintenance_sweep_seconds").observe(0.004)
    e = ledger.snapshot()["maintenance_sweep"]
    assert e["series"] == "dht_maintenance_sweep_seconds"
    assert e["live_count"] >= 1 and e["live_p50_s"] > 0


def test_ops_bit_identical_with_ledger_enabled_and_spans_carry_cost(ledger):
    """The ledger observes, never participates: a lookup and an engine
    wave are unchanged by computing and exporting it, and a traced wave's
    span carries the ledger's cost attributes with the JAX span's keys."""
    from opendht_tpu.core.search import simulate_lookups as j_simulate
    from opendht_tpu import tracing as JT
    from opendht_tpu_torch.core.search import simulate_lookups
    from opendht_tpu_torch.ops.sorted_table import (expand_table,
                                                    expanded_topk,
                                                    sort_table)
    rng = np.random.default_rng(42)
    ids = rng.integers(0, 2 ** 32, size=(2048, 5), dtype=np.uint32)
    targets = rng.integers(0, 2 ** 32, size=(64, 5), dtype=np.uint32)
    s, _p, nv = sort_table(_keys(ids))
    e = expand_table(s)
    q = _keys(targets)
    ledger.enabled = False
    base_topk = expanded_topk(s, e, nv, q, k=8)
    base_wave = simulate_lookups(s, nv, q, alpha=3, k=8, device="cpu")
    ledger.enabled = True
    ledger.export_to_registry()
    tr = tracing.get_tracer()
    with tracing.activate(tracing.TraceContext.new_root()):
        led_wave = simulate_lookups(s, nv, q, alpha=3, k=8, device="cpu")
    led_topk = expanded_topk(s, e, nv, q, k=8)
    for a, b in zip(base_topk, led_topk):
        assert torch.equal(a, b)
    for key in ("nodes", "dist", "hops", "converged"):
        assert torch.equal(base_wave[key], led_wave[key]), key
    waves = [sp for sp in tr.spans() if sp["name"] == "dht.search.wave"]
    assert waves and "est_device_bytes" in waves[-1]["attrs"]
    # the JAX span of the same wave, with its ledger computed, has the
    # same attribute keys
    jled = JP.get_ledger()
    jled.compute(["simulate_lookups"])
    try:
        jtr = JT.get_tracer()
        with JT.activate(JT.TraceContext.new_root()):
            j_simulate(jnp.asarray(np.asarray(TK.from_keys(s))), int(nv),
                       jnp.asarray(targets), alpha=3, k=8)
        jwaves = [sp for sp in jtr.spans() if sp["name"] == "dht.search.wave"]
        assert set(waves[-1]["attrs"]) == set(jwaves[-1]["attrs"])
    finally:
        jled.clear()


def test_entries_hold_numbers_only(ledger):
    """compute() keeps no callable or tensor: its result is JSON."""
    import json
    out = json.loads(json.dumps(ledger.compute(device="cpu")))
    assert out == ledger.compute(device="cpu")
