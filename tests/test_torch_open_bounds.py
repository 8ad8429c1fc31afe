"""The port's cost gate (``opendht_tpu_torch.perf_gate`` over
``opendht_tpu_torch/perf_budgets.json``), its OPEN-bound tracker
(``waterfall.OpenBoundTracker``, twinning tests/test_waterfall.py's) and
the call sites that read the ledger: the runner's metrics and profile,
a history bundle's ``kernels`` entry and the ingest wave span.

- The committed budgets round-trip against a live CPU ledger; an
  injected launch or byte regression and a shape drift fail the gate; a
  timing ceiling only warns; a card ledger's launch count is printed,
  not gated; every time or rate target of the open bounds is null.
- The tracker serves the budgets' open keys (the JAX tracker's keys),
  its gauges live from boot, follows the live series as the JAX
  tracker does, writes its settling record and ticks on a scheduler.
- With the ledger computed, the port runner's ``get_metrics()`` carries
  the JAX runner's ``dht_kernel_*`` series and ``get_profile()`` its
  ``open_bounds`` keys; an ingest wave span carries the JAX span's keys.
"""

import copy
import json

import pytest

from opendht_tpu import profiling as JP
from opendht_tpu import telemetry as jtel
from opendht_tpu import tracing as JT
from opendht_tpu import waterfall as JW
from opendht_tpu_torch import perf_gate, profiling, telemetry, tracing
from opendht_tpu_torch.scheduler import Scheduler
from opendht_tpu_torch.waterfall import OPEN_BOUND_KEYS, OpenBoundTracker

from test_torch_hotcache import JAX, PORT, TwinNode


@pytest.fixture(scope="module")
def ledger():
    led = profiling.get_ledger()
    led.clear()
    led.enabled = True
    led.compute(device="cpu")
    yield led
    led.clear()


def _budgets():
    with open(perf_gate.BUDGETS) as fh:
        return json.load(fh)


def _gate_with(tmp_path, budgets, *extra):
    p = tmp_path / "perf_budgets.json"
    p.write_text(json.dumps(budgets))
    return perf_gate.main(["--budgets", str(p), *extra])


# -------------------------------------------------------------- the gate
def test_budgets_roundtrip_against_the_live_ledger(ledger, capsys):
    assert perf_gate.main([]) == 0
    assert "launches = ops dispatched on the CPU" in capsys.readouterr().out
    b = _budgets()
    assert b["platform"] == "cpu"
    assert set(b["kernels"]) == set(profiling.KERNEL_SPECS)
    for name, e in ledger.compute(device="cpu").items():
        for field in ("shape", "argument_bytes", "output_bytes",
                      "launches", "launches_by_op", "bytes_bound",
                      "flops_model"):
            assert b["kernels"][name][field] == e[field], (name, field)


@pytest.mark.parametrize("field,factor", [("launches", 0.5),
                                          ("argument_bytes", 0.5),
                                          ("output_bytes", 2.0)])
def test_gate_fails_on_an_injected_regression(tmp_path, capsys, ledger,
                                              field, factor):
    """Halving a budget (= the live program doubling against it) or
    doubling one fails the gate, naming the spec and the field."""
    b = _budgets()
    b["kernels"]["find_closest_nodes_batched"][field] = int(
        b["kernels"]["find_closest_nodes_batched"][field] * factor)
    assert _gate_with(tmp_path, b) == 1
    assert f"find_closest_nodes_batched.{field}" in capsys.readouterr().err


def test_gate_absorbs_a_small_launch_drift(tmp_path, ledger):
    b = _budgets()
    b["kernels"]["swarm_step"]["launches"] += 3
    assert _gate_with(tmp_path, b) == 0


def test_gate_fails_on_shape_drift(tmp_path, capsys, ledger):
    b = _budgets()
    b["kernels"]["maintenance_sweep"]["shape"]["N"] += 1
    assert _gate_with(tmp_path, b) == 1
    assert "shape drifted" in capsys.readouterr().err


def test_gate_fails_on_missing_and_unbudgeted_specs(ledger):
    b = _budgets()
    live = ledger.compute(device="cpu")
    fails, _w = perf_gate.gate(b, {k: v for k, v in live.items()
                                   if k != "cache_probe"})
    assert any(f.startswith("cache_probe:") for f in fails)
    b2 = copy.deepcopy(b)
    del b2["kernels"]["sketch_update"]
    fails, _w = perf_gate.gate(b2, live)
    assert any(f.startswith("sketch_update:") for f in fails)


def test_timing_ceiling_only_warns(tmp_path, capsys, ledger):
    rec = tmp_path / "records"
    rec.mkdir()
    (rec / "bench.json").write_text(json.dumps({"ms_per_call": 1e9}))
    b = _budgets()
    b["timing_soft"]["bench_ms_per_call"]["max"] = 10.0
    assert _gate_with(tmp_path, b, "--records", str(rec)) == 0
    out = capsys.readouterr().out
    assert "perf_gate WARN" in out and "ms_per_call" in out
    # the committed ceilings: a breach is reported, never failing
    assert perf_gate.main(["--records", str(rec)]) == 0
    out = capsys.readouterr().out
    assert "exceeds the soft ceiling 42.0" in out
    assert "no swarm_storm.json" in out
    b["timing_soft"]["bench_ms_per_call"]["max"] = None
    assert _gate_with(tmp_path, b, "--records", str(rec)) == 0
    assert "no ceiling set" in capsys.readouterr().out


def test_card_launches_are_printed_not_gated(ledger):
    """A card ledger dispatches its hand kernels outside aten: its
    launch count differs from the CPU budget and only warns, while the
    CPU-deterministic fields still gate; a card-measured peak is soft."""
    b = _budgets()
    card = copy.deepcopy(ledger.compute(device="cpu"))
    for e in card.values():
        e["platform"] = "cuda"
        e["launches"] = e["launches"] // 2 + 1
        e["device_kernels"] = 7
        e["peak_temp_bytes"] = 10 ** 9
    b["kernels"]["cache_probe"]["peak_temp_bytes"] = 1000
    fails, warns = perf_gate.gate(b, card)
    assert fails == []
    assert any("launches" in w and "not gated" in w for w in warns)
    assert any("cache_probe.peak_temp_bytes" in w for w in warns)
    card["cache_probe"]["output_bytes"] += 4
    fails, _w = perf_gate.gate(b, card)
    assert any("cache_probe.output_bytes" in f for f in fails)


def test_update_takes_the_card_peaks_from_a_ledger_record(tmp_path,
                                                          ledger):
    """--update re-bases the CPU fields from the live ledger and the
    soft peak temporaries from a card run's ledger.json; a spec the
    record lacks keeps its committed peak; the re-based file gates."""
    b = _budgets()
    b["kernels"]["sketch_update"]["peak_temp_bytes"] = 777
    p = tmp_path / "perf_budgets.json"
    p.write_text(json.dumps(b))
    rec = tmp_path / "records"
    rec.mkdir()
    card = copy.deepcopy(ledger.compute(device="cpu"))
    for e in card.values():
        e["platform"] = "cuda"
        e["peak_temp_bytes"] = 4096
    del card["sketch_update"]
    (rec / "ledger.json").write_text(json.dumps(card))
    assert perf_gate.main(["--budgets", str(p), "--update",
                           "--records", str(rec)]) == 0
    new = json.loads(p.read_text())
    assert new["kernels"]["cache_probe"]["peak_temp_bytes"] == 4096
    assert new["kernels"]["sketch_update"]["peak_temp_bytes"] == 777
    assert new["timing_soft"] == b["timing_soft"]
    assert new["open_bounds"] == b["open_bounds"]
    assert perf_gate.main(["--budgets", str(p)]) == 0
    # a card ledger under the re-based peaks: inside the band, silent
    fails, warns = perf_gate.gate(new, {**card, "sketch_update": dict(
        ledger.compute(device="cpu")["sketch_update"])})
    assert fails == [] and not any("peak_temp" in w for w in warns)


def test_open_bounds_carry_no_time_or_rate_target():
    ob = _budgets()["open_bounds"]
    with open(JW._repo_budgets_path()) as fh:
        jax_ob = json.load(fh)["open_bounds"]
    assert set(ob) == {k for k, v in jax_ob.items() if v.get("open")}
    for key, b in ob.items():
        assert b["open"] is True and b["metric"] and b["settle"]
        assert "opendht_tpu/" not in b["settle"]
        for field, v in b["target"].items():
            if field in ("min_ratio", "min_hit_ratio"):
                continue                    # dimensionless: may stay
            assert v is None, (key, field)
    assert ob["churny_static_ratio"]["target"]["min_ratio"] == 0.6
    assert ob["cache_flood_p50"]["target"]["min_hit_ratio"] == 0.9
    # the wall-clock ceilings are not open bounds: each is set from a
    # card run that its note names
    for spec in _budgets()["timing_soft"].values():
        assert spec["max"] > 0 and "H100" in spec["note"]


# ----------------------------------------------------------- the tracker
def test_open_bound_keys_match_the_budgets_and_the_jax_tracker():
    want = {k for k, v in _budgets()["open_bounds"].items() if v.get("open")}
    assert want == set(OPEN_BOUND_KEYS) == set(JW.OPEN_BOUND_KEYS)
    t = OpenBoundTracker(reg=telemetry.MetricsRegistry(), device="cpu")
    assert set(t.bounds) == want


def test_open_bound_gauges_live_from_boot_with_sentinel():
    reg = telemetry.MetricsRegistry()
    t = OpenBoundTracker(reg=reg, device="cpu")
    assert t.platform == "cpu" and t.status == "unsettled"
    out = t.refresh()
    g = reg.snapshot()["gauges"]
    for key in OPEN_BOUND_KEYS:
        series = 'dht_open_bound{key="%s",status="unsettled"}' % key
        assert g[series] == -1.0
        assert out[key]["value"] is None


def _observe(reg):
    for _ in range(8):
        reg.histogram("dht_search_wave_seconds", mode="single",
                      wave="1024").observe(0.004)
        reg.histogram("dht_search_wave_seconds", mode="tp").observe(0.020)
        reg.histogram("dht_churn_lookup_seconds").observe(0.010)
        reg.histogram("dht_maintenance_sweep_seconds").observe(0.003)
        reg.histogram("dht_op_seconds", op="get").observe(0.002)
        reg.histogram("dht_listener_match_seconds").observe(0.0007)
    reg.histogram("dht_ingest_wave_occupancy").observe(6.0)
    reg.histogram("dht_ingest_wave_occupancy").observe(2.0)


def test_open_bound_measurements_track_live_series_as_the_jax_tracker():
    reg, jreg = telemetry.MetricsRegistry(), jtel.MetricsRegistry()
    t = OpenBoundTracker(reg=reg, device="cpu")
    jt = JW.OpenBoundTracker(reg=jreg)
    _observe(reg)
    _observe(jreg)
    out, jout = t.refresh(), jt.refresh()
    assert {k: v["value"] for k, v in out.items()} == \
        {k: v["value"] for k, v in jout.items()}
    assert out["ingest_wave_occupancy"]["value"] == 4.0
    assert out["shard_wave_10m"]["value"] > out["wave_p50_ms_1024"]["value"]
    g = reg.snapshot()["gauges"]
    assert g['dht_open_bound{key="ingest_wave_occupancy",'
             'status="unsettled"}'] == 4.0
    assert t.snapshot()["status"] == "unsettled"


def test_open_bound_settling_record_roundtrip(tmp_path):
    reg = telemetry.MetricsRegistry()
    t = OpenBoundTracker(reg=reg, device="cpu")
    assert t.write_record(str(tmp_path)) is None
    reg.histogram("dht_search_wave_seconds", mode="single").observe(0.004)
    t.refresh()
    path = t.write_record(str(tmp_path))
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["name"] == "open_bounds"
    assert doc["platform"] == "cpu" and doc["status"] == "unsettled"
    assert set(doc["bounds"]) == {"wave_p50_ms_1024"}
    b = doc["bounds"]["wave_p50_ms_1024"]
    assert b["status"] == "unsettled" and b["value"] > 0
    assert b["metric"] and b["settle"]


def test_open_bound_tracker_ticks_on_scheduler(tmp_path, monkeypatch):
    monkeypatch.setenv("OPENDHT_TPU_SMOKE_RECORD_DIR", str(tmp_path))
    reg = telemetry.MetricsRegistry()
    clock = {"t": 100.0}
    sched = Scheduler(clock=lambda: clock["t"])
    t = OpenBoundTracker(reg=reg, device="cpu")
    reg.histogram("dht_op_seconds", op="get").observe(0.002)
    t.attach(sched, period=1.0)
    clock["t"] += 1.5
    sched.run()
    assert (tmp_path / "open_bounds.json").exists()
    g = reg.snapshot()["gauges"]
    assert g['dht_open_bound{key="cache_flood_p50",status="unsettled"}'] > 0
    clock["t"] += 1.5
    sched.run()


# ------------------------------------------------------ the call sites
SUB = ["maintenance_sweep", "wave_builder_lookup"]


def test_runner_metrics_and_profile_have_the_jax_runners_keys(monkeypatch):
    from opendht_tpu.runtime.runner import DhtRunner as JRunner
    from opendht_tpu.runtime.runner import RunnerConfig as JCfg
    from opendht_tpu_torch.runtime.runner import DhtRunner, RunnerConfig
    # both runners scrape fresh registries: an earlier test in this
    # process may have exported a ledger's dht_kernel_* gauges into the
    # process-global ones, which no ledger.clear() takes back out
    for tel in (telemetry, jtel):
        reg = tel.MetricsRegistry()
        monkeypatch.setattr(tel, "_global_registry", reg, raising=False)
        monkeypatch.setattr(tel, "get_registry", lambda r=reg: r)
    led, jled = profiling.get_ledger(), JP.get_ledger()
    led.clear()
    jled.clear()
    p, j = DhtRunner(), JRunner()
    p.run(0, RunnerConfig(), device="cpu")
    j.run(0, JCfg())
    try:
        assert "dht_kernel_flops" not in str(p.get_metrics()["gauges"])
        led.compute(SUB, device="cpu")
        jled.compute(SUB)
        pg = {k for k in p.get_metrics()["gauges"]
              if k.startswith("dht_kernel_")}
        jg = {k for k in j.get_metrics()["gauges"]
              if k.startswith("dht_kernel_")}
        assert jg and jg <= pg, jg - pg
        pprof, jprof = p.get_profile(), j.get_profile()
        assert set(pprof["open_bounds"]) == set(jprof["open_bounds"])
        assert set(pprof["open_bounds"]["bounds"]) == \
            set(jprof["open_bounds"]["bounds"])
        assert pprof["open_bounds"]["status"] == "unsettled"
        bundle = p.dump_bundle()
        assert set(bundle["kernels"]) == set(SUB)
        assert "kernels" in j.dump_bundle()
    finally:
        p.join()
        j.join()
        led.clear()
        jled.clear()


def test_history_bundle_kernels_entry_only_once_computed():
    from opendht_tpu_torch.history import HistoryConfig, MetricsHistory
    from opendht_tpu_torch.history import build_bundle
    led = profiling.get_ledger()
    led.clear()
    rec = MetricsHistory(HistoryConfig(period=1.0, capacity=4),
                         registry=telemetry.MetricsRegistry(),
                         clock=lambda: 0.0)
    assert not build_bundle(history=rec).get("kernels")
    led.compute(["cache_probe"], device="cpu")
    try:
        b = build_bundle(history=rec)
        assert b["kernels"]["cache_probe"]["launches"] > 0
        json.dumps(b)
    finally:
        led.clear()


def _ingest_wave_attrs(pkg, monkeypatch):
    node = TwinNode(pkg, monkeypatch, None, "ledger-span")
    M = node.M
    tr = tracing.get_tracer() if pkg == PORT else JT.get_tracer()
    act = tracing if pkg == PORT else JT
    with act.activate(act.TraceContext.new_root()):
        node.dht.get(M["InfoHash"].get("span-key"), lambda vals: True)
    node.advance(0.2)
    waves = [s for s in tr.spans() if s["name"] == "dht.search.wave"
             and s["attrs"].get("mode") == "ingest"]
    assert waves, pkg
    return waves[-1]["attrs"]


def test_ingest_wave_span_carries_the_jax_spans_cost_keys(monkeypatch):
    led, jled = profiling.get_ledger(), JP.get_ledger()
    led.clear()
    jled.clear()
    try:
        bare = _ingest_wave_attrs(PORT, monkeypatch)
        assert "est_device_bytes" not in bare
        led.compute(["wave_builder_lookup"], device="cpu")
        jled.compute(["wave_builder_lookup"])
        got = _ingest_wave_attrs(PORT, monkeypatch)
        want = _ingest_wave_attrs(JAX, monkeypatch)
        assert set(got) == set(want)
        assert got["est_device_bytes"] > 0
        assert got["cost_model"].startswith("wave_builder_lookup")
    finally:
        led.clear()
        jled.clear()
