"""The port's health and history observatories and its logger against
the JAX package's.

- The same synthetic registry traffic (op outcomes, latency
  observations, signal values) on a manual clock, fed to both packages'
  ``HealthEvaluator``, gives the same reports tick by tick and the same
  ``health_transition`` / ``slo_violation`` events.
- The same counters, gauges and histograms ticked into both packages'
  ``MetricsHistory`` give the same frames and windowed queries, the
  health engine reading through the recorder gives the same verdicts,
  and ``build_bundle`` the same JSON (its clock fields aside).
- ``NodeHealth`` over a port node and a JAX node gives the same signals.
- The filters and sinks of ``log.py`` (tests/test_log.py) on the port's
  ``DhtLogger``, the port node's tagged call sites included.
"""

from __future__ import annotations

import importlib
import json
import logging

import pytest

PORT, JAX = "opendht_tpu_torch", "opendht_tpu"
PKGS = (JAX, PORT)


def _pkg(pkg):
    return {m: importlib.import_module(f"{pkg}.{m}")
            for m in ("health", "history", "telemetry", "tracing")}


# ----------------------------------------------------- the health engine
class Env:
    """Fresh registry, tracer and manual clock for one package."""

    def __init__(self, pkg, cfg_kw, slos=None, providers=None):
        m = _pkg(pkg)
        self.m = m
        self.reg = m["telemetry"].MetricsRegistry()
        self.tr = m["tracing"].Tracer(capacity=256, node="healthtest")
        self.t = 0.0
        self.cfg = m["health"].HealthConfig(**cfg_kw)
        if slos is not None:
            self.cfg.slos = tuple(m["health"].SloObjective(*s[:4], **s[4])
                                  for s in slos)
        self.vals = {}
        prov = {name: (lambda _n=name: self.vals.get(_n))
                for name in (providers or ())}
        self.ev = m["health"].HealthEvaluator(
            self.cfg, registry=self.reg, tracer=self.tr,
            clock=lambda: self.t, providers=prov or None)

    def step(self, s):
        kind = s[0]
        if kind == "ops":
            _, op, ok, bad = s
            if ok:
                self.reg.counter("dht_ops_total", op=op, ok="true").inc(ok)
            if bad:
                self.reg.counter("dht_ops_total", op=op,
                                 ok="false").inc(bad)
        elif kind == "obs":
            _, op, v, n = s
            h = self.reg.histogram("dht_op_seconds", op=op)
            for _ in range(n):
                h.observe(v)
        elif kind == "sig":
            self.vals[s[1]] = s[2]
        elif kind == "tick":
            self.t = s[1]
            return self.ev.tick()

    def events(self):
        return [(e["ev"], e["attrs"]) for e in self.tr.events()
                if e["ev"] in ("health_transition", "slo_violation")]


AVAIL90 = [("get_availability", "get", "availability", 0.9, {})]
SCENARIOS = {
    "empty_registry": ({}, None, None, [("tick", 0.0), ("tick", 1.0)]),
    "fast_burn": ({"fast_window": 10.0, "slow_window": 100.0}, None, None,
                  [("tick", 0.0), ("ops", "get", 0, 10), ("tick", 2.0)]),
    "slow_burn": ({"fast_window": 5.0, "fast_burn": 20.0,
                   "slow_window": 60.0, "slow_burn": 2.0}, AVAIL90, None,
                  [("tick", 0.0)] + [s for i in range(1, 30) for s in
                                     (("ops", "get", 7, 3),
                                      ("tick", float(i)))]),
    "min_events": ({"min_events": 4}, None, None,
                   [("tick", 0.0), ("ops", "get", 0, 2), ("tick", 1.0)]),
    "hysteresis": ({"fast_window": 0.5, "fast_burn": 1e9,
                    "slow_window": 1.0, "slow_burn": 2.0,
                    "recover_ratio": 0.8, "min_events": 1}, AVAIL90, None,
                   [("tick", 0.0)] + [s for i, (ok, bad) in enumerate(
                       ((75, 25), (81, 19), (79, 21), (95, 5)))
                       for s in (("ops", "get", ok, bad),
                                 ("tick", float(i + 1)))]),
    "latency": ({"fast_window": 10.0, "fast_burn": 5.0,
                 "slow_window": 100.0},
                [("get_latency", "get", "latency", 0.9,
                  {"threshold_s": 1.0})], None,
                [("tick", 0.0), ("obs", "get", 0.4, 20), ("tick", 1.0),
                 ("obs", "get", 4.0, 20), ("tick", 2.0)]),
    "latch_decay": ({"fast_window": 2.0, "slow_window": 4.0}, None, None,
                    [("tick", 0.0), ("ops", "get", 0, 10), ("tick", 1.0),
                     ("tick", 1.5), ("tick", 1.8), ("tick", 4.0),
                     ("tick", 7.0)]),
    "signal_hysteresis": ({}, [], ["ingest_queue"],
                          [s for i, v in enumerate(
                              (0.0, 0.6, 0.95, 0.75, None, 0.1))
                           for s in (("sig", "ingest_queue", v),
                                     ("tick", float(i)))]),
    "put_and_get_mixed": ({"fast_window": 4.0, "slow_window": 20.0}, None,
                          None, [("tick", 0.0)] + [s for i in range(1, 12)
                                                   for s in (
                              ("ops", "get", 10, i % 3),
                              ("ops", "put", 5, 5 if i in (4, 5) else 0),
                              ("obs", "put", 0.2 * i, 3),
                              ("tick", float(i)))]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_health_engine_gives_the_same_reports(name):
    cfg_kw, slos, providers, steps = SCENARIOS[name]
    runs = {}
    for pkg in PKGS:
        env = Env(pkg, cfg_kw, slos, providers)
        reports = [r for r in (env.step(s) for s in steps) if r is not None]
        runs[pkg] = (json.dumps(reports, sort_keys=True), env.events(),
                     env.reg.snapshot()["gauges"])
    assert runs[PORT] == runs[JAX]
    assert runs[PORT][1], "the scenario made no transition"


def test_shared_helpers_agree():
    from opendht_tpu import health as jh
    from opendht_tpu_torch import health as ph
    specs = ["p95=2.5", "50=1", "99.9=0.25"]
    assert ph.parse_alerts(specs) == jh.parse_alerts(specs)
    for bad in (["p0=1"], ["x"], ["p101=1"]):
        for h in (ph, jh):
            with pytest.raises(ValueError):
                h.parse_alerts(bad)
    buckets = [(0.5, 3), (1.0, 9), (2.0, 14), (float("inf"), 16)]
    for q in (0.1, 0.5, 0.9, 0.99):
        assert ph.quantile_from_cumulative(buckets, q) == \
            jh.quantile_from_cumulative(buckets, q)
    alerts = {95: 1.5, 50: 0.5}
    observed = {0.95: 2.0, 0.5: 0.1}.get
    assert ph.percentile_breaches(observed, alerts) == \
        jh.percentile_breaches(observed, alerts) == [(95, 2.0, 1.5)]


# ------------------------------------------------------------ the recorder
def _no_wall(obj):
    """``obj`` as JSON text without its wall-clock stamps (``t``,
    ``time``): the recorder's frames and bundles carry time.time()."""
    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items()
                    if k not in ("t", "time")}
        if isinstance(o, list):
            return [strip(v) for v in o]
        return o
    return json.dumps(strip(json.loads(json.dumps(obj))), sort_keys=True)


def _recorders(capacity=16, **kw):
    out = {}
    for pkg in PKGS:
        m = _pkg(pkg)
        reg = m["telemetry"].MetricsRegistry()
        clock = [0.0]
        h = m["history"].MetricsHistory(
            m["history"].HistoryConfig(period=1.0, capacity=capacity, **kw),
            registry=reg, clock=lambda c=clock: c[0])
        out[pkg] = (m, reg, clock, h)
    return out


def _drive(reg, clock, h, i):
    """Tick i of a traffic script: counters (one reset), a gauge that
    changes every third tick, and two histograms."""
    if i == 7:
        reg.reset()
    reg.counter("dht_ops_total", op="get", ok="true").inc(10 + i)
    reg.counter("dht_ops_total", op="get", ok="false").inc(i % 4)
    reg.counter("h_boot_total").inc(1000 if i == 0 else 3)
    reg.gauge("h_queue").set(float(i // 3))
    reg.histogram("dht_op_seconds", op="get").observe(0.5 if i < 5 else 8.0)
    reg.histogram("h_sec", op="put").observe(0.01 * (i + 1))
    clock[0] = float(i)
    return h.tick()


@pytest.mark.parametrize("capacity", [8, 64])
def test_recorder_gives_the_same_frames_and_windows(capacity):
    rec = _recorders(capacity)
    res = {}
    for pkg, (m, reg, clock, h) in rec.items():
        ticks = [_drive(reg, clock, h, i) for i in range(20)]
        frames = h.frames()
        res[pkg] = {
            "ticks": _no_wall(ticks),
            "frames": _no_wall(frames),
            "meta": _no_wall(h.meta()),
            "delta": [h.counter_delta("dht_ops_total", t0, t1)
                      for t0, t1 in ((0, 5), (5, 19), (12, 19), (90, 99))],
            "rate": [h.rate('dht_ops_total{ok="true",op="get"}', t0, 19.0)
                     for t0 in (2.0, 10.0, 15.0)],
            "q": [h.quantile("dht_op_seconds", q, t0, t1)
                  for q in (0.5, 0.95) for t0, t1 in ((0, 4), (4, 19))],
            "series": json.dumps(m["history"].frames_to_series(
                json.loads(json.dumps(frames))), sort_keys=True),
            "limited": _no_wall(h.frames(limit=3)),
        }
    assert res[PORT] == res[JAX]
    frames = json.loads(res[PORT]["frames"])
    assert len(frames) == min(capacity, 19)


def test_health_reads_through_the_recorder_alike():
    res = {}
    for pkg in PKGS:
        m = _pkg(pkg)
        reg = m["telemetry"].MetricsRegistry()
        clock = [0.0]
        h = m["history"].MetricsHistory(
            m["history"].HistoryConfig(period=1.0, capacity=64),
            registry=reg, clock=lambda: clock[0])
        cfg = m["health"].HealthConfig(fast_window=10.0, slow_window=30.0,
                                       min_events=4)
        tr = m["tracing"].Tracer(capacity=64, node="through")
        ev = m["health"].HealthEvaluator(cfg, registry=reg, tracer=tr,
                                         clock=lambda: clock[0], history=h)
        transitions = []
        ev.on_transition = lambda prev, new, rep: transitions.append(
            (prev, new, rep.get("causes")))
        reports = []
        for n_ok, n_bad in [(20, 0)] * 3 + [(0, 20)] * 3 + [(20, 0)] * 40:
            clock[0] += 1.0
            reg.counter("dht_ops_total", op="get", ok="true").inc(n_ok)
            reg.counter("dht_ops_total", op="get", ok="false").inc(n_bad)
            h.tick()
            reports.append(ev.tick())
        res[pkg] = (json.dumps(reports, sort_keys=True), transitions)
    assert res[PORT] == res[JAX]
    assert [t[1] for t in res[PORT][1]] == ["healthy", "unhealthy",
                                            "degraded", "healthy"]


def test_bundles_are_the_same_json():
    """A bundle over the same recorder and sections: the same JSON but
    for its wall-clock stamp, and the same kernel-ledger entry (empty:
    the ledger is not computed on the JAX side and not ported)."""
    rec = _recorders(32, bundle_frames=5)
    out = {}
    for pkg, (m, reg, clock, h) in rec.items():
        for i in range(12):
            _drive(reg, clock, h, i)
        tr = m["tracing"].Tracer(capacity=32, node="bundle")
        tr.event("health_transition", **{"from": "healthy",
                                         "to": "unhealthy"})
        b = m["history"].build_bundle(
            reason="test", node_id="ab" * 20, status="CONNECTED",
            history=h, health={"verdict": "unhealthy"},
            metrics=reg.snapshot(), keyspace={"enabled": False},
            ingest={"waves": 3}, tracer=tr, flight_limit=10)
        h.store_bundle(b)
        out[pkg] = (_no_wall(b), len(h.bundles()))
    assert out[PORT] == out[JAX]
    b = json.loads(out[PORT][0])
    assert b["kernels"] == {} and len(b["history"]["frames"]) == 5
    assert b["flight_recorder"]["events"][0]["ev"] == "health_transition"


# ----------------------------------------------------- NodeHealth on nodes
SIGNALS = ("_connectivity", "_ingest_queue", "_stale_buckets",
           "_shard_imbalance", "_cache_hit_ratio", "_pipeline_occupancy",
           "_peer_flap")


def test_node_health_signals_agree_on_a_port_and_a_jax_node():
    """The per-node signals of a fresh node of each package, both at
    their defaults (planes on; the JAX node's resharding off): the same
    values, the keyspace and hot-cache signals unknown on both (nothing
    observed, no cache window yet)."""
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.reshard import ReshardConfig
    from opendht_tpu.runtime import Config as JConfig, Dht as JDht
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.runtime import Config, Dht

    jd = JDht(lambda d, a: 0, JConfig(
        node_id=JHash.get("health-node"), ingest_queue_max=8,
        reshard=ReshardConfig(enabled=False)),
        has_v6=False)
    pd = Dht(lambda d, a: 0, Config(node_id=InfoHash.get("health-node"),
                                    ingest_queue_max=8),
             has_v6=False, device="cpu")
    got = {}
    for pkg, dht in ((JAX, jd), (PORT, pd)):
        m = _pkg(pkg)
        nh = m["health"].NodeHealth(dht, m["health"].HealthConfig(),
                                    node="health-node")
        got[pkg] = {s: getattr(nh, s)() for s in SIGNALS}
        # the process-wide waterfall's worst stage: each package's own,
        # fed by whatever ran before in this process
        budget = nh._stage_budget()
        assert budget is None or budget >= 0
    assert got[PORT] == got[JAX]
    assert got[PORT]["_connectivity"] == 2.0        # disconnected
    assert got[PORT]["_shard_imbalance"] is None
    assert got[PORT]["_cache_hit_ratio"] is None


# ------------------------------------------------------------------ log.py
class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _capturing_logger(name):
    from opendht_tpu_torch.log import DhtLogger
    lg = DhtLogger(name)
    cap = _Capture()
    lg._swap_handler(cap)
    return lg, cap


def test_log_default_logger_is_the_ports():
    from opendht_tpu_torch.log import DhtLogger
    assert DhtLogger()._logger.name == "opendht_tpu_torch"


def test_log_disable_restores_logger_state():
    from opendht_tpu_torch.log import DhtLogger
    name = "t.torch.restore"
    base = logging.getLogger(name)
    base.setLevel(logging.WARNING)
    lg = DhtLogger(name)
    assert base.level == logging.WARNING
    lg.set_sink_file("/dev/null")
    assert base.level == logging.DEBUG and not base.propagate
    lg.disable()
    assert base.level == logging.WARNING and base.propagate


def test_log_streams_reach_sink():
    lg, cap = _capturing_logger("t.torch.streams")
    lg.e("err %d", 1)
    lg.w("warn %s", "x")
    lg.d("dbg")
    assert cap.lines == ["err 1", "warn x", "dbg"]


def test_log_per_hash_filter():
    from opendht_tpu_torch.infohash import InfoHash
    lg, cap = _capturing_logger("t.torch.filter")
    h1, h2 = InfoHash.get("one"), InfoHash.get("two")
    lg.set_filter(h1)
    lg.d("about one", h=h1)
    lg.d("about two", h=h2)
    lg.d("untagged")
    assert cap.lines == ["about one"]
    lg.set_filter(None)
    lg.d("untagged 2")
    assert cap.lines == ["about one", "untagged 2"]


def test_log_filter_applies_to_core_runtime_records():
    from opendht_tpu_torch.infohash import InfoHash
    lg, cap = _capturing_logger("opendht_tpu_torch.t_core")
    core = logging.getLogger("opendht_tpu_torch.t_core.dht")
    h1, h2 = InfoHash.get("one"), InfoHash.get("two")
    lg.set_filter(h1)
    core.warning("[search %s] expired", "one",
                 extra={"dht_hash": bytes(h1)})
    core.warning("[search %s] expired", "two",
                 extra={"dht_hash": bytes(h2)})
    core.warning("untagged core record")
    assert cap.lines == ["[search one] expired"]
    lg.set_filter(None)
    core.warning("untagged core record 2")
    assert cap.lines[-1] == "untagged core record 2"


def test_log_tagged_call_sites_of_the_port_node_carry_dht_hash():
    """The port node's ``_on_error`` token flush tags its record with
    the peer's id, so the port logger's filter selects it."""
    from opendht_tpu_torch.infohash import InfoHash
    from opendht_tpu_torch.net.engine import DhtProtocolException
    from opendht_tpu_torch.net.node import Node
    from opendht_tpu_torch.net.parsed_message import MessageType
    from opendht_tpu_torch.net.request import Request
    from opendht_tpu_torch.runtime import Config, Dht
    from opendht_tpu_torch.sockaddr import SockAddr

    lg, cap = _capturing_logger("opendht_tpu_torch")
    try:
        dht = Dht(lambda d, a: 0, Config(node_id=InfoHash.get("self")),
                  has_v4=True, has_v6=False, device="cpu")
        node_id = InfoHash.get("flushed-peer")
        node = Node(node_id, SockAddr("10.0.0.7", 4007))
        lg.set_filter(InfoHash.get("some-other-key"))
        dht._on_error(Request(MessageType.ANNOUNCE_VALUE, 1, node, b"",
                              None, None),
                      DhtProtocolException(
                          DhtProtocolException.UNAUTHORIZED))
        assert cap.lines == []
        lg.set_filter(node_id)
        dht._on_error(Request(MessageType.ANNOUNCE_VALUE, 2, node, b"",
                              None, None),
                      DhtProtocolException(
                          DhtProtocolException.UNAUTHORIZED))
        assert any("token flush" in ln for ln in cap.lines)
    finally:
        lg.disable()


def test_log_file_sink(tmp_path):
    from opendht_tpu_torch.log import DhtLogger
    lg = DhtLogger("t.torch.file")
    path = str(tmp_path / "dht.log")
    lg.set_sink_file(path)
    lg.w("to the file")
    lg.disable()
    content = open(path).read()
    assert "to the file" in content and "WARN" in content
