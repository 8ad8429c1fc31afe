"""The port's cluster tools (``testing/dhtcluster.py``, ``scanner.py``,
``network_monitor.py``, ``http_server.py``) against the JAX package's,
on the CPU, tolerance 0.

- Every case of tests/test_cluster_tools.py, the ``NodeCluster`` cases
  of tests/test_tracing.py (the cross-node span assembly and the scanner
  topology) and tests/test_telemetry.py's ``parse_alerts`` case run on
  both packages, in the manner of tests/test_torch_storage.py: the JAX
  file executed as written, then with its imports read as the port's.
  The cases build their nodes with the default device; for the port's
  run that default is read as the CPU (:func:`cpu_by_default`), the
  card being what it means everywhere else.  Both runs must pass the
  case's assertions and make the same calls into the tools: the case's
  own calls in the same order, each returning the same type of result
  (live values — ports, node ids, times, counts — differ between any
  two runs), and every pure function (the key parser, the alert
  grammar) the same results in the same order.
- The CLIs' ``--cpu`` runs, and without a card every tool raising
  "no CUDA device" before it binds a socket.

tests/test_cluster_tools.py marks its HTTP case slow; its twin keeps
the mark.  Every real-UDP wait here has its own limit of at least 60 s:
the cases' ``_wait_connected`` (the trace assembler's, 30 s by default)
waits ``WAIT`` in both runs (:func:`run_case_twins`), since a loaded
host's JAX nodes have taken more than 30 s to connect a 5-node
``NodeCluster`` (their bootstrap is retried every 10 s).  And in both
runs the runners keep packets that waited in their receive queue
(``RX_QUEUE_MAX_DELAY`` raised from 0.5 s to 60 s, as
tests/test_torch_monitor.py's mixed cluster does): on a loaded host a
JAX node's DHT thread sits in its first XLA compiles past 0.5 s and
drops what queued meanwhile, after which a 2-node network monitor can
miss its round (its put's peer marked expired).  A case's
``assemble_trace`` assembles the trace once it has settled (every
server and RPC span's parent recorded, the span count still for a
second; limit ``WAIT``): a get can end while requests of its search are
in flight, and a server span recorded before the reply reached its
client's RPC span made ``check_tree`` report an orphan under load.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import socket
import sys
import time

import pytest
import torch

import opendht_tpu_torch._device as _device
# imported before any case runs, so cpu_by_default reaches them all
import opendht_tpu_torch.runtime.runner  # noqa: F401
import opendht_tpu_torch.tools.dhtscanner  # noqa: F401
from opendht_tpu_torch.testing import (dhtcluster, http_server, netns_net,
                                       network_monitor, scanner,
                                       subproc_cluster)
from test_torch_storage import case_names, jax_case_namespace, norm

TOOL_FILES = ("testing/dhtcluster.py", "testing/scanner.py",
              "testing/network_monitor.py", "testing/http_server.py",
              "health.py")                  # health.py: parse_alerts
# functions whose results depend only on their arguments (a breach list
# carries measured latencies)
PURE = ("offline_geo", "_key_of", "parse_alerts")
# the limit of a case's wait for its cluster to connect
WAIT = 60.0
# how long a twin run's runners keep a packet queued for their DHT thread
HELD_DELAY = 60.0


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads while this file's nodes run: their ops are
    tiny, and beside other busy test processes all-core OpenMP pools
    spin against each other and slow every process on the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def cpu_by_default(monkeypatch) -> None:
    """Until the test ends, the port's ``device=None`` means the CPU: every
    loaded port module that imported ``resolve_device`` gets a wrapper
    that reads None as ``"cpu"`` (an explicit device passes through)."""
    orig = _device.resolve_device

    def on_the_cpu(device=None):
        return orig("cpu" if device is None else device)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("opendht_tpu_torch") \
                and getattr(mod, "resolve_device", None) is orig:
            monkeypatch.setattr(mod, "resolve_device", on_the_cpu)


def _kind(x):
    """A live result reduced to its type (None and bools kept)."""
    return x if x is None or isinstance(x, bool) else type(x).__name__


def tool_record(case, kwargs: dict, pkg: str, files=TOOL_FILES) -> dict:
    """Run ``case(**kwargs)`` with a profile hook on this thread (the
    nodes' own threads run untraced, at their usual pace).  Returns, in
    order, the case's own calls into ``files`` of the ``pkg`` package
    with the type of each result (what a live cluster returns — ports,
    ids, times, counts — differs between any two runs), and every call
    of a PURE function there with its result."""
    from test_torch_storage import PACKAGES, REPO
    root = REPO / PACKAGES[pkg]
    watched = {str(root / f) for f in files}
    calls, pure = [], []

    def hook(frame, event, arg):
        code = frame.f_code
        if event == "return" and code.co_filename in watched:
            if frame.f_back is not None \
                    and frame.f_back.f_code is case.__code__:
                calls.append((code.co_qualname, _kind(arg)))
            if code.co_name in PURE:
                pure.append((code.co_qualname, norm(arg)))
    sys.setprofile(hook)
    try:
        case(**kwargs)
    finally:
        sys.setprofile(None)
    return {"calls": calls, "pure": pure}


def _after_settling(assemble, collect):
    """``assemble`` (the trace assembler's) once the trace has settled:
    every server and RPC span's parent among the collected spans and
    their count unchanged for a second, or after ``WAIT`` seconds."""
    def settled(nodes, trace_id):
        deadline, last, still = time.monotonic() + WAIT, None, 0
        while time.monotonic() < deadline:
            spans = collect(nodes, trace_id)
            ids = {sp["span_id"] for sp in spans}
            whole = all(sp.get("parent_id") in ids for sp in spans
                        if sp.get("kind") == "server"
                        or sp["name"].startswith("dht.rpc."))
            still = still + 1 if whole and len(spans) == last else 0
            if still >= 10:
                break
            last = len(spans)
            time.sleep(0.1)
        return assemble(nodes, trace_id)
    return settled


def _own_limit(wait_connected):
    """``wait_connected`` with a default limit of ``WAIT`` seconds."""
    def wait(nodes, timeout=WAIT):
        return wait_connected(nodes, timeout=timeout)
    return wait


def run_case_twins(fname: str, name: str, monkeypatch, files=TOOL_FILES,
                   **fixtures) -> tuple:
    """Case ``name`` of tests/<fname> on the JAX package, then on the port
    (device None read as the CPU); their records over ``files``.  A
    case's ``_wait_connected`` waits ``WAIT`` seconds, and its runners
    keep packets queued up to ``HELD_DELAY`` seconds, in both runs."""
    import importlib
    out = []
    for pkg in ("jax", "port"):
        ns = jax_case_namespace(fname, pkg)
        if "_wait_connected" in ns:
            ns["_wait_connected"] = _own_limit(ns["_wait_connected"])
        if "assemble_trace" in ns:
            ns["assemble_trace"] = _after_settling(ns["assemble_trace"],
                                                   ns["collect_spans"])
        case = ns[name]
        runner = importlib.import_module(
            {"jax": "opendht_tpu", "port": "opendht_tpu_torch"}[pkg]
            + ".runtime.runner")
        with monkeypatch.context() as m:
            m.setattr(runner, "RX_QUEUE_MAX_DELAY", HELD_DELAY)
            if pkg == "port":
                cpu_by_default(m)
            out.append(tool_record(case, fixtures, pkg, files))
    return tuple(out)


# ---------------------------------------- the JAX cases, on both packages
TOOL_CASES = [("test_cluster_tools.py", n)
              for n in case_names("test_cluster_tools.py")] + [
    ("test_tracing.py", "test_cross_node_span_assembly_udp_cluster"),
    ("test_tracing.py", "test_scanner_topology_snapshot"),
    ("test_telemetry.py", "test_monitor_parse_alerts"),
]
SLOW = {"test_http_server_roundtrip"}


def test_every_case_is_twinned():
    assert len(TOOL_CASES) == 8 + 3
    assert {n for _, n in TOOL_CASES} >= SLOW


@pytest.mark.parametrize(
    "fname,name",
    [pytest.param(f, n, marks=[pytest.mark.slow] if n in SLOW else [])
     for f, n in TOOL_CASES],
    ids=["%s::%s" % c for c in TOOL_CASES])
def test_tool_case_twin(fname, name, monkeypatch, capsys):
    case = jax_case_namespace(fname, "jax")[name]
    fixtures = {"capsys": capsys} if "capsys" in inspect.signature(
        case).parameters else {}
    jax_rec, port_rec = run_case_twins(fname, name, monkeypatch, **fixtures)
    assert jax_rec["calls"], "the case reached no traced function"
    assert port_rec["calls"] == jax_rec["calls"]
    assert port_rec["pure"] == jax_rec["pure"]


def test_a_cases_wait_for_its_cluster_has_its_own_limit():
    for pkg in ("jax", "port"):
        wait = _own_limit(jax_case_namespace("test_tracing.py",
                                             pkg)["_wait_connected"])
        assert inspect.signature(wait).parameters["timeout"].default \
            == WAIT >= 60.0
        assert wait([]) is True                  # no node: connected


def test_a_trace_is_assembled_once_settled():
    """A server span whose client RPC span is still open (its reply in
    flight) is assembled only once that RPC span is recorded."""
    import threading
    from opendht_tpu_torch.testing import trace_assembler as ta
    tid = "ab" * 16
    op = {"trace_id": tid, "span_id": "1" * 16, "parent_id": "f" * 16,
          "name": "dht.op.get", "kind": "internal", "start": 0.0,
          "node": "a"}
    rpc = {**op, "span_id": "2" * 16, "parent_id": op["span_id"],
           "name": "dht.rpc.get", "kind": "client", "start": 0.1}
    srv = {**op, "span_id": "3" * 16, "parent_id": rpc["span_id"],
           "name": "dht.server.get", "kind": "server", "start": 0.2,
           "node": "b"}
    ring = [op, srv]
    threading.Timer(0.3, ring.append, (rpc,)).start()
    tree = _after_settling(ta.assemble_trace, ta.collect_spans)([ring], tid)
    assert tree["spans"] == 3 and ta.check_tree(tree) == []
    assert [r["name"] for r in tree["roots"]] == ["dht.op.get"]


# --------------------------------------------------- the CLIs on the CPU
def test_dhtcluster_cli_service_mode_on_the_cpu(monkeypatch):
    """``dhtcluster -s --cpu``: the nodes start on the host, the line
    names the bootstrap, and a stop signal ends it with every node
    joined."""
    import signal as _signal
    import threading

    stops = {}
    monkeypatch.setattr(_signal, "signal",
                        lambda sig, fn: stops.__setitem__(sig, fn))
    timer = threading.Timer(0.5, lambda: stops[_signal.SIGTERM](
        _signal.SIGTERM, None))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        timer.start()
        rc = dhtcluster.main(["-n", "3", "-s", "--cpu"])
    assert rc == 0
    assert out.getvalue().startswith("3 nodes running (bootstrap 127.0.0.1:")
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dht") and t.is_alive()]


def test_scanner_cli_local_on_the_cpu(capsys):
    assert scanner.main(["--local", "4", "--cpu", "--timeout", "60"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["probes"] >= 1 and doc["nodes"] >= 3
    assert len(doc["ring"]) == doc["nodes"]


def test_network_monitor_cli_on_the_cpu(capsys):
    assert network_monitor.main(["--local", "--cpu", "-n", "2", "--rounds",
                                 "1", "-t", "60", "-p", "0.1"]) == 0
    assert "Test completed successfully" in capsys.readouterr().out


# ------------------------------------------------ the card by default
def _tool_entry_points():
    return {
        "NodeCluster": lambda: dhtcluster.NodeCluster(),
        "dhtcluster.main": lambda: dhtcluster.main(["-n", "1", "-s"]),
        "ClusterSubProcess": lambda: subproc_cluster.ClusterSubProcess(1),
        "NetnsClusterNet": lambda: netns_net.NetnsClusterNet(),
        "Monitor": lambda: network_monitor.Monitor(None, 1, 1.0),
        "network_monitor.main": lambda: network_monitor.main(
            ["--local", "--rounds", "1"]),
        "scanner.main": lambda: scanner.main(["--local", "1"]),
        "http_server.main": lambda: http_server.main(["-hp", "0"]),
    }


@pytest.mark.parametrize("name", sorted(_tool_entry_points()))
def test_without_a_card_the_tools_raise_before_binding(name, monkeypatch):
    import subprocess
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bound, spawned = [], []
    orig_bind = socket.socket.bind
    monkeypatch.setattr(socket.socket, "bind",
                        lambda self, *a: bound.append(a) or
                        orig_bind(self, *a))
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **kw: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool_entry_points()[name]()
    assert bound == [] and spawned == []
