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
the mark.  Every real-UDP wait here has its own limit of at least 60 s.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import socket
import sys

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


def run_case_twins(fname: str, name: str, monkeypatch, files=TOOL_FILES,
                   **fixtures) -> tuple:
    """Case ``name`` of tests/<fname> on the JAX package, then on the port
    (device None read as the CPU); their records over ``files``."""
    out = []
    for pkg in ("jax", "port"):
        case = jax_case_namespace(fname, pkg)[name]
        with monkeypatch.context() as m:
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
