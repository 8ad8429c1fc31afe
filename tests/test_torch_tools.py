"""The port's CLI tools (``opendht_tpu_torch/tools/``) against the JAX
package's, on the CPU (``--cpu`` / ``device="cpu"``) over real localhost
UDP.

- Every case of tests/test_tools.py (argv / identity / state helpers),
  tests/test_cli_repl.py (the dhtnode REPL dispatch, dhtchat and
  dhtscanner mainlines) and tests/test_compat_check.py (all ``N_CHECKS``
  wire exchanges against a port runner) on the port.
- The same REPL script on a JAX pair and on a port pair of runners
  prints the same lines once node ids, value ids, ports and times are
  masked.
- The port's own surfaces: ``kernels`` prints the port ledger's 16
  specs and names the port's gate; ``dhtscanner --json --kernels``
  fills the ``kernels`` and ``waterfall`` sections; without a card and
  without ``--cpu``, ``setup_node`` raises before any socket is bound.

Robust under a loaded host: each pair of runners first runs an
unchecked exchange of the checked ops on keys of its own, the JAX peer
keeps delayed packets, and every wait has its own limit of at least
60 s.
"""

from __future__ import annotations

import builtins
import contextlib
import io
import json
import os
import re
import time

import pytest
import torch

from opendht_tpu_torch import crypto, profiling, telemetry
from opendht_tpu_torch.core.value import Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.runtime.config import Config, NodeStatus
from opendht_tpu_torch.runtime.runner import DhtRunner, RunnerConfig
from opendht_tpu_torch.tools.common import (
    load_identity, make_arg_parser, parse_bootstrap, save_identity,
    setup_node)
from opendht_tpu_torch.tools.dhtnode import cmd_loop, to_hash

CPU = {"device": "cpu"}
WAIT = 60.0


def wait_for(pred, timeout=WAIT, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def connected(*runners) -> bool:
    return all(r.get_status().name == "CONNECTED" for r in runners)


# ----------------------------------------------- tests/test_tools.py's
def test_parse_bootstrap_forms():
    assert parse_bootstrap("") is None
    assert parse_bootstrap("host") == ("host", 4222)
    assert parse_bootstrap("host:4000") == ("host", 4000)
    assert parse_bootstrap("[2001:db8::1]:4000") == ("2001:db8::1", 4000)
    assert parse_bootstrap("[2001:db8::1]") == ("2001:db8::1", 4222)
    assert parse_bootstrap("2001:db8::1") == ("2001:db8::1", 4222)


def test_to_hash_hex_vs_text():
    h = InfoHash.get("x")
    assert to_hash(h.hex()) == h
    assert to_hash("some words") == InfoHash.get("some words")


def test_identity_save_load(tmp_path):
    ident = crypto.generate_identity("tools-test", key_length=1024)
    prefix = str(tmp_path / "id")
    save_identity(ident, prefix)
    assert os.path.exists(prefix + ".pem")
    assert os.path.exists(prefix + ".crt")
    loaded = load_identity(prefix)
    assert loaded is not None
    assert loaded.second.get_id() == ident.second.get_id()
    sig = loaded.first.sign(b"data")
    assert ident.first.public_key().check_signature(b"data", sig)


def test_state_save_load_roundtrip(tmp_path):
    """Checkpoint/resume: nodes + values exported to a file come back on
    a fresh runner."""
    from opendht_tpu_torch.tools.common import load_state, save_state
    a, b, c = DhtRunner(), DhtRunner(), None
    try:
        a.run(0, **CPU)
        b.run(0, **CPU)
        b.bootstrap("127.0.0.1", a.get_bound_port())
        assert wait_for(lambda: connected(b))
        key = InfoHash.get("state-key")
        assert b.put_sync(key, Value(b"persisted"), timeout=WAIT)
        path = str(tmp_path / "state.mp")
        save_state(b, path)
        b.join()
        c = DhtRunner()
        c.run(0, **CPU)
        n_nodes, n_keys = load_state(c, path)
        assert n_nodes >= 1 and n_keys >= 1
        vals = c.get_sync(key, timeout=WAIT)
        assert any(v.data == b"persisted" for v in vals)
    finally:
        a.join()
        b.join()
        if c is not None:
            c.join()


def test_arg_parser_defaults():
    args = make_arg_parser("t").parse_args([])
    assert args.port == 0 and args.bootstrap == "" and not args.identity
    assert args.cpu is False and not hasattr(args, "tpu")
    args = make_arg_parser("t").parse_args(
        ["-p", "4222", "-b", "h:1", "-i", "--proxyserver", "8080", "--cpu"])
    assert (args.port, args.bootstrap, args.identity, args.proxyserver,
            args.cpu) == (4222, "h:1", True, 8080, True)


def test_setup_node_needs_the_card_without_cpu(monkeypatch):
    """The port's tools default to the card: without one, and without
    ``--cpu``, ``setup_node`` raises before a runner binds a socket; with
    ``--cpu`` it runs the node on the host."""
    import opendht_tpu_torch.tools.common as common
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(common.DhtRunner, "run",
                        lambda self, *a, **k: ran.append(k))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_node(make_arg_parser("t").parse_args([]))
    assert ran == []
    setup_node(make_arg_parser("t").parse_args(["--cpu"]))
    assert ran == [{"device": "cpu"}]


# --------------------------------------------- tests/test_cli_repl.py's
def _warm(w, r, WVal, RHash, WHash, tag) -> None:
    """An unchecked first exchange of the REPL's ops on keys of their
    own: put / get both ways, a listen and its push, a signed put."""
    heard = []
    with contextlib.suppress(Exception):
        w.put_sync(WHash.get("warm-" + tag), WVal(b"warm"), timeout=WAIT)
        r.get_sync(RHash.get("warm-" + tag), timeout=WAIT)
        r.listen(RHash.get("warm-l-" + tag), lambda vals, expired:
                 heard.extend(vals) or True).result(WAIT)
        w.put_sync(WHash.get("warm-l-" + tag), WVal(b"warm"), timeout=WAIT)
        wait_for(lambda: heard)
        done = []
        w.put_signed(WHash.get("warm-s-" + tag), WVal(b"warm"),
                     lambda ok, ns: done.append(ok))
        wait_for(lambda: done)


@pytest.fixture(scope="module")
def net():
    """peer ↔ node, both with identities (for the s / e ops)."""
    ident_a = crypto.generate_identity("repl-peer", key_length=1024)
    ident_b = crypto.generate_identity("repl-node", key_length=1024)
    peer, node = DhtRunner(), DhtRunner()
    try:
        peer.run(0, RunnerConfig(dht_config=Config(), identity=ident_a),
                 **CPU)
        node.run(0, RunnerConfig(dht_config=Config(), identity=ident_b),
                 **CPU)
        node.bootstrap("127.0.0.1", peer.get_bound_port())
        assert wait_for(lambda: connected(peer, node))
        _warm(node, peer, Value, InfoHash, InfoHash, "port-a")
        _warm(peer, node, Value, InfoHash, InfoHash, "port-b")
        yield peer, node
    finally:
        peer.join()
        node.join()


def repl(node, script, monkeypatch, loop=cmd_loop):
    """Run a cmd_loop over ``script``'s lines; its stdout."""
    lines = iter(script)

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loop(node, None)
    return out.getvalue()


def test_repl_core_ops(net, monkeypatch):
    peer, node = net
    out = repl(node, ["h", "info", "p repl-key hello from repl",
                      "g repl-key", "pp perm-key permanent payload",
                      "s signed-key signed payload",
                      "q? repl-key select id", "ll", "cc", "bogus-op",
                      "g", "x"], monkeypatch)
    assert "Put: True" in out
    assert "hello from repl" in out and re.search(r"Get: \d+ value", out)
    assert "PutSigned: True" in out
    assert "Node id:" in out or "id:" in out
    assert "connectivity change signalled" in out
    assert "unknown op 'bogus-op'" in out
    assert "missing argument" in out
    assert "Put: True (id " in out
    assert "opendht_tpu_torch.perf_gate" in out        # the help text
    vid = re.findall(r"Put: True \(id ([0-9a-f]+)\)", out)[-1]
    out2 = repl(node, ["cpp perm-key %s" % vid, "x"], monkeypatch)
    assert "cancelled" in out2


def test_repl_listen_and_cancel(net, monkeypatch):
    peer, node = net
    out = repl(node, ["l listen-key", "x"], monkeypatch)
    m = re.search(r"listening, token (\d+)", out)
    assert m, out
    assert peer.put_sync(InfoHash.get("listen-key"), Value(b"heard"),
                         timeout=WAIT)
    out2 = repl(node, ["cl %s" % m.group(1), "x"], monkeypatch)
    # the token map is per cmd_loop call: a fresh session reports the
    # friendly error rather than cancelling
    assert "error" in out2 or "cancelled" in out2


def test_repl_encrypted_put(net, monkeypatch):
    peer, node = net
    my_id = node.get_id().hex()
    out = repl(node, ["e enc-key %s secret text" % my_id, "x"], monkeypatch)
    assert "PutEncrypted: True" in out, out


def test_repl_index_ops(net, monkeypatch):
    peer, node = net
    out = repl(node, ["il myindex somefield 7", "ii myindex somefield",
                      "x"], monkeypatch)
    assert "Index insert: True" in out, out
    assert "Lookup: True" in out, out
    assert "index values: [(%r, 7)]" % node.get_node_id() in out, out


def test_repl_proxy_ops(net, monkeypatch):
    peer, node = net
    from opendht_tpu_torch.proxy import DhtProxyServer
    server = DhtProxyServer(peer, port=0)
    try:
        out = repl(node, ["stt 0", "stp", "pst 127.0.0.1:%d" % server.port,
                          "p via-proxy proxied payload", "g via-proxy",
                          "psp", "x"], monkeypatch)
        assert re.search(r"proxy server on port \d+", out)
        assert "proxy server stopped" in out
        assert "backend switched to proxy" in out
        assert "Put: True" in out
        assert "proxied payload" in out
        assert "backend switched to UDP" in out
        assert wait_for(lambda: not node.use_proxy)
    finally:
        server.stop()


def test_repl_ingest_state(net, monkeypatch):
    peer, node = net
    out = repl(node, ["p ingest-repl-key some value", "ingest", "x"],
               monkeypatch)
    assert "batching on" in out
    assert re.search(r"queue \d+/\d+", out)
    assert re.search(r"waves \d+  occupancy mean", out)
    assert re.search(r"time-in-queue p50 .* sheds \d+", out)


def test_repl_cache_state(net, monkeypatch):
    peer, node = net
    out = repl(node, ["cache", "cache json", "x"], monkeypatch)
    assert re.search(r"occupancy \d+/\d+  hit ratio", out)
    assert re.search(r"replica k 8->16 on \d+ hot key\(s\)", out)
    assert '"enabled": true' in out


def test_repl_log_toggle(net, monkeypatch):
    peer, node = net
    out = repl(node, ["log", "log off", "x"], monkeypatch)
    assert "logging on" in out and "logging off" in out


def test_dhtchat_mainline(net, monkeypatch):
    peer, node = net
    from opendht_tpu_torch.tools import dhtchat
    heard = []
    room = InfoHash.get("room:testroom")
    peer.listen(room, lambda vals, expired: heard.extend(
        v for v in vals if not expired) or True).result(WAIT)
    lines = ["hello over dht"]

    def fake_input(prompt=""):
        if lines:
            return lines.pop(0)
        # the signed put announces before the empty line quits (main
        # joins the node right after it)
        wait_for(lambda: any(b"hello over dht" in v.data for v in heard))
        return ""

    monkeypatch.setattr(builtins, "input", fake_input)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dhtchat.main(["--cpu", "-b",
                           "127.0.0.1:%d" % peer.get_bound_port(),
                           "testroom"])
    assert rc == 0
    assert "Joined room testroom" in out.getvalue()
    assert wait_for(lambda: any(b"hello over dht" in v.data for v in heard
                                if not v.is_encrypted())), heard


def test_dhtscanner_mainline(net, monkeypatch):
    peer, node = net
    from opendht_tpu_torch.tools import dhtscanner
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dhtscanner.main(["--cpu", "-b",
                              "127.0.0.1:%d" % peer.get_bound_port(),
                              "--rounds", "2"])
    assert rc == 0
    text = out.getvalue()
    assert "nodes discovered" in text
    assert "network size estimation" in text


# ------------------------------------- tests/test_compat_check.py's case
def test_compat_check_against_own_node():
    from opendht_tpu_torch.tools.compat_check import N_CHECKS, run_checks
    runner = DhtRunner()
    runner.run(0, **CPU)
    try:
        results = run_checks("127.0.0.1", runner.get_bound_port(),
                             verbose=False)
    finally:
        runner.shutdown()
        runner.join()
    failed = [(n, d) for n, ok, d in results if not ok]
    assert len(results) == N_CHECKS == 12 and not failed, failed


def test_compat_check_self_test_cli(capsys):
    from opendht_tpu_torch.tools import compat_check
    assert compat_check.main(["--self-test", "--cpu"]) == 0
    assert "%d/%d checks passed" % (compat_check.N_CHECKS,
                                    compat_check.N_CHECKS) in \
        capsys.readouterr().out


# -------------------------------------------------- the port's surfaces
def own_registry(monkeypatch):
    """A registry of the test's own for the ledger's ``dht_kernel_*``
    gauges: exported gauges outlive the ledger's ``clear()``, and other
    test files hold the process registry free of them."""
    reg = telemetry.MetricsRegistry()
    monkeypatch.setattr(telemetry, "get_registry", lambda: reg)
    return reg


def test_kernels_command_prints_the_port_ledger(net, monkeypatch):
    """``kernels`` computes the port's ledger on the node's device (the
    CPU here): one line per spec of the 16, with the dispatched ops the
    budgets hold, and a footer naming the port's gate; ``stats`` then
    carries the ``dht_kernel_*`` gauges."""
    import json as _json
    from opendht_tpu_torch import perf_gate
    peer, node = net
    own_registry(monkeypatch)
    led = profiling.get_ledger()
    try:
        out = repl(node, ["kernels", "stats", "x"], monkeypatch)
        budgets = _json.load(open(perf_gate.BUDGETS))["kernels"]
        assert len(budgets) == 16
        for name, b in budgets.items():
            m = re.search(r"^%s\s+(\d+)\s" % name, out, re.M)
            assert m, (name, out[:2000])
            assert int(m.group(1)) == b["launches"]
        assert "16 kernels on cpu; budgets gated by python -m " \
            "opendht_tpu_torch.perf_gate" in out
        assert "ci/perf_gate" not in out
        # `stats` prints get_metrics(): the ledger's gauges are in it
        stats = _json.loads(out[out.index("{"):out.rindex("}") + 1])
        for name, b in budgets.items():
            assert stats["gauges"]['dht_kernel_launches{kernel="%s"}'
                                   % name] == b["launches"]
    finally:
        led.clear()


def test_dhtscanner_json_fills_kernels_and_waterfall(net, monkeypatch):
    peer, node = net
    own_registry(monkeypatch)
    from opendht_tpu_torch.tools import dhtscanner
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = dhtscanner.main(["--cpu", "--json", "--kernels", "-b",
                                  "127.0.0.1:%d" % peer.get_bound_port(),
                                  "--rounds", "2"])
    finally:
        profiling.get_ledger().clear()
    assert rc == 0
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    snap = doc["snapshot"]
    assert len(snap["kernels"]) == 16
    assert all(e["platform"] == "cpu" and e["launches"] > 0
               for e in snap["kernels"].values())
    ob = snap["waterfall"]["open_bounds"]
    assert (ob["platform"], ob["status"]) == ("cpu", "unsettled")
    assert doc["discovered"]


# ------------------------------------------ one REPL script, two packages
_MASKS = [(re.compile(r"\b[0-9a-f]{40}\b"), "<hash>"),
          (re.compile(r"\(id [0-9a-f]+\)"), "(id <vid>)"),
          (re.compile(r"Value\[id:[0-9a-f]+"), "Value[id:<vid>"),
          (re.compile(r"in \d+\.\d+s"), "in <t>s"),
          (re.compile(r"port \d+"), "port <n>"),
          (re.compile(r"token \d+"), "token <n>")]

# the index ops stay out: their dozens of DHT ops a command make the JAX
# pair's output depend on a loaded host (tests/test_cli_repl.py's
# test_repl_index_ops, ROADMAP C.3); test_repl_index_ops above and
# tests/test_torch_pht.py hold the port's
TWIN_SCRIPT = ["p twin-key twin payload", "g twin-key",
               "pp twin-perm permanent twin", "g twin-perm",
               "s twin-signed signed twin", "g twin-signed",
               "l twin-listen", "bogus-op", "g", "cl 999", "log", "log off",
               "stt 0", "stp", "x"]


def _masked(text: str) -> list:
    for rx, sub in _MASKS:
        text = rx.sub(sub, text)
    return text.splitlines()


def test_the_same_repl_script_prints_the_same_on_both_packages(
        net, monkeypatch):
    import opendht_tpu.runtime.runner as jrunner
    from opendht_tpu import crypto as jcrypto
    from opendht_tpu.core.value import Value as JValue
    from opendht_tpu.infohash import InfoHash as JHash
    from opendht_tpu.runtime.config import Config as JConfig
    from opendht_tpu.tools.dhtnode import cmd_loop as jcmd_loop
    monkeypatch.setattr(jrunner, "RX_QUEUE_MAX_DELAY", 60.0)
    peer, node = net
    port_out = _masked(repl(node, TWIN_SCRIPT, monkeypatch))
    jpeer, jnode = jrunner.DhtRunner(), jrunner.DhtRunner()
    try:
        for r, name in ((jpeer, "twin-peer"), (jnode, "twin-node")):
            r.run(0, jrunner.RunnerConfig(
                dht_config=JConfig(), identity=jcrypto.generate_identity(
                    name, key_length=1024)))
        jnode.bootstrap("127.0.0.1", jpeer.get_bound_port())
        assert wait_for(lambda: connected(jpeer, jnode))
        _warm(jnode, jpeer, JValue, JHash, JHash, "jax-a")
        jax_out = _masked(repl(jnode, TWIN_SCRIPT, monkeypatch,
                               loop=jcmd_loop))
    finally:
        jpeer.join()
        jnode.join()
    assert port_out == jax_out
    assert sum(l.startswith("Put: True") for l in port_out) == 2
    assert "PutSigned: True" in port_out
