"""The port's subprocess cluster (``testing/subproc_cluster.py``) against
the JAX package's, on the CPU.

- Both cases of tests/test_subproc_cluster.py on both packages (the JAX
  file executed as written, then with its imports read as the port's,
  the port's default device read as the CPU): both pass the case's
  assertions and make the same calls into the parent side, each
  returning the same type of result.  The kill
  scenario keeps the JAX file's ``slow`` mark.
- A port child driven by frames the ``msgpack`` wheel packed, its
  replies read by the wheel's ``Unpacker(raw=True)``: every op of the
  protocol, and a child asked for the card on this host failing every
  op but ``quit`` with "no CUDA device".
- A child whose code prints to stdout and writes to fd 1 after start-up
  still writes nothing to fd 1 but its frames.
- Wire parity across packages: a JAX ``ClusterSubProcess`` and a port
  one bootstrapped together, a put through each got back through the
  other.

Each real-UDP case gives its children a 120 s RPC limit and its
processes a wait of their own.
"""

from __future__ import annotations

import subprocess

import msgpack
import pytest
import torch

from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.testing import subproc_cluster as SC
from test_torch_cluster_tools import run_case_twins

CHILD_WAIT = 120.0
PARENT_FILES = ("testing/subproc_cluster.py",)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ------------------------------ tests/test_subproc_cluster.py, both packages
@pytest.mark.parametrize("name", [
    "test_rpc_roundtrip_and_put_get_across_process",
    pytest.param("test_values_survive_killing_whole_child_cluster",
                 marks=pytest.mark.slow)])
def test_subproc_case_twin(name, monkeypatch):
    jax_rec, port_rec = run_case_twins("test_subproc_cluster.py", name,
                                       monkeypatch, files=PARENT_FILES)
    assert ("ClusterSubProcess.put", True) in jax_rec["calls"]
    assert port_rec["calls"] == jax_rec["calls"]


# ------------------------------------------ frames the wheel packed and reads
def _child(device: str, noise: str = ""):
    """A child on ``device``; ``noise`` runs right after its boot line has
    set fd 1 aside."""
    argv = SC.child_argv(device)
    mark = "os.dup2(2, 1); "
    assert mark in argv[2]
    argv[2] = argv[2].replace(mark, mark + noise)
    return subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=SC.child_env())


def _wheel_session(proc, requests: list) -> tuple:
    """Send every request packed by the wheel, close stdin; the replies
    the wheel reads from the child's whole stdout, the bytes left over,
    and the child's stderr."""
    data = b"".join(msgpack.packb(r, use_bin_type=True) for r in requests)
    out, err = proc.communicate(data, timeout=CHILD_WAIT)
    up = msgpack.Unpacker(raw=True)
    up.feed(out)
    replies = [{k.decode(): v for k, v in m.items()} for m in up]
    return replies, len(out) - up.tell(), err


def test_port_child_answers_the_wheels_frames():
    key = bytes(InfoHash.get("wheel-frames"))
    proc = _child("cpu")
    replies, left, _ = _wheel_session(proc, [
        {"op": "launch", "n": 3}, {"op": "ids"},
        {"op": "put", "key": key, "value": b"from the wheel"},
        {"op": "get", "key": key}, {"op": "stats"},
        {"op": "resize", "n": 2}, {"op": "nope"}, {"op": "quit"}])
    assert proc.returncode == 0 and left == 0
    launch, ids, put, get, stats, resize, nope, quit_ = replies
    assert launch["ok"] and len(launch["ports"]) == 3
    assert ids == {"ok": True, "ids": launch["ids"]}
    assert all(isinstance(i, bytes) and len(i) == 20 for i in ids["ids"])
    assert put == {"ok": True, "stored": True}
    assert get == {"ok": True, "values": [b"from the wheel"]}
    assert stats["ok"] and stats["n"] == 3 and stats["msgs"] > 0
    assert resize == {"ok": True, "n": 2}
    assert nope == {"ok": False, "error": b"unknown op 'nope'"}
    assert quit_ == {"ok": True}


def test_card_child_without_a_card_fails_every_op_but_quit():
    """Asked for the card on a host without one, the child never falls
    back to the CPU: it answers each op with the RuntimeError and exits
    cleanly on quit, having bound no node."""
    proc = _child("cuda")
    replies, left, _ = _wheel_session(proc, [
        {"op": "launch", "n": 2}, {"op": "ids"}, {"op": "quit"}])
    assert proc.returncode == 0 and left == 0
    assert [r["ok"] for r in replies] == [False, False, True]
    for r in replies[:2]:
        assert b"no CUDA device" in r["error"]


def test_parent_raises_what_the_card_child_reports(monkeypatch):
    """The parent of a card child raises the child's error (and leaves no
    child behind) when the host has no card: here the parent is let past
    its own check so that the child's is the one that fires."""
    spawned = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        spawned.append(real_popen(*a, **kw))
        return spawned[-1]
    monkeypatch.setattr(SC, "resolve_device", lambda d=None: torch.device(
        "cuda" if d is None else d))
    monkeypatch.setattr(SC, "_prebuild", lambda dev: None)
    monkeypatch.setattr(SC.subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SC.ClusterSubProcess(2, timeout=CHILD_WAIT)
    assert len(spawned) == 1 and spawned[0].poll() is not None


def test_child_writes_nothing_to_fd1_but_frames():
    """Code in the child that prints, writes to fd 1 and warns after the
    boot line has set fd 1 aside: all of it lands on stderr, and the
    wheel reads the child's stdout as whole frames with nothing left."""
    noise = ("import atexit, os, threading, warnings; "
             "atexit.register(print, 'noise at exit'); "
             "atexit.register(os.write, 1, b'raw noise at exit'); "
             "threading.Thread(target=print, args=('noise from a thread',))"
             ".start(); "
             "warnings.warn('noise warning'); ")
    proc = _child("cpu", noise)
    replies, left, err = _wheel_session(proc, [
        {"op": "launch", "n": 1}, {"op": "quit"}])
    assert proc.returncode == 0 and left == 0
    assert [r["ok"] for r in replies] == [True, True]
    for text in (b"noise at exit", b"raw noise at exit",
                 b"noise from a thread"):
        assert text in err


# -------------------------------------------- JAX and port children together
def test_jax_and_port_children_share_one_dht():
    from opendht_tpu.testing.subproc_cluster import \
        ClusterSubProcess as JaxCluster
    with JaxCluster(3, timeout=CHILD_WAIT) as j, \
            SC.ClusterSubProcess(3, timeout=CHILD_WAIT, device="cpu") as p:
        p.bootstrap("127.0.0.1", j.ports[0])
        k1 = bytes(InfoHash.get("put through the JAX child"))
        k2 = bytes(InfoHash.get("put through the port child"))
        assert j.put(k1, b"jax value")
        assert p.put(k2, b"port value")
        assert p.get(k1) == [b"jax value"]
        assert j.get(k2) == [b"port value"]
        ids = set(j.node_ids()) | set(p.node_ids())
        assert len(ids) == 6
