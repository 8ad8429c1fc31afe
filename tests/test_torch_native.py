"""The port's native C++ engine (``opendht_tpu_torch.native``): the same
sources as the JAX package's, built by the port's own race-free build.

- The scalar XOR helpers against the port's Python ``InfoHash`` and the
  JAX package's; the sorted outward walk against the full scan, the
  port's torch ``xor_topk`` and an adversarially clustered table.
- The UDP engine over loopback: round trip, batch poll, rate limits and
  the loopback exemption, v6 and dual stack.
- Six processes building into one empty directory at once all load a
  whole library.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from opendht_tpu.infohash import InfoHash as JHash
from opendht_tpu_torch import native
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.native import build
from opendht_tpu_torch.ops import ids as IK
from opendht_tpu_torch.ops.xor_topk import xor_topk

REPO = Path(__file__).resolve().parents[1]


def _rand_ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 20),
                                                dtype=np.uint8)


def test_the_library_builds_into_the_ports_build_dir():
    assert native.available()
    path = build.library_path()
    assert path.is_file()
    assert path.parent == REPO / "build" / "opendht_tpu_torch"
    assert not list(path.parent.glob("*.so.tmp"))


# ------------------------------------------------------------ scalar parity
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_xor_cmp_matches_both_python_versions(seed):
    ids = _rand_ids(64, seed)
    ids[40:44, :12] = ids[39, :12]        # long shared prefixes too
    s = bytes(ids[0])
    for i in range(1, 63):
        a, b = bytes(ids[i]), bytes(ids[i + 1])
        want = InfoHash(s).xor_cmp(InfoHash(a), InfoHash(b))
        assert want == JHash(s).xor_cmp(JHash(a), JHash(b))
        assert native.xor_cmp(s, a, b) == want
    assert native.xor_cmp(s, bytes(ids[5]), bytes(ids[5])) == 0


@pytest.mark.parametrize("seed", [4, 5])
def test_common_bits_matches_both_python_versions(seed):
    ids = _rand_ids(32, seed)
    ids[10:14, :9] = ids[9, :9]
    for i in range(31):
        a, b = bytes(ids[i]), bytes(ids[i + 1])
        want = InfoHash.common_bits(InfoHash(a), InfoHash(b))
        assert want == JHash.common_bits(JHash(a), JHash(b))
        assert native.common_bits(a, b) == want
    assert native.common_bits(bytes(ids[0]), bytes(ids[0])) == 160


# ------------------------------------------------------------- table lookup
def _walk_rows(ids, queries, k=8, window=64):
    sorted_ids, perm = native.sort_ids(ids)
    walk = native.sorted_closest(sorted_ids, queries, k=k, window=window)
    return np.where(walk >= 0, perm[np.clip(walk, 0, None)], -1)


def test_sort_ids_is_lexicographic():
    ids = _rand_ids(400, 6)
    s, perm = native.sort_ids(ids)
    order = np.lexsort(ids.T[::-1])
    assert np.array_equal(s, ids[order]) and np.array_equal(perm, order)


@pytest.mark.parametrize("n,k", [(500, 8), (300, 14), (64, 16)])
def test_sorted_walk_equals_the_scan_and_torch_xor_topk(n, k):
    ids = _rand_ids(n, 7 + n)
    queries = _rand_ids(40, 8 + n)
    rows = _walk_rows(ids, queries, k=k)
    assert np.array_equal(rows, native.scan_closest(ids, queries, k=k))
    _, idx = xor_topk(IK.to_keys(IK.ids_from_bytes(queries), "cpu"),
                      IK.to_keys(IK.ids_from_bytes(ids), "cpu"), k=k)
    assert np.array_equal(rows, idx.numpy())


def test_clustered_table_falls_back_to_the_exact_scan():
    ids = _rand_ids(300, 9)
    ids[:200, :6] = 0xAB
    queries = _rand_ids(25, 10)
    queries[:10, :6] = 0xAB
    rows = _walk_rows(ids, queries, window=16)
    scan = native.scan_closest(ids, queries, k=8)

    def dists(rr, q):
        return sorted(bytes(a ^ b for a, b in zip(ids[i], queries[q]))
                      for i in rr)
    for q in range(len(queries)):
        assert dists(rows[q], q) == dists(scan[q], q)


def test_small_table_pads_with_minus_one():
    sorted_ids, _ = native.sort_ids(_rand_ids(3, 11))
    out = native.sorted_closest(sorted_ids, _rand_ids(2, 12), k=8)
    assert (out[:, :3] >= 0).all() and (out[:, 3:] == -1).all()


def test_helpers_raise_without_the_library(monkeypatch):
    from opendht_tpu_torch.native import wrappers
    monkeypatch.setattr(wrappers, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        wrappers.common_bits(b"\0" * 20, b"\0" * 20)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        wrappers.UdpEngine(0)


# --------------------------------------------------------------- UDP engine
def _drain(engine, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    got = []
    while len(got) < n and time.monotonic() < deadline:
        if engine.wait(0.05):
            got.extend(engine.poll(max_pkts=64))
    return got


def test_udp_loopback_roundtrip():
    with native.UdpEngine(0) as a, native.UdpEngine(0) as b:
        assert a.port > 0 and b.port > 0 and a.port != b.port
        assert a.send(b"ping-payload", ("127.0.0.1", b.port)) == 0
        pkts = _drain(b, 1)
        assert pkts, "packet never arrived"
        rx_time, data, (host, port) = pkts[0]
        assert data == b"ping-payload"
        assert (host, port) == ("127.0.0.1", a.port) and rx_time > 0
        assert b.send(b"pong", (host, port)) == 0
        assert [p[1] for p in _drain(a, 1)] == [b"pong"]
        st = b.stats()
        assert st["rx"] == 1 and st["tx"] == 1 and st["queued"] == 0


@pytest.mark.parametrize("n", [20, 120])
def test_udp_batch_poll_keeps_order(n):
    with native.UdpEngine(0) as a, native.UdpEngine(0) as b:
        for i in range(n):
            a.send(("msg-%04d" % i).encode(), ("127.0.0.1", b.port))
        got = _drain(b, n)
        assert [p[1] for p in got] == \
            [("msg-%04d" % i).encode() for i in range(n)]
        assert b.stats()["rx"] == n


def test_udp_rate_limit_drops():
    with native.UdpEngine(0) as a, \
            native.UdpEngine(0, per_ip_rps=10, global_rps=10,
                             exempt_loopback=False) as b:
        for i in range(50):
            a.send(b"x%d" % i, ("127.0.0.1", b.port))
        time.sleep(0.5)
        got = len(b.poll(max_pkts=100))
        assert got <= 10
        assert b.stats()["dropped_rate"] >= 30


@pytest.mark.parametrize("host", ["127.0.0.1", "::1"])
def test_udp_loopback_is_exempt_from_limits(host):
    with native.UdpEngine(0) as a, \
            native.UdpEngine(0, per_ip_rps=5, global_rps=5) as b:
        if ":" in host and not (a.has_v6 and b.has_v6):
            pytest.skip("no IPv6 on this host")
        for i in range(40):
            a.send(b"y%d" % i, (host, b.port))
        assert len(_drain(b, 40)) == 40
        assert b.stats()["dropped_rate"] == 0


def test_udp_dual_stack_on_one_port_and_v6_off():
    with native.UdpEngine(0) as a, native.UdpEngine(0) as b:
        if not (a.has_v6 and b.has_v6):
            pytest.skip("no IPv6 on this host")
        a.send(b"via four", ("127.0.0.1", b.port))
        a.send(b"via six", ("::1", b.port))
        got = _drain(b, 2)
        assert {p[1] for p in got} == {b"via four", b"via six"}
        assert {(":" in p[2][0]) for p in got} == {True, False}
    with native.UdpEngine(0, ipv6=False) as e:
        assert not e.has_v6
        assert e.send(b"x", ("::1", 1)) != 0


# ------------------------------------------------------------------ build
_BUILD_ONE = """
import sys
from pathlib import Path
from opendht_tpu_torch.native import build
p = build.build(Path(sys.argv[1]))
lib = build.load(p)
print(p.name, lib.dht_common_bits((build.ctypes.c_uint8 * 20)(),
                                  (build.ctypes.c_uint8 * 20)()))
"""


def test_six_processes_build_into_one_empty_directory(tmp_path):
    out = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(out)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = []
    for p in procs:
        o, e = p.communicate(timeout=300)
        results.append((p.returncode, o.strip(), e[-500:]))
    name = build.library_path(out).name
    assert results == [(0, f"{name} 160", "")] * 6
    assert [f.name for f in out.iterdir()] == [name]
