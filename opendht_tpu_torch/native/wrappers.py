"""Pythonic wrappers over the native C ABI (see build.py); a copy of the
JAX package's ``native/wrappers.py`` with its behaviour unchanged."""

from __future__ import annotations

import ctypes
import socket
import struct
from typing import List, Optional, Tuple

import numpy as np

from .build import get_lib

_HASH_LEN = 20


def _u8(buf) -> "ctypes.POINTER(ctypes.c_uint8)":
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(bytes(buf))


def _lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native library unavailable (no C++ toolchain or build failed); "
            "check opendht_tpu_torch.native.available() before calling")
    return lib


def _rows(arr) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint8))
    if a.ndim != 2 or a.shape[1] != _HASH_LEN:
        raise ValueError("expected [N, 20] uint8 id matrix")
    return a


def xor_cmp(self_id: bytes, a: bytes, b: bytes) -> int:
    """infohash.h:179-194 semantics; requires the native lib."""
    lib = _lib()
    return lib.dht_xor_cmp(_u8(self_id), _u8(a), _u8(b))


def common_bits(a: bytes, b: bytes) -> int:
    lib = _lib()
    return lib.dht_common_bits(_u8(a), _u8(b))


def sort_ids(ids) -> Tuple[np.ndarray, np.ndarray]:
    """Lexicographic sort of an [N,20] id matrix; returns
    (sorted_ids, perm int32[N])."""
    lib = _lib()
    a = _rows(ids).copy()
    perm = np.empty(a.shape[0], dtype=np.int32)
    lib.dht_sort_ids(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a.shape[0])
    return a, perm


def sorted_closest(sorted_ids, queries, k: int = 8,
                   window: int = 64) -> np.ndarray:
    """Window-collected outward walk + exact select: the reference's
    sorted-map walk (node_cache.cpp:41-74) hardened to exact k-closest
    (window plays the same role as the device kernel's, see
    ops/sorted_table.py).  Returns int32 [Q,k] sorted-table indices,
    -1 padded."""
    lib = _lib()
    t = _rows(sorted_ids)
    q = _rows(queries)
    out = np.empty((q.shape[0], k), dtype=np.int32)
    lib.dht_sorted_closest(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t.shape[0],
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), q.shape[0],
        k, window, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def scan_closest(ids, queries, k: int = 8) -> np.ndarray:
    """Exact full-scan oracle (insertion scan), int32 [Q,k]."""
    lib = _lib()
    t = _rows(ids)
    q = _rows(queries)
    out = np.empty((q.shape[0], k), dtype=np.int32)
    lib.dht_scan_closest(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t.shape[0],
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), q.shape[0],
        k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


class UdpEngine:
    """Native dual-stack datagram engine: C++ receiver thread + ring
    buffer + ingress guards over an IPv4 and (optionally) an IPv6-only
    socket on the same port; Python drains packets in batches.

    ↔ reference rcv_thread select loop over both sockets
    (dhtrunner.cpp:511-608) and NetworkEngine ingress rate limits /
    martian filter (network_engine.h:424, network_engine.cpp:339-401).
    """

    _HDR = struct.Struct("<dB16sHH")

    def __init__(self, port: int = 0, *, ring_size: int = 16384,
                 global_rps: int = 1600, per_ip_rps: int = 200,
                 exempt_loopback: bool = True, ipv6: bool = True):
        lib = _lib()
        self._lib = lib
        self._h = lib.dht_udp_create(port, ring_size, global_rps, per_ip_rps,
                                     1 if exempt_loopback else 0,
                                     1 if ipv6 else 0)
        if not self._h:
            raise OSError("could not bind UDP port %d" % port)
        self._owned = True
        self.port = lib.dht_udp_port(self._h)
        self.has_v6 = bool(lib.dht_udp_has_v6(self._h))
        self._buf = (ctypes.c_uint8 * (64 * 1024))()
        self._nbytes = ctypes.c_uint64(0)

    def send(self, data: bytes, addr: Tuple[str, int]) -> int:
        host = addr[0]
        if ":" in host:
            packed = socket.inet_pton(socket.AF_INET6, host)
            fam = 6
        else:
            packed = socket.inet_aton(host)
            fam = 4
        return self._lib.dht_udp_send(self._h, _u8(data), len(data),
                                      _u8(packed.ljust(16, b"\0")), fam,
                                      addr[1])

    def poll(self, max_pkts: int = 256
             ) -> List[Tuple[float, bytes, Tuple[str, int]]]:
        """Drain up to max_pkts received packets as
        (rx_time, data, (host, port)) tuples; host is a textual v4 or
        v6 address."""
        out: List[Tuple[float, bytes, Tuple[str, int]]] = []
        while len(out) < max_pkts:
            n = self._lib.dht_udp_poll(
                self._h, self._buf, len(self._buf),
                max_pkts - len(out), ctypes.byref(self._nbytes))
            if n <= 0:
                break
            raw = bytes(self._buf[:self._nbytes.value])
            off = 0
            for _ in range(n):
                rx_time, fam, a16, port, ln = self._HDR.unpack_from(raw, off)
                off += self._HDR.size
                data = raw[off:off + ln]
                off += ln
                if fam == 6:
                    host = socket.inet_ntop(socket.AF_INET6, a16)
                else:
                    host = socket.inet_ntoa(a16[:4])
                out.append((rx_time, data, (host, port)))
        return out

    def pending(self) -> bool:
        return bool(self._lib.dht_udp_pending(self._h))

    def wait(self, timeout: float = 0.1) -> bool:
        """Block (GIL released) until a packet is pending or timeout;
        returns whether packets are pending."""
        return bool(self._lib.dht_udp_wait(self._h, int(timeout * 1000)))

    def stats(self) -> dict:
        s = (ctypes.c_uint64 * 6)()
        self._lib.dht_udp_stats(self._h, s)
        return {"rx": s[0], "tx": s[1], "dropped_ring": s[2],
                "dropped_rate": s[3], "dropped_martian": s[4],
                "queued": s[5]}

    def close(self) -> None:
        if self._h and self._owned:
            self._lib.dht_udp_destroy(self._h)
            self._h = None

    def detach(self) -> None:
        """Give up ownership without freeing the engine.  Used when a
        receiver thread may still be blocked inside wait()/poll(): a
        destroy would free the Engine under that thread (use-after-free),
        so the owner deliberately leaks it.  ``_h`` stays valid — the
        stuck thread may still be dereferencing it — only the ownership
        flag flips, so close()/__del__ become no-ops."""
        self._owned = False

    def __enter__(self) -> "UdpEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
