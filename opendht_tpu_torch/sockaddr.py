"""Socket address wrapper (reference include/opendht/sockaddr.h).

A copy of the JAX package's ``sockaddr.py`` with its behaviour unchanged.

A small immutable (ip, port, family) value object built on the stdlib
``ipaddress`` module instead of raw ``sockaddr_storage``: family/port
accessors, ``resolve()`` via getaddrinfo (sockaddr.h:91), loopback /
private-range predicates (sockaddr.h:219-224), an ``ip_cmp`` comparator
that ignores the port (sockaddr.h:235), and the compact wire form
(4B/16B address ‖ 2B big-endian port) used in node blobs
(src/network_engine.cpp:1002-1050).
"""

from __future__ import annotations

import ipaddress
import socket
from functools import total_ordering
from typing import Iterable


@total_ordering
class SockAddr:
    __slots__ = ("_ip", "_port")

    def __init__(self, host: "str | bytes | ipaddress._BaseAddress | None" = None,
                 port: int = 0):
        if host is None or host == "":
            self._ip = None
        elif isinstance(host, (bytes, bytearray, memoryview)):
            self._ip = ipaddress.ip_address(bytes(host))
        elif isinstance(host, (ipaddress.IPv4Address, ipaddress.IPv6Address)):
            self._ip = host
        else:
            self._ip = ipaddress.ip_address(host)
        self._port = int(port)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_tuple(cls, addr: tuple) -> "SockAddr":
        """From an asyncio/socket address tuple (host, port[, flow, scope])."""
        return cls(addr[0], addr[1])

    @classmethod
    def resolve(cls, host: str, service: "str | int | None" = None) -> "list[SockAddr]":
        """All addresses of host:service via getaddrinfo (sockaddr.h:91)."""
        port = int(service) if service not in (None, "") else 0
        out, seen = [], set()
        for *_, sockaddr in socket.getaddrinfo(
                host, port or None, proto=socket.IPPROTO_UDP):
            sa = cls(sockaddr[0], sockaddr[1] or port)
            key = (sa._ip, sa._port)
            if key not in seen:
                seen.add(key)
                out.append(sa)
        return out

    # -- accessors ---------------------------------------------------------
    @property
    def family(self) -> int:
        """AF_INET / AF_INET6 / AF_UNSPEC(0) (sockaddr.h:150-158)."""
        if self._ip is None:
            return socket.AF_UNSPEC
        return socket.AF_INET if self._ip.version == 4 else socket.AF_INET6

    @property
    def port(self) -> int:
        return self._port

    @property
    def host(self) -> str:
        return str(self._ip) if self._ip is not None else ""

    @property
    def ip(self):
        return self._ip

    def with_port(self, port: int) -> "SockAddr":
        return SockAddr(self._ip, port)

    def __bool__(self) -> bool:
        return self._ip is not None

    # -- predicates (sockaddr.h:219-224) -----------------------------------
    def is_loopback(self) -> bool:
        return self._ip is not None and self._ip.is_loopback

    def is_private(self) -> bool:
        """RFC1918/link-local — used by the martian filter."""
        return self._ip is not None and (self._ip.is_private or self._ip.is_link_local)

    def is_unspecified(self) -> bool:
        return self._ip is None or self._ip.is_unspecified

    def is_multicast(self) -> bool:
        return self._ip is not None and self._ip.is_multicast

    def is_global(self) -> bool:
        return self._ip is not None and self._ip.is_global

    # -- ordering / equality ----------------------------------------------
    def _key(self):
        ip = self._ip
        return (0 if ip is None else ip.version,
                b"" if ip is None else ip.packed,
                self._port)

    def __eq__(self, other) -> bool:
        return isinstance(other, SockAddr) and self._key() == other._key()

    def __lt__(self, other) -> bool:
        return self._key() < other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def ip_cmp(self, other: "SockAddr") -> int:
        """Compare addresses ignoring ports (sockaddr.h:235)."""
        a, b = self._key()[:2], other._key()[:2]
        return -1 if a < b else (1 if a > b else 0)

    def same_ip(self, other: "SockAddr") -> bool:
        return self.ip_cmp(other) == 0

    # -- conversions -------------------------------------------------------
    def to_tuple(self) -> tuple:
        """(host, port) for sendto / asyncio."""
        return (self.host, self._port)

    def to_compact(self) -> bytes:
        """Compact wire form: packed address ‖ 2B big-endian port — the
        payload of n4/n6 node blobs and the 'sa' echo
        (network_engine.cpp:636-645, 1002-1050)."""
        if self._ip is None:
            return b""
        return self._ip.packed + self._port.to_bytes(2, "big")

    @classmethod
    def from_compact(cls, data: bytes) -> "SockAddr":
        if len(data) == 6:
            return cls(bytes(data[:4]), int.from_bytes(data[4:6], "big"))
        if len(data) == 18:
            return cls(bytes(data[:16]), int.from_bytes(data[16:18], "big"))
        raise ValueError(f"bad compact sockaddr length {len(data)}")

    def __repr__(self) -> str:
        if self._ip is None:
            return "SockAddr()"
        if self._ip.version == 6:
            return f"[{self.host}]:{self._port}"
        return f"{self.host}:{self._port}"

    def toString(self) -> str:  # reference-style alias
        return repr(self)


def match_family(addrs: Iterable[SockAddr], family: int) -> "list[SockAddr]":
    return [a for a in addrs if a.family == family]
