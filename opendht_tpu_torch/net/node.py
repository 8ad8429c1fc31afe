"""Remote-peer state (reference include/opendht/node.h, src/node.cpp).

A copy of the JAX package's ``net/node.py`` with its behaviour unchanged.

A :class:`Node` tracks one remote peer: address, last-heard/last-reply
times, liveness classification (good / old / expired), auth-error
strikes, the per-node in-flight request map, listen push sockets, and
the transaction-id generator."""

from __future__ import annotations

import random
from typing import TYPE_CHECKING, Callable, Dict, Optional

from ..infohash import InfoHash
from ..sockaddr import SockAddr

if TYPE_CHECKING:
    from .request import Request
    from .parsed_message import ParsedMessage

NODE_GOOD_TIME = 120 * 60.0      # node.h:148: replied within 2 h
NODE_EXPIRE_TIME = 10 * 60.0     # node.h:151: heard within 10 min
MAX_RESPONSE_TIME = 1.0          # node.h:154: per-attempt timeout
MAX_AUTH_ERRORS = 3              # node.h:158

#: cb(node, parsed_message) — unsolicited data on a listen socket
SocketCb = Callable[["Node", "ParsedMessage"], None]

_NEVER = float("-inf")


class Socket:
    """A per-node channel for unsolicited pushes after a listen
    (node.h:40-45)."""

    __slots__ = ("on_receive",)

    def __init__(self, on_receive: SocketCb):
        self.on_receive = on_receive


class Node:
    def __init__(self, node_id: InfoHash, addr: SockAddr, client: bool = False):
        self.id = node_id
        self.addr = addr
        self.is_client = client
        self.time = _NEVER            # last time heard about
        self.reply_time = _NEVER      # last correct reply
        self.auth_errors = 0
        self.expired = False
        # random initial tid (node.cpp:32-37)
        self._tid = random.randint(1, 0xFFFFFFFF)
        self.requests: Dict[int, "Request"] = {}
        self.sockets: Dict[int, Socket] = {}

    # -- liveness (node.cpp:39-46, node.h:79-92) ---------------------------
    def is_good(self, now: float) -> bool:
        return (not self.expired
                and self.reply_time >= now - NODE_GOOD_TIME
                and self.time >= now - NODE_EXPIRE_TIME)

    def is_old(self, now: float) -> bool:
        return self.time + NODE_EXPIRE_TIME < now

    def is_removable(self, now: float) -> bool:
        return self.expired and self.is_old(now)

    def is_incoming(self) -> bool:
        return self.time > self.reply_time

    def is_pending(self) -> bool:
        return any(r.pending for r in self.requests.values())

    def pending_count(self) -> int:
        return sum(1 for r in self.requests.values() if r.pending)

    @property
    def family(self) -> int:
        return self.addr.family

    # -- auth strikes (node.h:73-77) ---------------------------------------
    def auth_error(self) -> None:
        self.auth_errors += 1
        if self.auth_errors > MAX_AUTH_ERRORS:
            self.set_expired()

    def auth_success(self) -> None:
        self.auth_errors = 0

    # -- request bookkeeping (node.cpp:74-115) -----------------------------
    def requested(self, req: "Request") -> None:
        old = self.requests.get(req.tid)
        if old is not None and old is not req:
            old.set_expired()
        self.requests[req.tid] = req

    def received(self, now: float, req: Optional["Request"] = None) -> None:
        """A message arrived from this node; `req` set if it answers one
        of ours."""
        self.time = now
        self.expired = False
        if req is not None:
            self.reply_time = now
            self.requests.pop(req.tid, None)

    def get_request(self, tid: int) -> Optional["Request"]:
        return self.requests.get(tid)

    def cancel_request(self, req: Optional["Request"]) -> None:
        if req is not None:
            req.cancel()
            self.close_socket(req.close_socket())
            self.requests.pop(req.tid, None)

    def set_expired(self) -> None:
        """(node.cpp:117-126)"""
        self.expired = True
        for r in list(self.requests.values()):
            r.set_expired()
        self.requests.clear()
        self.sockets.clear()

    def reset(self) -> None:
        self.expired = False
        self.reply_time = _NEVER

    def update(self, addr: SockAddr) -> None:
        self.addr = addr

    # -- tids & sockets (node.h:118-142, node.cpp:128-152) -----------------
    def get_new_tid(self) -> int:
        self._tid = (self._tid + 1) & 0xFFFFFFFF
        if self._tid == 0:
            self._tid = 1
        return self._tid

    def open_socket(self, cb: SocketCb) -> int:
        sid = self.get_new_tid()
        self.sockets[sid] = Socket(cb)
        return sid

    def get_socket(self, sid: int) -> Optional[Socket]:
        return self.sockets.get(sid)

    def close_socket(self, sid: int) -> None:
        if sid:
            self.sockets.pop(sid, None)

    def export_node(self) -> dict:
        """{id, addr} for node export/bootstrap (infohash.h:363-382)."""
        return {"id": str(self.id), "addr": self.addr.to_compact()}

    def __repr__(self) -> str:
        return f"{self.id} {self.addr!r}"
