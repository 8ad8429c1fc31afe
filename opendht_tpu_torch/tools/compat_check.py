"""Wire-compatibility checker against a LIVE node ("keep the interop
door cheap").

Points the scripted golden exchanges at a real ``host:port`` over UDP
and reports pass/fail per check.  Against the port's own ``dhtnode``
this is a live self-test (``--self-test`` spins one up in-process, on
the CUDA card unless ``--cpu``); against a reference C++ dhtnode
(reference tools/dhtnode.cpp:104-460), the SURVEY §7 stage-4
acceptance is::

    python -m opendht_tpu_torch.tools.compat_check <host> <port>

The port's copy of the JAX package's ``tools/compat_check.py``, its
exchanges unchanged, over the port's own wire engine and codec.

Checks (requester side of the reference wire format,
reference src/network_engine.cpp:677-1305):

1. ping        → reply with the peer's 20-byte id, tid matched
2. find_node   → compact n4 node blob (26 B triples)
3. get         → write token issued (+ closest nodes)
4. listen      → listen confirmation on a fresh socket id
5. put         → value-announced ack echoing the value id
6. get (again) → the stored value round-trips bit-exact
7. put >600 B  → fragmented announce (value parts) acked
8. get (big)   → fragmented values reassembled bit-exact
9. put w/ forged token → protocol error 401 (UNAUTHORIZED)
10. refresh unknown vid → protocol error 404 (NOT_FOUND)
11. traced ping → a query carrying the ``tr`` trace-context key is
    answered like any untraced one (wire compat; the first
    10 checks send NO ``tr``, so they double as the pre-trace-peer →
    tracing-peer direction)
12. unknown-keys ping → a raw packet with hostile unknown top-level
    keys (including an oversized fake trace blob) still gets a reply,
    and the reply echoes none of the unknown bytes

Every check is also a behavioral assertion from the conversation-golden
tier (tests/test_wire_conversations.py) — this tool is those flows
unfrozen and aimed at a socket.
"""

from __future__ import annotations

import argparse
import secrets
import select
import socket
import sys
import time

from .. import tracing
from ..core.value import Query, Value
from ..infohash import InfoHash
from ..net.engine import (DhtProtocolException, EngineCallbacks,
                          NetworkEngine)
from ..net.parsed_message import ParsedMessage, pack_tid
from ..scheduler import Scheduler
from ..sockaddr import SockAddr
from ..utils import pack_msg

N_CHECKS = 12


class LiveChecker:
    """One UDP socket + one NetworkEngine driven synchronously."""

    def __init__(self, host: str, port: int, network: int = 0,
                 timeout: float = 4.0):
        self.peer = SockAddr.resolve(host, port)[0]
        fam = self.peer.family
        self.sock = socket.socket(fam, socket.SOCK_DGRAM)
        self.sock.bind(("::" if fam == socket.AF_INET6 else "0.0.0.0", 0))
        self.sock.setblocking(False)
        self.timeout = timeout
        self.errors: list = []
        cbs = EngineCallbacks()
        cbs.on_error = lambda req, e: self.errors.append(e.code)
        self.engine = NetworkEngine(
            InfoHash.get_random(), network,
            lambda data, dst: self.sock.sendto(
                data, (str(dst.ip), dst.port)) and 0,
            Scheduler(), cbs, is_client=True)
        self.node = self.engine.cache.get_node(
            InfoHash(), self.peer, time.monotonic(), confirm=False)

    def pump(self, done) -> bool:
        """Deliver traffic + retries until ``done()`` or timeout."""
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            if done():
                return True
            self.engine.scheduler.run()
            r, _, _ = select.select([self.sock], [], [], 0.05)
            if r:
                try:
                    data, addr = self.sock.recvfrom(64 * 1024)
                except OSError:
                    continue
                self.engine.process_message(
                    data, SockAddr(addr[0], addr[1]))
        return done()

    def relearn_node(self, peer_id: InfoHash):
        """After the ping reply names the peer, use the interned node."""
        self.node = self.engine.cache.get_node(
            peer_id, self.peer, time.monotonic(), confirm=True)

    def close(self):
        self.sock.close()


def run_checks(host: str, port: int, network: int = 0,
               timeout: float = 4.0, verbose: bool = True) -> list:
    """Returns [(name, ok, detail)] for all 10 checks."""
    c = LiveChecker(host, port, network, timeout)
    results: list = []

    def step(name, ok, detail=""):
        results.append((name, bool(ok), detail))
        if verbose:
            print(f"  [{'ok' if ok else 'FAIL'}] {name}"
                  + (f" — {detail}" if detail else ""), flush=True)

    try:
        # 1. ping (anonymous bootstrap request — learns the peer id)
        box: dict = {}
        c.engine.send_ping(c.node, on_done=lambda r, a: box.update(done=r))
        ok = c.pump(lambda: "done" in box)
        peer_id = box["done"].node.id if ok else InfoHash()
        step("ping", ok and len(bytes(peer_id)) == 20,
             f"peer id {peer_id}" if ok else "no reply")
        if not ok:
            return results
        c.relearn_node(peer_id)

        # 2. find_node
        box.clear()
        c.engine.send_find_node(c.node, InfoHash.get_random(), want=1,
                                on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        step("find_node", ok, f"{len(box['a'].nodes4)} v4 nodes"
             if ok else "no reply")

        # 3. get → token
        h = InfoHash.get("compat-check-" + secrets.token_hex(4))
        box.clear()
        c.engine.send_get_values(c.node, h, Query(), want=1,
                                 on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        token = box["a"].ntoken if ok else b""
        step("get/token", ok and len(token) > 0,
             f"token {len(token)} B" if ok else "no reply")

        # 4. listen
        box.clear()
        got_push: list = []
        c.engine.send_listen(c.node, h, Query(), token, None,
                             on_done=lambda r, a: box.update(a=a),
                             socket_cb=lambda n, m: got_push.append(m))
        ok = c.pump(lambda: "a" in box)
        step("listen", ok, "" if ok else "no confirmation")

        # 5. put (small value)
        payload = b"compat-check-payload-" + secrets.token_hex(8).encode()
        v = Value(payload, value_id=7)
        box.clear()
        c.engine.send_announce_value(c.node, h, v, time.time(), token,
                                     on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        step("put", ok and box.get("a") and box["a"].vid == 7,
             f"vid {box['a'].vid}" if ok else "no ack")

        # 6. get → value round-trip
        box.clear()
        c.engine.send_get_values(c.node, h, Query(), want=1,
                                 on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        vals = box["a"].values if ok else []
        step("get/value", ok and any(x.data == payload for x in vals),
             f"{len(vals)} values" if ok else "no reply")

        # 7. big (fragmented) put
        big = Value(bytes(range(256)) * 11, value_id=8)      # >600 B packed
        box.clear()
        c.engine.send_announce_value(c.node, h, big, time.time(), token,
                                     on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        step("put/fragmented", ok and box.get("a") and box["a"].vid == 8,
             "" if ok else "no ack")

        # 8. get → fragmented value reassembled
        box.clear()
        c.engine.send_get_values(c.node, h, Query(), want=1,
                                 on_done=lambda r, a: box.update(a=a))
        ok = c.pump(lambda: "a" in box)
        vals = box["a"].values if ok else []
        step("get/fragmented", ok and any(x.data == big.data for x in vals),
             f"{len(vals)} values" if ok else "no reply")

        # 9. forged token → 401
        c.errors.clear()
        c.engine.send_announce_value(c.node, h, Value(b"x", value_id=9),
                                     time.time(), b"forged-token",
                                     on_done=lambda r, a: None)
        ok = c.pump(lambda: DhtProtocolException.UNAUTHORIZED in c.errors)
        step("put/forged-token→401", ok, "" if ok else
             f"errors seen: {c.errors}")

        # 10. refresh unknown hash → 404
        c.errors.clear()
        c.engine.send_refresh_value(c.node, InfoHash.get_random(), 123,
                                    token, on_done=lambda r, a: None)
        ok = c.pump(lambda: DhtProtocolException.NOT_FOUND in c.errors)
        step("refresh/unknown→404", ok, "" if ok else
             f"errors seen: {c.errors}")

        # 11. traced ping: the optional tr key must not change behavior
        box.clear()
        root = tracing.TraceContext.new_root()
        with tracing.activate(root):
            c.engine.send_ping(c.node,
                               on_done=lambda r, a: box.update(done=r))
        ok = c.pump(lambda: "done" in box)
        step("ping/trace-ctx", ok, "" if ok else "no reply")

        # 12. unknown top-level keys (incl. an oversized hostile trace
        # blob) parse cleanly on the peer and never echo back.  Blob
        # sized to fit one UDP datagram under the node's 1500 B recv
        # MTU — the multi-KB versions live in tests/test_wire_fuzz.py,
        # which feeds the parser in-process without a datagram limit.
        blob = b"\xaa" * 600
        tid12 = 0x7A7A7A7A
        raw = pack_msg({
            "a": {"id": bytes(c.engine.myid)}, "q": "ping",
            "t": pack_tid(tid12), "y": "q", "v": "RNG1",
            "zz_future_key": blob, "tr": blob[:256],
        })
        c.sock.sendto(raw, (str(c.peer.ip), c.peer.port))
        reply = None
        deadline = time.monotonic() + c.timeout
        while reply is None and time.monotonic() < deadline:
            r, _, _ = select.select([c.sock], [], [], 0.05)
            if not r:
                continue
            try:
                data, _addr = c.sock.recvfrom(64 * 1024)
            except OSError:
                continue
            try:
                pm = ParsedMessage.from_bytes(data)
            except Exception:
                continue
            if pm.tid == tid12:
                reply = data
        ok = reply is not None and blob[:64] not in reply
        step("ping/unknown-keys", ok,
             f"reply {len(reply)} B, no echo" if ok else
             ("blob echoed!" if reply else "no reply"))
    finally:
        c.close()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Run the scripted wire-compat exchanges against a "
                    "live DHT node")
    p.add_argument("host", nargs="?", default="127.0.0.1")
    p.add_argument("port", nargs="?", type=int, default=4222)
    p.add_argument("-n", "--network", type=int, default=0)
    p.add_argument("--timeout", type=float, default=4.0)
    p.add_argument("--self-test", action="store_true",
                   help="spin up this package's own node in-process and "
                        "check against it")
    p.add_argument("--cpu", action="store_true",
                   help="run the --self-test node on the host (default: "
                        "the CUDA card)")
    args = p.parse_args(argv)

    runner = None
    host, port = args.host, args.port
    if args.self_test:
        from ..runtime.runner import DhtRunner
        runner = DhtRunner()
        runner.run(0, device="cpu" if args.cpu else None)
        host, port = "127.0.0.1", runner.get_bound_port()
        print(f"self-test node on {host}:{port}")

    try:
        print(f"compat check vs {host}:{port}")
        results = run_checks(host, port, args.network, args.timeout)
    finally:
        if runner is not None:
            runner.shutdown()
            runner.join()
    n_ok = sum(1 for _, ok, _ in results if ok)
    print(f"{n_ok}/{len(results)} checks passed")
    return 0 if n_ok == len(results) == N_CHECKS else 1


if __name__ == "__main__":
    sys.exit(main())
