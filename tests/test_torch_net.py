"""The port's wire engine against the frozen goldens and the JAX engine.

The cases of tests/test_goldens.py and tests/test_wire_conversations.py,
run through ``opendht_tpu_torch``'s ``NetworkEngine`` (its msgpack codec
included): every golden packet is emitted byte for byte and parsed back,
and the scripted two-engine conversations (fragmented announce and get,
the six error codes, the ``sa`` echo, the netid drop, listen u-packets)
replay with the same transcripts.  The goldens come from the independent
spec encoder tests/goldens/mini_msgpack.py.  A group runs one port
engine and one JAX engine back to back, in both roles.

Every case of tests/test_net_node.py (liveness boundaries, tid
generation, the request seams) and tests/test_net_engine.py (the RPC
matrix over its two-engine switch, retries, rate limits, martians,
fragments, the node cache) runs on both packages, as the JAX file is
written and with its imports read as the port's, after the same seeded
``random`` stream (transaction ids): both pass the case's assertions,
and every call the case makes into ``net/`` returns the same result in
the same order.
"""

import inspect
import os

import pytest

from opendht_tpu_torch.core.value import Field, Query, Select, Value
from opendht_tpu_torch.infohash import InfoHash
from opendht_tpu_torch.net.engine import (DhtProtocolException,
                                          EngineCallbacks, NetworkEngine,
                                          RequestAnswer)
from opendht_tpu_torch.net.node import Node
from opendht_tpu_torch.net.parsed_message import MessageType, ParsedMessage
from opendht_tpu_torch.net.request import RequestState
from opendht_tpu_torch.scheduler import Scheduler
from opendht_tpu_torch.sockaddr import SockAddr
from test_torch_storage import (case_calls, case_names, jax_case_namespace,
                                seed_streams)


GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

MYID = bytes(range(20))
TARGET = b"\xaa" * 20
HASH = b"\xbb" * 20
TID = 0x01020304
SID = 0x05060709
TOKEN = bytes(range(0x10, 0x18))
CREATED = 1_700_000_000
VID = 42
ADDR = SockAddr("10.0.0.9", 4009)        # replies carry only the ip ("sa")
N4_BLOB = (b"\xc1" * 20 + b"\x0a\x00\x00\x01" + (4000).to_bytes(2, "big")
           + b"\xc2" * 20 + b"\x0a\x00\x00\x02" + (4001).to_bytes(2, "big"))
N6_BLOB = (b"\xd1" * 20 + b"\x00" * 15 + b"\x01" + (4002).to_bytes(2, "big"))

V1 = Value(b"hello world", type_id=3, value_id=VID)
V2 = Value(b"second value", type_id=0, value_id=43, user_type="text/plain")


def golden(name: str) -> bytes:
    with open(os.path.join(GOLDENS, name + ".bin"), "rb") as f:
        return f.read()


def make_engine(network: int = 0):
    sent = []
    eng = NetworkEngine(InfoHash(MYID), network,
                        lambda data, dst: sent.append(bytes(data)) or 0,
                        Scheduler(), EngineCallbacks())
    return eng, sent


def fixed_node(*tids) -> Node:
    node = Node(InfoHash.get("peer"), SockAddr("10.0.0.1", 4000))
    seq = list(tids)
    node.get_new_tid = lambda: seq.pop(0)
    return node


# ------------------------------------------------------------ emit == golden

def test_ping_req():
    eng, sent = make_engine()
    eng.send_ping(fixed_node(TID))
    assert sent[0] == golden("ping_req")


def test_ping_req_network():
    eng, sent = make_engine(network=7)
    eng.send_ping(fixed_node(TID))
    assert sent[0] == golden("ping_req_net7")


def test_pong_and_listen_confirmation():
    eng, sent = make_engine()
    eng.send_pong(ADDR, TID)
    eng.send_listen_confirmation(ADDR, TID)
    assert sent[0] == golden("pong")
    assert sent[1] == golden("pong")      # same layout (cpp:1119-1133)


def test_find_req():
    from opendht_tpu_torch.utils import WANT4, WANT6
    eng, sent = make_engine()
    eng.send_find_node(fixed_node(TID), InfoHash(TARGET), want=WANT4 | WANT6)
    assert sent[0] == golden("find_req")


def test_get_req():
    eng, sent = make_engine()
    eng.send_get_values(fixed_node(TID), InfoHash(HASH), Query())
    assert sent[0] == golden("get_req")


def test_get_req_select():
    eng, sent = make_engine()
    q = Query(select=Select().field(Field.ID))
    eng.send_get_values(fixed_node(TID), InfoHash(HASH), q)
    assert sent[0] == golden("get_req_select")


def test_listen_req():
    eng, sent = make_engine()
    node = fixed_node(SID, TID)
    req = eng.send_listen(node, InfoHash(HASH), Query(), TOKEN, None,
                          socket_cb=lambda *a: None)
    assert req is not None
    assert sent[0] == golden("listen_req")


def test_announce_req():
    eng, sent = make_engine()
    eng.send_announce_value(fixed_node(TID), InfoHash(HASH), V1,
                            float(CREATED), TOKEN)
    assert sent[0] == golden("announce_req")


def test_refresh_req():
    eng, sent = make_engine()
    eng.send_refresh_value(fixed_node(TID), InfoHash(HASH), VID, TOKEN)
    assert sent[0] == golden("refresh_req")


def test_nodes_values_resp():
    eng, sent = make_engine()
    eng.send_nodes_values(ADDR, TID, N4_BLOB, N6_BLOB, [V1, V2], Query(),
                          TOKEN)
    assert sent[0] == golden("nodes_values")


def test_value_announced_resp():
    eng, sent = make_engine()
    eng.send_value_announced(ADDR, TID, VID)
    assert sent[0] == golden("value_announced")


def test_error_resp():
    eng, sent = make_engine()
    eng.send_error(ADDR, TID, 401, "Unauthorized", include_id=True)
    assert sent[0] == golden("error_unauthorized")


def test_value_parts_stream():
    eng, sent = make_engine()
    big = Value(bytes(range(256)) * 11, type_id=3, value_id=77)
    eng._send_value_parts(TID, [big.get_packed()], ADDR)
    assert b"".join(sent) == golden("value_parts")


# ------------------------------------------------------- parse(golden) == ok

def test_parse_ping():
    m = ParsedMessage.from_bytes(golden("ping_req"))
    assert m.type is MessageType.PING
    assert bytes(m.id) == MYID and m.tid == TID and m.ua == "RNG1"


def test_parse_find():
    m = ParsedMessage.from_bytes(golden("find_req"))
    assert m.type is MessageType.FIND_NODE
    assert bytes(m.target) == TARGET
    from opendht_tpu_torch.utils import WANT4, WANT6
    assert m.want == WANT4 | WANT6


def test_parse_get_select():
    m = ParsedMessage.from_bytes(golden("get_req_select"))
    assert m.type is MessageType.GET_VALUES
    assert bytes(m.info_hash) == HASH
    assert m.query.select.get_selection() == [Field.ID]


def test_parse_listen():
    m = ParsedMessage.from_bytes(golden("listen_req"))
    assert m.type is MessageType.LISTEN
    assert m.token == TOKEN and m.socket_id == SID


def test_parse_announce():
    m = ParsedMessage.from_bytes(golden("announce_req"))
    assert m.type is MessageType.ANNOUNCE_VALUE
    assert m.token == TOKEN and m.created == CREATED
    assert len(m.values) == 1
    v = m.values[0]
    assert v.id == VID and v.type == 3 and v.data == b"hello world"


def test_parse_refresh():
    m = ParsedMessage.from_bytes(golden("refresh_req"))
    assert m.type is MessageType.REFRESH
    assert m.value_id == VID and m.token == TOKEN


def test_parse_nodes_values():
    m = ParsedMessage.from_bytes(golden("nodes_values"))
    assert m.nodes4_raw == N4_BLOB and m.nodes6_raw == N6_BLOB
    assert m.token == TOKEN
    assert [v.id for v in m.values] == [VID, 43]
    assert m.values[1].user_type == "text/plain"
    assert m.addr.ip is not None and m.addr.ip.packed == b"\x0a\x00\x00\x09"


def test_parse_error():
    m = ParsedMessage.from_bytes(golden("error_unauthorized"))
    assert m.type is MessageType.ERROR
    assert m.error_code == 401 and bytes(m.id) == MYID


def test_parse_value_parts_reassembly():
    """Feed the fragment stream through the engine's rx path after an
    announce that declared part sizes (network_engine.cpp:407-457)."""
    raw = golden("value_parts")
    # split packets: each starts with 0x83 fixmap(3); reparse via Unpacker
    from opendht_tpu_torch.utils import unpack_stream
    frags = [ParsedMessage.from_obj(o) for o in unpack_stream(raw)]
    assert all(f.type is MessageType.VALUE_DATA for f in frags)
    assert [f.tid for f in frags] == [TID] * len(frags)
    blob = bytearray()
    for f in frags:
        for idx, part in f.value_parts.items():
            assert idx == 0
            off, data = part
            assert off == len(blob)
            blob.extend(data)
    v = Value.from_packed(bytes(blob))
    assert v.id == 77 and v.data == bytes(range(256)) * 11


# ================================================================== conversations


B_ID = InfoHash.get("peer")              # responder id = sha1("peer")
A_ADDR = SockAddr("10.0.0.9", 4009)
B_ADDR = SockAddr("10.0.0.1", 4000)
BIG = Value(bytes(range(256)) * 11, type_id=3, value_id=77)   # 2816 B packed


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class Pair:
    """Two engines joined by a byte-duplex recording wire.  ``deliver``
    controls whether bytes are forwarded (False = record only, for the
    drop tests)."""

    def __init__(self, net_a: int = 0, net_b: int = 0, cbs_b=None,
                 cbs_a=None):
        self.clock = _Clock()
        self.a_out: list = []
        self.b_out: list = []
        self.deliver = True               # False = queue; flush() delivers
        self._pending: list = []
        self.cbs_a = cbs_a or EngineCallbacks()
        self.cbs_b = cbs_b or EngineCallbacks()
        self.a = NetworkEngine(InfoHash(MYID), net_a, self._send_a,
                               Scheduler(clock=self.clock), self.cbs_a)
        self.b = NetworkEngine(B_ID, net_b, self._send_b,
                               Scheduler(clock=self.clock), self.cbs_b)

    def _send_a(self, data, dst) -> int:
        self.a_out.append(bytes(data))
        if self.deliver:
            self.b.process_message(bytes(data), A_ADDR)
        else:
            self._pending.append(("b", bytes(data)))
        return 0

    def _send_b(self, data, dst) -> int:
        self.b_out.append(bytes(data))
        if self.deliver:
            self.a.process_message(bytes(data), B_ADDR)
        else:
            self._pending.append(("a", bytes(data)))
        return 0

    def flush(self) -> None:
        """Deliver queued packets (deferred mode) until the wire is
        quiet — packets sent during delivery are delivered too."""
        while self._pending:
            to, data = self._pending.pop(0)
            if to == "b":
                self.b.process_message(data, A_ADDR)
            else:
                self.a.process_message(data, B_ADDR)

    def node_b(self, *tids):
        """A's cache Node for B with a pinned tid sequence — requests
        must live on the cache node so B's replies find them."""
        n = self.a.cache.get_node(B_ID, B_ADDR, self.clock(), confirm=True)
        seq = list(tids)
        n.get_new_tid = lambda: seq.pop(0)
        return n


def split_parts(raw: bytes) -> list:
    """Split a concatenated value_parts golden into packets (each is a
    standalone msgpack map)."""
    from opendht_tpu_torch.utils import unpack_stream
    from opendht_tpu_torch.utils import pack_msg
    return [pack_msg(o) for o in unpack_stream(raw)]


# ------------------------------------------------- fragmentation both ways

def test_conv_big_announce_fragments_and_reassembles():
    got = {}

    def on_announce(node, h, token, values, created):
        got.update(h=bytes(h), token=token, values=values, created=created)
        return RequestAnswer()

    p = Pair(cbs_b=EngineCallbacks(on_announce=on_announce))
    done = []
    req = p.a.send_announce_value(p.node_b(TID), InfoHash(HASH), BIG,
                                  float(CREATED), TOKEN,
                                  on_done=lambda r, a: done.append(a))
    # A→B transcript: the sizes-announce then the MTU parts stream
    assert p.a_out[0] == golden("announce_big_req")
    assert b"".join(p.a_out[1:]) == golden("value_parts")
    # B reassembled the full value before dispatching on_announce
    assert got["h"] == HASH and got["token"] == TOKEN
    assert got["created"] == CREATED
    assert len(got["values"]) == 1
    assert got["values"][0].id == 77 and got["values"][0].data == BIG.data
    # B confirmed with value_announced(77); A's request completed
    assert p.b_out == [golden("value_announced_77")]
    assert req.state is RequestState.COMPLETED
    assert done and done[0].vid == 77


def test_conv_big_get_reply_fragments_and_reassembles():
    def on_get(node, h, want, query):
        return RequestAnswer(ntoken=TOKEN, values=[BIG])

    p = Pair(cbs_b=EngineCallbacks(on_get_values=on_get))
    answers = []
    req = p.a.send_get_values(p.node_b(TID), InfoHash(HASH), Query(),
                              on_done=lambda r, a: answers.append(a))
    assert p.a_out == [golden("get_req")]
    # B→A: sizes-reply + the same MTU parts stream (reverse direction)
    assert p.b_out[0] == golden("nodes_values_sizes")
    assert b"".join(p.b_out[1:]) == golden("value_parts")
    assert req.state is RequestState.COMPLETED
    assert answers and answers[0].ntoken == TOKEN
    assert [v.id for v in answers[0].values] == [77]
    assert answers[0].values[0].data == BIG.data


# --------------------------------------------------------- six error codes

def _raising(exc):
    def cb(*a, **kw):
        raise exc
    return cb


def test_conv_error_203_get_no_infohash():
    exc = DhtProtocolException(DhtProtocolException.NON_AUTHORITATIVE_INFORMATION,
                               DhtProtocolException.GET_NO_INFOHASH)
    p = Pair(cbs_b=EngineCallbacks(on_get_values=_raising(exc)))
    req = p.a.send_get_values(p.node_b(TID), InfoHash(b"\x00" * 20), Query())
    assert p.b_out == [golden("error_203_get")]
    # 203 on a get is recorded but not special-cased: the request stays
    # pending (only 401-announce/listen and 404-refresh rearm/notify)
    assert req.state is RequestState.PENDING


def test_conv_error_401_put_wrong_token_rearms_announce():
    exc = DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                               DhtProtocolException.PUT_WRONG_TOKEN)
    errors = []
    p = Pair(cbs_b=EngineCallbacks(on_announce=_raising(exc)),
             cbs_a=EngineCallbacks(
                 on_error=lambda r, e: errors.append((r, e.code))))
    p.deliver = False         # real wires have latency: the error must
    v = Value(b"hello world", type_id=3, value_id=42)   # arrive AFTER
    req = p.a.send_announce_value(p.node_b(TID), InfoHash(HASH), v,
                                  float(CREATED), b"bad-token!")
    p.flush()                 # sendto() returns, not inside it
    assert p.b_out == [golden("error_401_put")]
    # requester side: 401 on an announce rearms the request for resend
    # with a fresh token (network_engine.cpp:536-554; dht.cpp:2090-2112)
    assert errors == [(req, 401)]
    assert req.last_try == float("-inf")


def test_conv_error_404_refresh_unknown_storage():
    exc = DhtProtocolException(DhtProtocolException.NOT_FOUND,
                               DhtProtocolException.STORAGE_NOT_FOUND)
    errors = []
    p = Pair(cbs_b=EngineCallbacks(on_refresh=_raising(exc)),
             cbs_a=EngineCallbacks(
                 on_error=lambda r, e: errors.append(e.code)))
    p.a.send_refresh_value(p.node_b(TID), InfoHash(HASH), 42, TOKEN)
    assert p.b_out == [golden("error_404_refresh")]
    assert errors == [404]


def test_conv_error_421_truncated_tid_is_parse_dropped():
    """A packet whose bin 't' is not 4 bytes fails tid parsing and is
    dropped before dispatch — the reference's parse-drop path
    (processMessage catch, cpp:418-424; 421 has no send site)."""
    p = Pair()
    bad = golden("ping_req").replace(b"t\xc4\x04\x01\x02\x03\x04",
                                     b"t\xc4\x03\x01\x02\x03")
    assert bad != golden("ping_req")
    p.b.process_message(bad, A_ADDR)
    assert p.b_out == []                  # no pong, no error — dropped


def test_conv_error_422_unknown_tid_reply_swallowed():
    """A reply for a transaction A never issued raises UNKNOWN_TID
    locally (cpp:521) — no error packet goes out for non-requests."""
    p = Pair()
    p.a.process_message(golden("value_announced_77"), B_ADDR)
    assert p.a_out == []
    # and receiving a peer-sent 422 error packet parses fine too
    p.a.process_message(golden("error_422"), B_ADDR)
    assert p.a_out == []


def test_conv_error_423_corrupt_node_blob_dropped():
    """A find reply whose n4 blob is not a multiple of 26 bytes throws
    WRONG_NODE_INFO_BUF_LEN during deserializeNodes (cpp:845-851); the
    request must not complete and nothing is emitted in response."""
    p = Pair()
    p.deliver = False                     # hand-deliver the corrupt reply
    req = p.a.send_find_node(p.node_b(TID), InfoHash(b"\xaa" * 20))
    p.a_out.clear()
    p.a.process_message(golden("nodes_corrupt_n4"), B_ADDR)
    assert p.a_out == []
    assert req.state is RequestState.PENDING


def test_parse_all_six_error_codes():
    """Every DhtProtocolException code round-trips through the parser
    with the sender id recovered."""
    from opendht_tpu_torch.net.parsed_message import ParsedMessage
    for name, code in (("error_203_get", 203), ("error_401_put", 401),
                       ("error_404_refresh", 404), ("error_421", 421),
                       ("error_422", 422), ("error_423", 423)):
        m = ParsedMessage.from_bytes(golden(name))
        assert m.type is MessageType.ERROR
        assert m.error_code == code
        assert bytes(m.id) == bytes(B_ID)


# ------------------------------------------------------------ sa NAT echo

def test_conv_sa_echo_roundtrip():
    """B echoes A's source address in the pong's 'sa'; A surfaces it via
    on_reported_addr — the NAT discovery loop."""
    reported = []
    p = Pair(cbs_a=EngineCallbacks(
        on_reported_addr=lambda i, a: reported.append((bytes(i), a))))
    req = p.a.send_ping(p.node_b(TID))
    assert p.a_out == [golden("ping_req")]
    assert p.b_out == [golden("pong_b")]
    assert req.state is RequestState.COMPLETED
    (rid, addr), = reported
    assert rid == bytes(B_ID)
    assert addr.ip is not None and addr.ip.packed == b"\x0a\x00\x00\x09"


# ------------------------------------------------------- netid mismatch

def test_conv_netid_mismatch_drop_and_expiry():
    """B (network 7) silently drops A's (network 0) ping — no reply, no
    error — and A's request expires after its 3×1 s attempts."""
    p = Pair(net_a=0, net_b=7)
    expired = []
    req = p.a.send_ping(p.node_b(TID),
                        on_expired=lambda r, done: expired.append(done))
    assert p.a_out == [golden("ping_req")]
    assert p.b_out == []                  # dropped before dispatch
    for _ in range(8):                    # drive A's retry schedule
        p.clock.t += 1.0
        p.a.scheduler.run()
    assert req.state is RequestState.EXPIRED
    assert expired and expired[-1] is True


# -------------------------------------------------- listen u push channel

def test_conv_listen_u_packets_refreshed_and_expired():
    p = Pair(cbs_b=EngineCallbacks(
        on_listen=lambda n, h, t, s, q: RequestAnswer()))
    pushed = []
    req = p.a.send_listen(p.node_b(SID, TID), InfoHash(HASH), Query(),
                          TOKEN, None,
                          socket_cb=lambda node, msg: pushed.append(msg))
    assert p.a_out == [golden("listen_req")]
    assert p.b_out == [golden("pong_b")]  # listen confirmation layout
    assert req.state is RequestState.COMPLETED

    # B pushes refreshed / expired id lists over the socket channel
    node_a = p.b.cache.get_node(InfoHash(MYID), A_ADDR, p.clock(),
                                confirm=True)
    p.b_out.clear()
    p.b.tell_listener_refreshed(node_a, SID, InfoHash(HASH), TOKEN, [42, 43])
    p.b.tell_listener_expired(node_a, SID, InfoHash(HASH), TOKEN, [42, 43])
    assert p.b_out == [golden("listen_refreshed_u"),
                       golden("listen_expired_u")]
    assert [m.refreshed_values for m in pushed] == [[42, 43], []]
    assert [m.expired_values for m in pushed] == [[], [42, 43]]


# ============================================================ port <-> JAX

def _pkg(name: str) -> dict:
    """The classes a wire test needs, from one of the two packages."""
    import importlib
    m = {k: importlib.import_module(f"{name}.{k}")
         for k in ("infohash", "sockaddr", "scheduler", "net.engine",
                   "core.value")}
    return {"InfoHash": m["infohash"].InfoHash,
            "SockAddr": m["sockaddr"].SockAddr,
            "Scheduler": m["scheduler"].Scheduler,
            "Engine": m["net.engine"].NetworkEngine,
            "Callbacks": m["net.engine"].EngineCallbacks,
            "Answer": m["net.engine"].RequestAnswer,
            "Value": m["core.value"].Value,
            "Query": m["core.value"].Query}


class MixedPair:
    """Requester A and responder B from the packages named, joined by a
    recording wire; each side sees addresses of its own package."""

    def __init__(self, pkg_a: str, pkg_b: str, cbs_b=None):
        self.A, self.B = _pkg(pkg_a), _pkg(pkg_b)
        self.clock = _Clock()
        self.a_out, self.b_out = [], []
        a_addr = self.B["SockAddr"]("10.0.0.9", 4009)
        b_addr = self.A["SockAddr"]("10.0.0.1", 4000)
        self.a = self.A["Engine"](
            self.A["InfoHash"](MYID), 0,
            lambda d, dst: self.a_out.append(bytes(d))
            or self.b.process_message(bytes(d), a_addr) or 0,
            self.A["Scheduler"](clock=self.clock), self.A["Callbacks"]())
        self.b = self.B["Engine"](
            self.B["InfoHash"].get("peer"), 0,
            lambda d, dst: self.b_out.append(bytes(d))
            or self.a.process_message(bytes(d), b_addr) or 0,
            self.B["Scheduler"](clock=self.clock),
            cbs_b(self.B) if cbs_b else self.B["Callbacks"]())
        self.node_b = self.a.cache.get_node(
            self.A["InfoHash"].get("peer"), b_addr, self.clock(),
            confirm=True)

    def pin(self, *tids):
        seq = list(tids)
        self.node_b.get_new_tid = lambda: seq.pop(0)
        return self.node_b


DIRECTIONS = [("opendht_tpu_torch", "opendht_tpu"),
              ("opendht_tpu", "opendht_tpu_torch")]


@pytest.mark.parametrize("pkg_a,pkg_b", DIRECTIONS)
def test_mixed_ping_sa_echo(pkg_a, pkg_b):
    p = MixedPair(pkg_a, pkg_b)
    p.a.send_ping(p.pin(TID))
    assert p.a_out == [golden("ping_req")]
    assert p.b_out == [golden("pong_b")]


@pytest.mark.parametrize("pkg_a,pkg_b", DIRECTIONS)
def test_mixed_big_announce(pkg_a, pkg_b):
    got = {}

    def cbs(P):
        def on_announce(node, h, token, values, created):
            got["values"] = values
            return P["Answer"]()
        return P["Callbacks"](on_announce=on_announce)

    p = MixedPair(pkg_a, pkg_b, cbs)
    big = p.A["Value"](bytes(range(256)) * 11, type_id=3, value_id=77)
    p.a.send_announce_value(p.pin(TID), p.A["InfoHash"](HASH), big,
                            float(CREATED), TOKEN)
    assert p.a_out[0] == golden("announce_big_req")
    assert b"".join(p.a_out[1:]) == golden("value_parts")
    assert p.b_out == [golden("value_announced_77")]
    assert got["values"][0].data == big.data


@pytest.mark.parametrize("pkg_a,pkg_b", DIRECTIONS)
def test_mixed_big_get(pkg_a, pkg_b):
    def cbs(P):
        big = P["Value"](bytes(range(256)) * 11, type_id=3, value_id=77)
        return P["Callbacks"](on_get_values=lambda n, h, w, q: P["Answer"](
            ntoken=TOKEN, values=[big]))

    p = MixedPair(pkg_a, pkg_b, cbs)
    answers = []
    p.a.send_get_values(p.pin(TID), p.A["InfoHash"](HASH), p.A["Query"](),
                        on_done=lambda r, a: answers.append(a))
    assert p.a_out == [golden("get_req")]
    assert p.b_out[0] == golden("nodes_values_sizes")
    assert b"".join(p.b_out[1:]) == golden("value_parts")
    assert [v.id for v in answers[0].values] == [77]


@pytest.mark.parametrize("pkg_a,pkg_b", DIRECTIONS)
def test_mixed_listen_and_u_packets(pkg_a, pkg_b):
    def cbs(P):
        return P["Callbacks"](on_listen=lambda n, h, t, s, q: P["Answer"]())

    p = MixedPair(pkg_a, pkg_b, cbs)
    pushed = []
    p.a.send_listen(p.pin(SID, TID), p.A["InfoHash"](HASH), p.A["Query"](),
                    TOKEN, None, socket_cb=lambda node, msg: pushed.append(msg))
    assert p.a_out == [golden("listen_req")]
    node_a = p.b.cache.get_node(p.B["InfoHash"](MYID),
                                p.B["SockAddr"]("10.0.0.9", 4009),
                                p.clock(), confirm=True)
    p.b_out.clear()
    p.b.tell_listener_refreshed(node_a, SID, p.B["InfoHash"](HASH), TOKEN,
                                [42, 43])
    p.b.tell_listener_expired(node_a, SID, p.B["InfoHash"](HASH), TOKEN,
                              [42, 43])
    assert p.b_out == [golden("listen_refreshed_u"),
                       golden("listen_expired_u")]
    assert [m.refreshed_values for m in pushed] == [[42, 43], []]


# ------------------------------ tests/test_net_node.py, test_net_engine.py
NET_FILES = ("net/engine.py", "net/parsed_message.py", "net/node_cache.py",
             "net/node.py", "net/request.py")
NET_CASES = [(f, n) for f in ("test_net_node.py", "test_net_engine.py")
             for n in case_names(f)]


def test_every_net_case_is_twinned():
    assert len(NET_CASES) == 12 + 19


@pytest.mark.parametrize("fname,name", NET_CASES,
                         ids=["%s::%s" % c for c in NET_CASES])
def test_jax_net_case_twin(fname, name, monkeypatch):
    recs = []
    for pkg in ("jax", "port"):
        ns = jax_case_namespace(fname, pkg)
        case = ns[name]
        # tests/test_net_engine.py's ``net`` fixture is a fresh ``Net()``
        kw = ({"net": ns["Net"]()}
              if "net" in inspect.signature(case).parameters else {})
        with monkeypatch.context() as m:
            seed_streams(m, 5)
            recs.append(case_calls(case, kw, pkg, fname, NET_FILES))
    assert recs[0], "the case reached no traced function"
    assert recs[1] == recs[0]
