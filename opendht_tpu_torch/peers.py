"""Per-peer network observatory.

A copy of the JAX package's ``peers.py`` with its behaviour unchanged.

The other planes instrument everything *inside* a node; the wire between
nodes stayed dark: ``dht_net_rtt_seconds{type=}`` aggregates over all
peers, and every retransmit fires at the fixed
``MAX_RESPONSE_TIME = 1.0`` regardless of whether the peer answers in
2 ms or 800 ms.  The reference keeps exactly this state per remote
node — ``net::Node``'s reply/time bookkeeping behind
``isGood``/dubious/expired (node.h:79-92) and the good/dubious counts
``getNodesStats`` folds over the routing table — but never closes the
loop into the retransmit timer.

:class:`PeerLedger` is a bounded LRU ledger keyed by (node id,
sockaddr), fed from the request lifecycle seams in
:mod:`~opendht_tpu.net.engine` / :mod:`~opendht_tpu.net.request`:

* **RTT estimator** — Jacobson/Karels EWMA + mean deviation per peer
  (RFC 6298 coefficients: srtt <- 7/8*srtt + 1/8*rtt, rttvar <-
  3/4*rttvar + 1/4*|srtt - rtt|), sampled under Karn's rule (only
  replies to never-retransmitted attempts; a reply after a retransmit
  is ambiguous about which attempt it answers).  Karn's *algorithm* is
  both halves: the sampling rule alone deadlocks when a link degrades
  after fast samples (every reply then follows a retransmit, so no
  sample can ever raise the estimate), so each timeout also doubles a
  per-peer backoff that multiplies the RTO until the next clean sample
  resets it (RFC 6298 §5.5-5.7).
* **Adaptive per-peer RTO** — ``srtt + 4*rttvar`` clamped to
  ``[rto_min, rto_max]``, consulted by ``Request.is_expired`` and the
  engine's retransmit wakeup scheduling when
  :attr:`PeersConfig.adaptive_rto` is on.  With zero RTT samples (or
  the knob off, or the ledger disabled) :meth:`PeerLedger.rto` returns
  exactly ``MAX_RESPONSE_TIME`` — the fixed-timeout path is the
  structural escape hatch and the no-sample behaviour is pinned
  equivalent (tests/test_peers.py).  ``rto_max`` defaults to
  ``MAX_ATTEMPT_COUNT * MAX_RESPONSE_TIME`` (the fixed path's total
  per-request patience): a high-variance link needs a per-attempt RTO
  *above* the fixed 1 s ceiling or the 4*rttvar term could never
  prevent the spurious retransmits it exists to prevent; a dead peer
  is still declared expired within the same order of patience the
  fixed path spends across its three attempts.  Set ``rto_max = 1.0``
  for a strict ``[rto_min, MAX_RESPONSE_TIME]`` clamp.
* **Attribution counts** — per-peer sent / completed / expired /
  cancelled requests, per-attempt retransmit timeouts, spurious
  retransmits (retransmissions of requests that ultimately completed:
  the reply was already in flight), bytes in/out by message type, and
  good<->dubious<->expired status flap transitions mirroring the
  reference's ``Node`` liveness rules.

The ledger is pure observation on the send/receive path: it never
composes packets, so wire bytes stay bit-identical with it enabled
(pinned by benchmarks/exp_peers_r23.py, which also commits the <1%
host-overhead paired delta as ``captures/peers_overhead.json``).

Exports: per-peer gauges ``dht_peer_srtt_seconds{peer=}`` /
``dht_peer_rto_seconds{peer=}`` / ``dht_peer_fail_ratio{peer=}``, a
per-peer histogram ``dht_peer_rtt_seconds{peer=}`` (the substrate
testing/network_monitor.py folds instead of its old roundtrip-only
view), aggregate ``dht_peer_tracked`` / ``dht_peer_evicted_total`` /
``dht_peer_flaps_total`` / ``dht_peer_spurious_retransmits_total`` /
``dht_peer_bytes_total{direction=,type=}``.  Everything is a plain
registry series, so it rides ``get_metrics()``, proxy ``GET /stats``
and the history ring with no extra plumbing; the structured
:meth:`PeerLedger.snapshot` backs ``GET /peers``, the dhtnode REPL
``peers`` command, the dhtscanner ``peers`` section and the
testing/wiremap_assembler.py cluster wire map.  Evicted peers' gauges
are parked at ``-1`` (the registry has no removal API); every
per-peer reader treats negative values as unknown — the
``dhtmon --max-peer-fail`` contract.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

from . import telemetry
from .net.node import MAX_RESPONSE_TIME

#: total patience of the fixed-timeout path (3 attempts x 1 s) — the
#: default per-attempt RTO ceiling, see the module docstring
_FIXED_PATIENCE = 3 * MAX_RESPONSE_TIME


@dataclass
class PeersConfig:
    """Per-peer observatory knobs (``Config.peers``)."""

    #: master switch; off = no ledger, no per-peer series, the engine
    #: and request lifecycle behave byte- and timing-identically to
    #: earlier builds
    enabled: bool = True
    #: LRU bound on tracked peers; the oldest-touched record is
    #: evicted past it (its gauges park at -1 = unknown)
    capacity: int = 256
    #: consult the Jacobson/Karels estimate for retransmit scheduling
    #: and request expiry.  Off (the default this round) keeps the
    #: fixed ``MAX_RESPONSE_TIME`` timetable everywhere — the ledger
    #: still *measures* per-peer RTT/RTO so operators can inspect the
    #: adaptive timer on the surfaces before opting in.
    adaptive_rto: bool = False
    #: lower clamp on the adaptive RTO: never retransmit faster than
    #: this even to a 2 ms peer (a reply delayed by one scheduler tick
    #: must not look like loss)
    rto_min: float = 0.25
    #: upper clamp on the adaptive RTO (default: the fixed path's
    #: total 3 x MAX_RESPONSE_TIME patience; 1.0 = strict
    #: [rto_min, MAX_RESPONSE_TIME])
    rto_max: float = _FIXED_PATIENCE
    #: a peer's fail ratio joins the ``peer_flap`` health signal and
    #: the dhtmon gate only after this many requests (one timed-out
    #: bootstrap ping is not a bad link)
    min_signal_events: int = 8


class PeerRecord:
    """One tracked remote peer (the ledger's LRU value)."""

    __slots__ = (
        "id", "addr", "label", "srtt", "rttvar", "samples", "backoff",
        "sent", "completed", "expired", "cancelled",
        "attempt_timeouts", "spurious_retrans",
        "bytes_in", "bytes_out", "msgs_in",
        "status", "flaps", "transitions", "first_seen", "last_seen",
        "_g_srtt", "_g_rto", "_g_fail", "_h_rtt",
    )

    def __init__(self, peer_id: str, addr: str, now: float):
        self.id = peer_id
        self.addr = addr
        # short-id@addr: unique per ledger key, short enough for label
        # cardinality sanity ("" id = anonymous bootstrap target)
        self.label = "%s@%s" % (peer_id[:8] or "?", addr)
        self.srtt: Optional[float] = None
        self.rttvar: Optional[float] = None
        self.samples = 0
        self.backoff = 0          # Karn backoff exponent (doublings)
        self.sent = 0             # requests (first attempts)
        self.completed = 0
        self.expired = 0          # requests that ran out of attempts
        self.cancelled = 0
        self.attempt_timeouts = 0  # retransmissions (per-attempt)
        self.spurious_retrans = 0  # retransmits of requests that completed
        self.bytes_in: Dict[str, int] = {}
        self.bytes_out: Dict[str, int] = {}
        self.msgs_in = 0
        self.status: Optional[str] = None   # good | dubious | expired
        self.flaps = 0
        self.transitions: Dict[str, int] = {}
        self.first_seen = now
        self.last_seen = now
        self._g_srtt = None
        self._g_rto = None
        self._g_fail = None
        self._h_rtt = None

    def fail_ratio(self) -> Optional[float]:
        """Expired fraction of finished requests; None below two
        finished requests (nothing to attribute yet)."""
        done = self.completed + self.expired
        if done <= 0:
            return None
        return self.expired / done

    def to_doc(self, rto: float) -> dict:
        return {
            "id": self.id, "addr": self.addr, "peer": self.label,
            "srtt": self.srtt, "rttvar": self.rttvar, "rto": rto,
            "samples": self.samples, "backoff": self.backoff,
            "sent": self.sent, "completed": self.completed,
            "expired": self.expired, "cancelled": self.cancelled,
            "attempt_timeouts": self.attempt_timeouts,
            "spurious_retransmits": self.spurious_retrans,
            "fail_ratio": self.fail_ratio(),
            "bytes_in": dict(self.bytes_in),
            "bytes_out": dict(self.bytes_out),
            "msgs_in": self.msgs_in,
            "status": self.status, "flaps": self.flaps,
            "transitions": dict(self.transitions),
            "first_seen": self.first_seen, "last_seen": self.last_seen,
        }


class PeerLedger:
    """Bounded per-peer ledger; every hook is O(1) host arithmetic
    under one lock (the engine is single-threaded under the scheduler,
    but proxy handler threads call :meth:`snapshot` concurrently)."""

    def __init__(self, cfg: Optional[PeersConfig] = None, node: str = "",
                 clock=None, registry=None):
        self.cfg = cfg or PeersConfig()
        self.enabled = bool(self.cfg.enabled)
        self.node = node
        self._clock = clock or (lambda: 0.0)
        self.reg = registry or telemetry.get_registry()
        self._lock = threading.Lock()
        self._peers: "OrderedDict[tuple, PeerRecord]" = OrderedDict()
        self.evicted = 0
        self._g_tracked = self.reg.gauge("dht_peer_tracked",
                                         node=node)
        self._c_evicted = self.reg.counter("dht_peer_evicted_total",
                                           node=node)
        self._c_flaps = self.reg.counter("dht_peer_flaps_total", node=node)
        self._c_spurious = self.reg.counter(
            "dht_peer_spurious_retransmits_total", node=node)
        self._m_bytes: Dict[tuple, telemetry.Counter] = {}

    # ------------------------------------------------------------- records
    @staticmethod
    def _key(node) -> tuple:
        return (str(node.id) if node.id else "", str(node.addr))

    def _rec(self, node, now: float) -> PeerRecord:
        """Get-or-create + LRU touch; caller holds the lock."""
        key = self._key(node)
        rec = self._peers.get(key)
        if rec is None:
            rec = PeerRecord(key[0], key[1], now)
            self._peers[key] = rec
            while len(self._peers) > max(self.cfg.capacity, 1):
                _, old = self._peers.popitem(last=False)
                self.evicted += 1
                self._c_evicted.inc()
                # park the evicted peer's gauges at the unknown
                # sentinel — no removal API, and every reader
                # (dhtmon/wiremap/health) filters v < 0
                for g in (old._g_srtt, old._g_rto, old._g_fail):
                    if g is not None:
                        g.set(-1.0)
            self._g_tracked.set(float(len(self._peers)))
        else:
            self._peers.move_to_end(key)
        rec.last_seen = now
        return rec

    def _refresh_status(self, rec: PeerRecord, node, now: float) -> None:
        """Mirror the reference's Node liveness classification
        (node.h:79-92) into the ledger and count flap transitions."""
        if node.expired:
            st = "expired"
        elif node.is_good(now):
            st = "good"
        else:
            st = "dubious"
        prev = rec.status
        if prev is not None and prev != st:
            rec.flaps += 1
            self._c_flaps.inc()
            tkey = "%s->%s" % (prev, st)
            rec.transitions[tkey] = rec.transitions.get(tkey, 0) + 1
        rec.status = st

    def _refresh_gauges(self, rec: PeerRecord) -> None:
        if rec._g_srtt is None:
            rec._g_srtt = self.reg.gauge("dht_peer_srtt_seconds",
                                         node=self.node, peer=rec.label)
            rec._g_rto = self.reg.gauge("dht_peer_rto_seconds",
                                        node=self.node, peer=rec.label)
            rec._g_fail = self.reg.gauge("dht_peer_fail_ratio",
                                         node=self.node, peer=rec.label)
        rec._g_srtt.set(-1.0 if rec.srtt is None else rec.srtt)
        rec._g_rto.set(self._rto(rec))
        fr = rec.fail_ratio()
        rec._g_fail.set(-1.0 if fr is None
                        or rec.sent < self.cfg.min_signal_events else fr)

    def _count_bytes(self, direction: str, mtype: str, n: int) -> None:
        key = (direction, mtype)
        c = self._m_bytes.get(key)
        if c is None:
            c = self._m_bytes[key] = self.reg.counter(
                "dht_peer_bytes_total", node=self.node,
                direction=direction, type=mtype)
        c.inc(n)

    # ---------------------------------------------------------------- RTO
    def _rto(self, rec: PeerRecord) -> float:
        """``max(srtt + 4*rttvar, rto_min) * 2^backoff`` clamped to
        ``rto_max``.  No-sample peers stay on exactly
        ``MAX_RESPONSE_TIME`` (the behaviour-equivalence pin) — the
        backoff only steers peers we have an estimate for, where the
        Karn sampling rule would otherwise pin a stale fast estimate
        forever (module docstring)."""
        if (not self.cfg.adaptive_rto or rec.srtt is None
                or rec.rttvar is None):
            return MAX_RESPONSE_TIME
        cfg = self.cfg
        base = max(rec.srtt + 4.0 * rec.rttvar, cfg.rto_min)
        return min(base * (1 << min(rec.backoff, 8)), cfg.rto_max)

    def rto(self, node) -> float:
        """The per-attempt retransmit timeout for this peer —
        exactly ``MAX_RESPONSE_TIME`` when disabled, the knob is off,
        or no RTT sample exists (the behaviour-equivalence pin)."""
        if not self.enabled or not self.cfg.adaptive_rto:
            return MAX_RESPONSE_TIME
        with self._lock:
            rec = self._peers.get(self._key(node))
            return MAX_RESPONSE_TIME if rec is None else self._rto(rec)

    def _sample_rtt(self, rec: PeerRecord, rtt: float) -> None:
        """RFC 6298 estimator update (first sample seeds
        rttvar = rtt/2, like TCP)."""
        if rec.srtt is None:
            rec.srtt = rtt
            rec.rttvar = rtt / 2.0
        else:
            rec.rttvar = 0.75 * rec.rttvar + 0.25 * abs(rec.srtt - rtt)
            rec.srtt = 0.875 * rec.srtt + 0.125 * rtt
        rec.samples += 1
        if rec._h_rtt is None:
            rec._h_rtt = self.reg.histogram("dht_peer_rtt_seconds",
                                            node=self.node, peer=rec.label)
        rec._h_rtt.observe(rtt)

    # ------------------------------------------------------- engine seams
    def on_send(self, node, mtype: str, nbytes: int) -> None:
        """First attempt of a request left for this peer."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            rec = self._rec(node, now)
            rec.sent += 1
            rec.bytes_out[mtype] = rec.bytes_out.get(mtype, 0) + nbytes
            self._count_bytes("out", mtype, nbytes)
            self._refresh_status(rec, node, now)
            self._refresh_gauges(rec)

    def on_retransmit(self, req) -> None:
        """A real retransmission: the previous attempt timed out
        (the engine's ``_request_step`` retry site)."""
        if not self.enabled:
            return
        now = self._clock()
        mtype = req.type.value
        nbytes = len(req.msg)
        with self._lock:
            rec = self._rec(req.node, now)
            rec.attempt_timeouts += 1
            rec.backoff = min(rec.backoff + 1, 8)   # RFC 6298 §5.5
            rec.bytes_out[mtype] = rec.bytes_out.get(mtype, 0) + nbytes
            self._count_bytes("out", mtype, nbytes)
            self._refresh_status(rec, req.node, now)
            self._refresh_gauges(rec)

    def on_received(self, node, mtype: str, nbytes: int) -> None:
        """Any complete inbound message attributed to this peer
        (nbytes = 0 for reassembled multi-part values: the fragments'
        raw sizes are not retained)."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            rec = self._rec(node, now)
            rec.msgs_in += 1
            if nbytes:
                rec.bytes_in[mtype] = rec.bytes_in.get(mtype, 0) + nbytes
                self._count_bytes("in", mtype, nbytes)
            self._refresh_status(rec, node, now)
            self._refresh_gauges(rec)

    def on_request_completed(self, req, rtt: Optional[float]) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            rec = self._rec(req.node, now)
            rec.completed += 1
            if req.attempt_count > 1:
                # the reply was already in flight when we retransmitted
                n = req.attempt_count - 1
                rec.spurious_retrans += n
                self._c_spurious.inc(n)
            elif rtt is not None:
                # Karn's rule: only un-retransmitted attempts give an
                # unambiguous RTT sample — and a clean sample ends any
                # backoff (RFC 6298 §5.7)
                rec.backoff = 0
                self._sample_rtt(rec, rtt)
            self._refresh_status(rec, req.node, now)
            self._refresh_gauges(rec)

    def on_request_expired(self, req) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            rec = self._rec(req.node, now)
            rec.expired += 1
            rec.backoff = min(rec.backoff + 1, 8)   # final timeout
            self._refresh_status(rec, req.node, now)
            self._refresh_gauges(rec)

    def on_request_cancelled(self, req) -> None:
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            rec = self._rec(req.node, now)
            rec.cancelled += 1
            self._refresh_status(rec, req.node, now)
            self._refresh_gauges(rec)

    # ------------------------------------------------------------ surfaces
    def fail_signal(self) -> Optional[float]:
        """Worst per-peer fail ratio among peers with at least
        ``min_signal_events`` requests — the degrade-only ``peer_flap``
        health signal.  None (unknown, never trips) when no peer
        qualifies: a quiet or freshly booted node has no bad links."""
        if not self.enabled:
            return None
        worst = None
        with self._lock:
            for rec in self._peers.values():
                if rec.sent < self.cfg.min_signal_events:
                    continue
                fr = rec.fail_ratio()
                if fr is not None and (worst is None or fr > worst):
                    worst = fr
        return worst

    def snapshot(self) -> dict:
        """The structured document behind ``GET /peers`` / the REPL /
        the scanner; ``time`` is the ledger clock at snapshot (the
        wire-map assembler's skew check compares it against the
        scraper's wall clock, like the timeline assembler)."""
        now = self._clock()
        with self._lock:
            peers = [rec.to_doc(self._rto(rec))
                     for rec in self._peers.values()]
        peers.sort(key=lambda d: d["last_seen"], reverse=True)
        return {
            "enabled": self.enabled,
            "node": self.node,
            "time": now,
            "adaptive_rto": bool(self.cfg.adaptive_rto),
            "rto_min": self.cfg.rto_min,
            "rto_max": self.cfg.rto_max,
            "capacity": self.cfg.capacity,
            "tracked": len(peers),
            "evicted": self.evicted,
            "fail_signal": self.fail_signal(),
            "peers": peers,
        }
