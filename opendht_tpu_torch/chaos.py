"""Adversarial chaos plane: declarative fault plans + one injection seam.

The port of the JAX package's ``chaos.py``, host-only and with its
behaviour unchanged.  The reference's resilience lives in its network
engine and routing-table maintenance (request expiry
``request.h:108-112``, blacklists, bucket refresh); this module
*produces* the adversarial scenarios the observability stack (SLO
verdicts, black-box bundles) judges:

- :class:`FaultPlan` — a declarative script of timed :class:`Phase`\\ s:
  per-link packet loss / duplication / reordering / extra delay
  (:class:`LinkRule`, asymmetric by default), asymmetric partitions
  with healing (:class:`Partition` — a phase ends, the partition
  heals), join/leave storms (:class:`Storm`) and eclipse/sybil-style
  routing-table poisoning (:class:`Poison`).
- :class:`FaultInjector` — the ONE injection seam every harness
  shares.  ``fate(src, dst, now)`` folds the active phases into a
  per-packet :class:`Fate` (drop / duplicate / extra delay) with a
  seeded RNG, so the same plan replays identically.  On the live
  engine, ``net/engine.py`` consults an optional ``fault_hook`` in its
  send path, ``None`` by default and guarded by
  ``Config.chaos_enabled``; with no plan armed the send path is
  byte-identical to a node without this plane.
- the :class:`Storm` / :class:`Poison` phases parameterize the JAX
  package's swarm stepper (``ops/swarm.py``), which the port does not
  carry yet.

Stdlib + the telemetry spine only: the plan and injector run on the
live engine's send path without touching the device.

Reference mapping: the reference's adversarial tier is the netns
cluster harness (``python/tools/dht/network.py``,
``virtual_network_builder.py``) — veth pairs + netem qdiscs scripted
from a shell.  A :class:`FaultPlan` is that scripting surface made
declarative and deterministic, and the injector replaces the qdisc.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import telemetry

__all__ = [
    "LinkRule", "Partition", "Storm", "Poison", "Phase", "FaultPlan",
    "Fate", "FaultInjector", "arm_dht", "arm_engine", "disarm_engine",
]

#: wildcard group matching any endpoint
ANY = "*"

_PASS = None                      # fate sentinel: deliver unchanged


# ============================================================ plan grammar
@dataclass
class LinkRule:
    """Per-link netem: applies to packets src-group → dst-group.

    Asymmetric by default (matches one direction); ``symmetric=True``
    applies the same treatment to the reverse direction too.  ``loss``/
    ``dup``/``reorder`` are per-packet probabilities; a reordered
    packet is held ``reorder_delay`` extra seconds so later packets
    overtake it (delivery is then no longer send-ordered); ``delay`` +
    uniform ``jitter`` add latency to every matched packet."""
    name: str = "link"
    src: str = ANY
    dst: str = ANY
    loss: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    reorder_delay: float = 0.05
    delay: float = 0.0
    jitter: float = 0.0
    symmetric: bool = False

    def matches(self, src_group: str, dst_group: str) -> bool:
        fwd = (self.src in (ANY, src_group)
               and self.dst in (ANY, dst_group))
        if fwd or not self.symmetric:
            return fwd
        return (self.src in (ANY, dst_group)
                and self.dst in (ANY, src_group))


@dataclass
class Partition:
    """Directed group-to-group blocks; heals when its phase ends.

    ``block=[("a", "b")]`` drops a→b only (an *asymmetric* partition —
    b still reaches a); ``symmetric=True`` blocks both directions of
    every listed pair."""
    block: List[Tuple[str, str]] = field(default_factory=list)
    symmetric: bool = False

    def blocks(self, src_group: str, dst_group: str) -> bool:
        for a, b in self.block:
            if (src_group, dst_group) == (a, b):
                return True
            if self.symmetric and (src_group, dst_group) == (b, a):
                return True
        return False


@dataclass
class Storm:
    """Join/leave churn rates (per node per tick / per storm step)."""
    leave_rate: float = 0.0
    join_rate: float = 0.0


@dataclass
class Poison:
    """Eclipse/sybil pressure on one victim group: attacker-controlled
    ids flood the victims' buckets from few source addresses.  The
    swarm stepper admits at most the FREE slots per bucket (the routing
    table's full-bucket admission rule, src/routing_table.cpp:204-262);
    the live sybil test drives the same shape through the wire."""
    victim: str = "victim"
    per_bucket: int = 8        # attacker entries attempted per bucket
    source_addrs: int = 2      # distinct source addresses used


@dataclass
class Phase:
    """One timed window of faults, ``[start, start+duration)`` seconds
    from arming.  ``duration=None`` = open-ended."""
    name: str
    start: float = 0.0
    duration: Optional[float] = None
    rules: List[LinkRule] = field(default_factory=list)
    partition: Optional[Partition] = None
    storm: Optional[Storm] = None
    poison: Optional[Poison] = None

    def active(self, rel: float) -> bool:
        if rel < self.start:
            return False
        return self.duration is None or rel < self.start + self.duration


class FaultPlan:
    """An ordered script of :class:`Phase` windows plus the group
    membership the link rules and partitions refer to.

    ``membership`` maps an endpoint key (whatever the harness uses —
    ``(host, port)`` tuples here) to a group name; unmapped endpoints
    are in group ``"*"`` and only match wildcard rules."""

    def __init__(self, phases: List[Phase], *,
                 membership: Optional[Dict[object, str]] = None,
                 seed: int = 1337):
        self.phases = list(phases)
        self.membership: Dict[object, str] = dict(membership or {})
        self.seed = seed

    def group_of(self, key) -> str:
        return self.membership.get(key, ANY)

    def phases_at(self, rel: float) -> List[Phase]:
        return [p for p in self.phases if p.active(rel)]

    def storm_at(self, rel: float) -> Optional[Storm]:
        for p in self.phases_at(rel):
            if p.storm is not None:
                return p.storm
        return None

    def poison_at(self, rel: float) -> Optional[Poison]:
        for p in self.phases_at(rel):
            if p.poison is not None:
                return p.poison
        return None

    def partitions_at(self, rel: float) -> List[Tuple[str, Partition]]:
        return [(p.name, p.partition) for p in self.phases_at(rel)
                if p.partition is not None]

    def end_time(self) -> Optional[float]:
        """Relative time after which no phase is active (None if any
        phase is open-ended)."""
        end = 0.0
        for p in self.phases:
            if p.duration is None:
                return None
            end = max(end, p.start + p.duration)
        return end


# ========================================================== injection seam
class Fate(NamedTuple):
    """Per-packet verdict from the injector."""
    drop: bool = False
    dup: int = 0               # extra copies to send
    delay: float = 0.0         # extra seconds to hold the packet
    rule: Optional[str] = None  # attribution for per-rule accounting

    @property
    def touched(self) -> bool:
        return self.drop or self.dup > 0 or self.delay > 0.0


_PASS_FATE = Fate()


class FaultInjector:
    """The shared per-packet decision engine.

    One injector serves a whole harness: every send path calls
    ``fate(src_key, dst_key, now)`` and applies the verdict.  Seeded
    (``plan.seed``) so a scripted storm replays identically in the
    single-threaded harnesses (virtual net, swarm stepper); on a
    real-UDP cluster, where every node's loop thread shares the one
    injector, ``fate`` is serialized by a lock — counts stay exact,
    but the cross-thread draw interleaving is scheduling-dependent, so
    only the virtual tiers carry the replay guarantee.  Per-rule
    counters (``counts[rule][action]``) split the harness's drop
    accounting, mirrored on the telemetry spine as
    ``dht_chaos_injected_total{action=,rule=}``."""

    def __init__(self, plan: FaultPlan, *, registry=None):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.t0: Optional[float] = None
        self.counts: Dict[str, Dict[str, int]] = {}
        self._reg = registry
        self._metric_cache: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def arm(self, now: float) -> None:
        self.t0 = now

    def disarm(self) -> None:
        self.t0 = None

    @property
    def armed(self) -> bool:
        return self.t0 is not None

    def rel(self, now: float) -> float:
        return now - (self.t0 or 0.0)

    # -- accounting --------------------------------------------------------
    def _count(self, rule: str, action: str) -> None:
        self.counts.setdefault(rule, {}).setdefault(action, 0)
        self.counts[rule][action] += 1
        m = self._metric_cache.get((rule, action))
        if m is None:
            reg = self._reg or telemetry.get_registry()
            m = reg.counter("dht_chaos_injected_total",
                            action=action, rule=rule)
            self._metric_cache[(rule, action)] = m
        m.inc()

    def dropped_by_rule(self) -> Dict[str, int]:
        return {r: c.get("dropped", 0) for r, c in self.counts.items()
                if c.get("dropped")}

    # -- the verdict -------------------------------------------------------
    def fate(self, src_key, dst_key, now: float) -> Fate:
        """Fold every active phase into one verdict.  Partition blocks
        win outright; link rules then accumulate loss/dup/reorder/delay
        (first matching loss draw drops; delays add).  Serialized: one
        injector is shared by every engine loop thread of a real-UDP
        cluster."""
        if self.t0 is None:
            return _PASS_FATE
        with self._lock:
            if self.t0 is None:          # disarmed while we waited
                return _PASS_FATE
            return self._fate_locked(src_key, dst_key, now)

    def _fate_locked(self, src_key, dst_key, now: float) -> Fate:
        rel = now - self.t0
        sg = self.plan.group_of(src_key)
        dg = self.plan.group_of(dst_key)
        delay = 0.0
        dup = 0
        tag = None
        delay_tag = None       # the rule whose delay/jitter applied
        for phase in self.plan.phases_at(rel):
            if phase.partition is not None \
                    and phase.partition.blocks(sg, dg):
                self._count("partition:%s" % phase.name, "dropped")
                return Fate(drop=True, rule="partition:%s" % phase.name)
            for rule in phase.rules:
                if not rule.matches(sg, dg):
                    continue
                if rule.loss and self.rng.random() < rule.loss:
                    self._count(rule.name, "dropped")
                    return Fate(drop=True, rule=rule.name)
                if rule.delay or rule.jitter:
                    delay += rule.delay + (
                        self.rng.random() * rule.jitter if rule.jitter
                        else 0.0)
                    delay_tag = delay_tag or rule.name
                    tag = tag or rule.name
                if rule.reorder and self.rng.random() < rule.reorder:
                    delay += rule.reorder_delay
                    self._count(rule.name, "reordered")
                    tag = rule.name
                if rule.dup and self.rng.random() < rule.dup:
                    dup += 1
                    self._count(rule.name, "dup")
                    tag = rule.name
        if dup == 0 and delay == 0.0:
            return _PASS_FATE
        # "delayed" attributes only to delay/jitter rules — a
        # reorder-only hold is already counted as "reordered"
        if delay_tag is not None:
            self._count(delay_tag, "delayed")
        return Fate(drop=False, dup=dup, delay=delay, rule=tag)


# ======================================================= live-engine arming
def arm_engine(engine, injector: FaultInjector, src_key) -> None:
    """Install the injector on one :class:`~opendht_tpu_torch.net.engine.
    NetworkEngine`'s send path.  The hook returns True when it consumed
    the packet (drop, or rescheduled with extra delay); duplicates are
    sent inline before the original.  Delayed packets replay through
    the engine's own scheduler, so ordering faults stay on the node's
    loop thread."""
    def send_quiet(data: bytes, addr) -> None:
        # mirror engine._send's contract: a send never raises (the
        # socket may error under flood or close during shutdown while
        # a delayed replay is still queued on the scheduler)
        try:
            engine._send_fn(data, addr)
        except OSError:
            pass

    def hook(data: bytes, addr) -> bool:
        now = engine.scheduler.time()
        fate = injector.fate(src_key, (addr.host, addr.port), now)
        if fate.drop:
            return True
        for _ in range(fate.dup):
            send_quiet(data, addr)
        if fate.delay > 0.0:
            engine.scheduler.add(
                now + fate.delay,
                lambda d=data, a=addr: send_quiet(d, a))
            return True
        return False

    engine.fault_hook = hook


def disarm_engine(engine) -> None:
    engine.fault_hook = None


def arm_dht(dht, injector: FaultInjector, *, src_key=None,
            force: bool = False) -> None:
    """Arm a live node's engine.  Guarded: a production node must opt
    in via ``Config.chaos_enabled`` (off by default — with the hook
    unarmed the send path is byte-identical to pre-chaos builds);
    test harnesses that own their nodes pass ``force=True``.

    ``src_key`` is the node's own endpoint key for group membership
    lookups.  Only the virtual net's Dht objects carry ``bound_addr``;
    a runner-owned live node MUST pass its ``("host", port)`` key
    explicitly or it joins the wildcard group and group-scoped rules
    and partitions silently never match it (a warning is logged)."""
    import logging
    if not force and not getattr(dht.config, "chaos_enabled", False):
        raise RuntimeError(
            "refusing to arm a fault plan on a node without "
            "Config.chaos_enabled (pass force=True from an owning "
            "test harness)")
    key = src_key
    if key is None:
        ba = getattr(dht, "bound_addr", None)
        if ba is not None:
            key = (ba.host, ba.port)
        elif injector.plan.membership:
            logging.getLogger("opendht_tpu_torch.chaos").warning(
                "arm_dht: no src_key and no bound_addr — the node "
                "joins the wildcard group; group-scoped rules and "
                "partitions will not match its egress")
    arm_engine(dht.engine, injector, key)


def disarm_dht(dht) -> None:
    disarm_engine(dht.engine)
