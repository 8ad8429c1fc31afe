"""Node status, stats and configuration (reference
include/opendht/callbacks.h:41-117).

A copy of the JAX package's ``runtime/config.py``: every field at its
JAX default, and ``SecureDhtConfig`` as in JAX.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

# the declarative SLO/health config lives in health.py and is
# re-exported here because runtime/config.py is where node behavior is
# configured — `Config.health` is the knob surface
from ..health import HealthConfig, SloObjective, default_slos  # noqa: F401
from ..history import HistoryConfig  # noqa: F401  (knob surface)
from ..waterfall import WaterfallConfig  # noqa: F401  (knob surface)
from ..pipeline_observatory import PipelineObservatoryConfig  # noqa: F401
from ..peers import PeersConfig  # noqa: F401  (knob surface)
from ..keyspace import KeyspaceConfig  # noqa: F401  (knob surface)
from ..hotcache import HotCacheConfig  # noqa: F401  (knob surface)
from ..listeners import ListenerTableConfig  # noqa: F401  (knob surface)
from ..reshard import ReshardConfig  # noqa: F401  (knob surface)
from ..infohash import InfoHash

#: total value-store budget per node (callbacks.h:117)
DEFAULT_STORAGE_LIMIT = 64 * 1024 * 1024


class NodeStatus(enum.Enum):
    """(callbacks.h:41-45)"""
    DISCONNECTED = 0     # 0 nodes
    CONNECTING = 1       # 1+ nodes known, no confirmed peer yet
    CONNECTED = 2        # 1+ good nodes


@dataclass
class NodeStats:
    """Routing-table health counters (callbacks.h:47-67)."""
    good_nodes: int = 0
    dubious_nodes: int = 0
    cached_nodes: int = 0
    incoming_nodes: int = 0
    table_depth: int = 0
    searches: int = 0
    node_cache_size: int = 0

    def get_known_nodes(self) -> int:
        return self.good_nodes + self.dubious_nodes

    def get_network_size_estimation(self) -> int:
        """8 · 2^depth (callbacks.h:54)."""
        return 8 * (2 ** self.table_depth)

    def to_dict(self) -> dict:
        return {
            "good": self.good_nodes, "dubious": self.dubious_nodes,
            "cached": self.cached_nodes, "incoming": self.incoming_nodes,
            "searches": self.searches, "node_cache": self.node_cache_size,
            "table_depth": self.table_depth,
            "network_size_estimation": self.get_network_size_estimation(),
        }


@dataclass
class Config:
    """DHT node configuration (callbacks.h:90-106)."""
    node_id: Optional[InfoHash] = None
    network: int = 0                 # netid partitioning the DHT
    is_bootstrap: bool = False       # client mode: don't join tables
    maintain_storage: bool = False   # republish values toward closer nodes
    storage_limit: int = DEFAULT_STORAGE_LIMIT
    max_req_per_sec: int = 1600      # ingress budget; per-IP = this // 8

    # --- continuous-batching ingest (runtime/wave_builder.py) ---
    #: "on" coalesces live search refills into shared [Q] device
    #: launches; "off" is the escape hatch pinned result-equivalent to
    #: the per-op dispatch path (one padded launch per op)
    ingest_batching: str = "on"
    #: fill target Q: a wave fires as soon as this many lookups queue
    ingest_fill_target: int = 64
    #: deadline knob (seconds): the oldest queued lookup's maximum wait
    #: before a partial wave fires anyway
    ingest_deadline: float = 0.002
    #: admission bound: NEW ops are shed (never in-flight searches)
    #: once this many lookups are queued
    ingest_queue_max: int = 4096
    #: optional op-admission quota (ops/s through rate_limiter.
    #: RateLimiter, the same sliding window the net engine's ingress
    #: quotas use); 0 = unlimited
    ingest_admit_per_sec: int = 0
    #: pipeline depth: how many ingest waves may be in
    #: flight on device at once.  2 (the default double-buffer) fills
    #: wave N+1 and drains wave N−1's scatter while wave N runs on
    #: device; 1 = exact pre-pipeline behavior (launch→block→scatter
    #: inline, the escape hatch — pinned result-equivalent in
    #: tests/test_wave_builder.py).  Validated ≥ 1 by WaveBuilder.
    ingest_pipeline_depth: int = 2

    # --- t-sharded resolve ------------------------------------------
    #: row-shard the device-side closest-node resolve over a t-wide
    #: mesh axis (parallel/sharded.py): ingest waves (and any other
    #: big-batch find_closest on the snapshot) run the per-shard
    #: windowed top-k + one cross-shard merge instead of the
    #: single-device lookup.  0/1 = unsharded (the default); >= 2
    #: needs that many CUDA cards (falls back to unsharded with a
    #: logged warning when the host has fewer).  A node on the CPU
    #: (``device="cpu"``) runs t virtual shards there.  Results are
    #: bit-identical either way (tests/test_torch_sharded.py).
    resolve_mesh_t: int = 0

    # --- health observatory (health.py) ------------------------------
    #: declarative SLO engine + per-node health verdict: per-op
    #: availability/latency objectives with multi-window burn-rate
    #: evaluation, derived signals (ingest queue saturation, scheduler
    #: tick lag, request timeout ratio, stale buckets, connectivity),
    #: evaluated every ``health.period`` seconds on the node scheduler
    #: and exported as `dht_health_*`/`dht_slo_*` gauges, flight
    #: events and ``DhtRunner.get_health()``.
    #: ``health.period = 0`` disables the tick entirely.
    health: HealthConfig = field(default_factory=HealthConfig)

    # --- flight data recorder (history.py) ---------------------------
    #: bounded ring of periodic delta-encoded registry frames (counters
    #: as deltas, histograms as bucket deltas, gauges as last-value)
    #: ticking on the node scheduler, with windowed ``rate``/
    #: ``quantile`` queries, optional bounded on-disk spill
    #: (``history.spill_dir``), and post-mortem black-box bundles —
    #: auto-captured on every health transition to unhealthy, served
    #: fresh by ``DhtRunner.dump_bundle()``.  When the recorder is
    #: live, the health engine's windowed SLO deltas read THROUGH its
    #: frames (one delta codepath).  ``history.period = 0`` disables
    #: the recorder (surfaces report ``enabled: false``; the health
    #: engine falls back to its private windows).
    history: HistoryConfig = field(default_factory=HistoryConfig)

    # --- keyspace traffic observatory (keyspace.py) -----------------
    #: device-resident count-min sketch + 256-bin keyspace histogram
    #: over the ingest waves' target ids (one batched scatter-add per
    #: wave) and stored-key puts: periodic heavy-hitter top-K with
    #: ``hot_key_emerged`` flight events, exponential-decay windowing,
    #: and per-shard load attribution feeding the ``shard_imbalance``
    #: health signal and the `dht_keyspace_*`/`dht_hotkey_*`/
    #: `dht_shard_imbalance` gauges.
    #: ``keyspace.enabled = False`` turns every launch and surface off
    #: (results are identical either way — the sketch only observes).
    keyspace: KeyspaceConfig = field(default_factory=KeyspaceConfig)

    # --- hot-key serving cache (hotcache.py) ------------------------
    #: the acting half of the observe→act loop: a bounded device table
    #: of the observatory's hot keys (canonical 20-byte ids) + host
    #: value payloads, probed in ONE batched XOR-compare before every
    #: ingest wave so hot gets are served from cache without joining
    #: the ``[Q]`` lookup, invalidated on observed puts (a put is
    #: visible on the next get, never a stale hit), plus adaptive
    #: replica widening (closest-8 → closest-16 while a key is hot,
    #: narrowing on decay).  Surfaces: ``dht_cache_*`` series + hit
    #: ratio, ``DhtRunner.get_cache()`` and a degrade-only
    #: ``cache_hit_ratio`` health signal.  ``cache.enabled = False``
    #: turns the probe, fast path and widening off — results are pinned
    #: identical either way.
    cache: HotCacheConfig = field(default_factory=HotCacheConfig)

    # --- adversarial chaos plane (chaos.py) -------------------------
    #: allow a FaultPlan to be armed on this node's live engine send
    #: path (``chaos.arm_dht``).  Off by default: with no plan armed
    #: the engine's fault hook is None and the send path is
    #: byte-identical to a node without the plane.  Test harnesses that
    #: own their nodes arm with ``force=True`` instead of flipping this.
    chaos_enabled: bool = False

    # --- per-op latency waterfall (waterfall.py) -------------------
    #: always-on stage profiler over the full serving path:
    #: ``dht_stage_seconds{stage=}`` histograms (queue_wait /
    #: cache_probe / device_compile / device_launch / scatter_back /
    #: rpc_wait) with exemplar trace ids on the hot buckets, a bounded
    #: per-op decomposition ring, the degrade-only ``stage_budget``
    #: health signal.  Surfaces: ``GET /profile``
    #: (+ ``?fmt=folded``), the ``profile`` REPL cmd, the scanner's
    #: ``waterfall`` section and ``dhtmon --max-stage``.
    #: ``waterfall.enabled = False`` stops observation entirely —
    #: results are identical either way (the profiler only observes).
    waterfall: WaterfallConfig = field(default_factory=WaterfallConfig)

    # --- load-aware resharding (reshard.py) -------------------------
    #: the rebalance tick closing the observe→act loop on
    #: ``dht_shard_imbalance``: when the windowed imbalance stays above
    #: ``reshard.rebalance_threshold`` for ``reshard.sustain`` seconds
    #: (hysteresis latch + history-frame corroboration; min-interval
    #: cooldown), new traffic-weighted shard boundaries are solved from
    #: the observatory's load histogram and hot-swapped under the
    #: serving path between waves.  Lookup results are bit-identical
    #: before, during and after a swap (tests/test_torch_reshard.py).
    #: ``reshard.period = 0`` (or ``enabled = False``) disables the tick.
    reshard: ReshardConfig = field(default_factory=ReshardConfig)

    # --- pipeline observatory (pipeline_observatory.py) -------------
    #: concurrency-aware utilization plane over the async wave
    #: pipeline: per-wave lane timelines (fill / device / drain), the
    #: windowed ``dht_pipeline_occupancy`` device-occupancy gauge,
    #: per-cause ``dht_pipeline_bubble_seconds{cause=}`` device-idle
    #: attribution (+ top-cause gauge), measured fill∥device overlap
    #: (``dht_pipeline_overlap_ratio``) and a Perfetto lane export.
    #: Surfaces: ``GET /pipeline`` (+ ``?fmt=trace``), the ``pipeline``
    #: REPL cmd, the scanner's ``pipeline`` section, ``dhtmon
    #: --min-occupancy`` and the degrade-only ``pipeline_occupancy``
    #: health signal.  Host-side edge bookkeeping only — kernels and
    #: results are bit-identical with the plane on
    #: (tests/test_pipeline_observatory.py).  ``pipeline.enabled =
    #: False`` turns every hook into an early return.
    pipeline: PipelineObservatoryConfig = field(
        default_factory=PipelineObservatoryConfig)

    # --- per-peer network observatory (peers.py) --------------------
    #: bounded LRU ledger over remote peers fed from the request
    #: lifecycle: Jacobson/Karels RTT EWMA + variance per peer,
    #: per-peer sent/completed/timeout/cancel counts, bytes in/out by
    #: message type and good<->dubious<->expired flap transitions
    #: mirroring the reference's ``net::Node`` liveness rules.
    #: ``peers.adaptive_rto`` (off by default) closes the loop into
    #: the retransmit timer: per-attempt timeout = srtt + 4*rttvar
    #: clamped to [rto_min, rto_max], pinned exactly
    #: ``MAX_RESPONSE_TIME`` while a peer has no RTT samples.
    #: Surfaces: ``dht_peer_*`` series, proxy ``GET /peers``, the
    #: ``peers`` REPL cmd, the scanner's ``peers`` section, ``dhtmon
    #: --max-peer-fail``, the degrade-only ``peer_flap`` health signal
    #: and the testing/wiremap_assembler.py cluster wire map.
    #: ``peers.enabled = False`` removes every hook — the request
    #: lifecycle is then byte- and timing-identical to earlier
    #: builds (the ledger only observes; wire bytes are pinned
    #: bit-identical either way in benchmarks/exp_peers_r23.py).
    peers: PeersConfig = field(default_factory=PeersConfig)

    # --- wave-scale listen/push (listeners.py) ----------------------
    #: "on" defers each stored put's listener notification into a
    #: bounded buffer answered by ONE batched XOR-equality pass per
    #: ingest wave (``ops/listener_match.py``) and dispatches one
    #: coalesced callback/``tell_listener`` per wave per listener;
    #: "off" is the escape hatch — the exact synchronous per-put probe
    #: path, pinned result-equivalent (same values, same per-listener
    #: order).
    listen_batching: str = "on"
    #: the device-resident listener table behind the match: bounded
    #: ``[L, 5]`` key-id slots (tombstoned/compacted on cancel/expiry,
    #: host overflow past capacity), ``entry_ttl`` re-check sweep,
    #: ``flush_deadline`` so idle nodes still deliver promptly.
    #: Surfaces: ``dht_listener_*`` series on ``get_metrics()`` and the
    #: history ring, ``DhtRunner.get_listeners()``.  Device failure
    #: goes dark to the synchronous path (a delivery can be late, never
    #: lost).
    listeners: ListenerTableConfig = field(
        default_factory=ListenerTableConfig)


@dataclass
class SecureDhtConfig:
    """(callbacks.h:111-115); identity = (PrivateKey, Certificate)."""
    node_config: Config = field(default_factory=Config)
    identity: Optional[tuple] = None
