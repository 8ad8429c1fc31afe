"""Node status, stats and configuration (reference
include/opendht/callbacks.h:41-117).

A copy of the JAX package's ``runtime/config.py`` cut to the planes the
port carries.  ``Config`` keeps the node, ingest, resolve-shard,
health, history, waterfall, pipeline-observatory and peer-ledger
fields, with the JAX defaults, and ``SecureDhtConfig`` is as in JAX.
It leaves out ``keyspace``, ``cache``, ``chaos_enabled``, ``reshard``,
``listen_batching`` and ``listeners``: the planes behind them are not
ported yet, and the slice that ports one adds its field back with the
JAX default.  Passing a left-out field
raises TypeError, as for any dataclass.  The port's node serves as the
JAX node does with those planes off (``keyspace.enabled=False``,
``cache.enabled=False``, ``reshard.enabled=False``,
``listen_batching="off"``), which the JAX package pins as
result-identical to its defaults.
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
    #: mesh axis (the JAX package's ``parallel/partition.py``).  0/1 =
    #: unsharded, the one path the port has: the sharded resolve is
    #: not ported, and ``Dht.resolve_mesh`` raises NotImplementedError
    #: for >= 2 instead of serving unsharded behind a warning.
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


@dataclass
class SecureDhtConfig:
    """(callbacks.h:111-115); identity = (PrivateKey, Certificate)."""
    node_config: Config = field(default_factory=Config)
    identity: Optional[tuple] = None
