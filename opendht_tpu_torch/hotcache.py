"""Hot-key serving cache: the acting half of the observe→act loop.

The port of the JAX package's ``hotcache.py``, with its behaviour
unchanged.  The keyspace observatory detects heavy hitters; this module
acts on them, the way Kademlia's design says to: cache along the lookup
path and widen popular keys' replica sets (Maymounkov & Mazières 2002
§4.1); a front-end cache of only the O(n log n) hottest items
load-balances an arbitrarily skewed workload (Fan et al., *Small Cache,
Big Effect*, SoCC 2011).

Three coupled pieces:

- :class:`HotValueCache` — a bounded table of canonical 20-byte ids
  (``[C, 5]`` int32 keys on the node's device — the operand of
  ``ops/cache_probe.py``) + host-side value payloads.  It SUBSCRIBES to
  the observatory tick: keys crossing the hot rule are admitted (values
  pulled from the local store, or filled from a completed get via
  :meth:`offer`), keys decaying out of the hot set are evicted, expired
  entries swept, and an observed put to a cached key invalidates it
  (:meth:`invalidate` — a put is visible on the next get, never a stale
  hit).
- **Serve-from-cache fast path** — ``runtime/wave_builder.py`` runs
  :meth:`probe_wave` (one batched XOR-compare over the wave's ``[Q]``
  targets) BEFORE the launch: hits are served from the host payloads
  and never join the lookup; the misses fall through to the unchanged
  wave.  Only pure-get refills are eligible (``runtime/dht.py
  _cache_eligible``).
- **Adaptive replica widening** — :meth:`replica_k` answers 16
  (``widen_k``) for keys in the hot set and 8 (``base_k``) otherwise;
  ``runtime/dht.py`` consults it on the announce walk and the
  calendar-binned republish resolve.

The cache changes NO protocol state: a hit serves the SAME values the
full lookup would return from this node's knowledge (the JAX package
pins cache-on == cache-off).  Listens are never cache-served.

Surfaces: ``dht_cache_*`` series and ``dht_cache_hit_ratio`` on the
port's registry, ``cache_admit`` / ``cache_invalidate`` flight events,
the health engine's degrade-only ``cache_hit_ratio`` signal and
``DhtRunner.get_cache()``.

The id table lives on the node's device (``device=``, None = the card)
and is written in place, slot rows copied into the preallocated tensors
after a mutation.  A device that fails degrades to a disabled cache
("going dark") instead of failing the node; serving is identical
either way.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

import torch

from . import telemetry, tracing
from .ops.cache_probe import cache_probe
from .ops.ids import N_LIMBS, ids_from_bytes, ids_from_hashes, to_keys

log = logging.getLogger("opendht_tpu_torch.hotcache")

__all__ = ["HotCacheConfig", "HotValueCache"]


# ========================================================== configuration
@dataclass
class HotCacheConfig:
    """Declarative hot-cache configuration (lives on
    ``runtime.config.Config.cache``)."""

    #: master switch; off disables the probe, the fast path and the
    #: widening — results identical either way, the cache only serves
    #: what the full path would
    enabled: bool = True
    #: bounded cache table slots (canonical 20-byte ids on device,
    #: value payloads host-side); admission beyond it evicts the
    #: coldest admitted key first
    capacity: int = 64
    #: max seconds an entry may serve without a refresh (re-admission
    #: from the local store on the observatory tick refreshes it; a
    #: fill-on-get entry with no local backing expires after this)
    entry_ttl: float = 30.0
    #: replica set for keys in the hot set (closest-16; the reference's
    #: k is 8) — the adaptive-widening half of the loop
    widen_k: int = 16
    #: replica set for everything else (routing_table.h:26)
    base_k: int = 8


class _Entry:
    __slots__ = ("key", "values", "expires", "hits", "store_backed")

    def __init__(self, key: bytes, values: list, expires: float,
                 store_backed: bool):
        self.key = key
        self.values = values
        self.expires = expires
        self.hits = 0
        self.store_backed = store_backed


# ============================================================== the cache
class HotValueCache:
    """Bounded device id table + host value payloads (module
    docstring).  One per :class:`~opendht_tpu_torch.runtime.dht.Dht`
    (``dht.hotcache``); standalone construction (no observatory) is the
    unit-test surface — call :meth:`on_keyspace_tick` manually."""

    def __init__(self, cfg: Optional[HotCacheConfig] = None, *,
                 node: str = "",
                 local_values: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device=None):
        """``local_values(key_bytes) -> list`` (optional) pulls the
        node's current value set for a key at admission/refresh time —
        ``runtime/dht.py`` wires the local store; ``clock`` defaults to
        a monotonic host clock (nodes pass ``scheduler.time``);
        ``device``: where the id table lives (None = the CUDA card)."""
        import time as _time
        self.cfg = cfg or HotCacheConfig()
        self.node = node
        self._labels = {"node": node} if node else {}
        self._local_values = local_values
        self._clock = clock or _time.monotonic
        self._device = device
        self._lock = threading.Lock()
        # host state
        self._entries: Dict[bytes, _Entry] = {}
        self._hot: set = set()          # current keyspace hot set
        # per-key invalidation sequence (freshness tokens): a get in
        # flight across a put must not re-seed the stale pre-put value
        # set through offer() — the offer carries the token captured at
        # get start and is rejected if an invalidate bumped it since
        # Pruned to the hot set on each tick.
        self._inval_seq: Dict[bytes, int] = {}
        # device state (lazy; a failed backend downgrades to disabled)
        self._device_ok: "bool | None" = None if self.cfg.enabled else False
        self._ids_dev = None            # [capacity, 5] int32 keys
        self._valid_dev = None          # [capacity] bool
        self._slots: List[Optional[bytes]] = []
        self._dirty = True
        # windowed hit ratio (reset per observatory tick): the health
        # signal and the dht_cache_hit_ratio gauge read the LAST
        # window, so a week-old lifetime ratio can't hide a fresh miss
        # storm (the dhtmon --window lesson, cache-side)
        self._win_hits = 0
        self._win_misses = 0
        self._ratio: Optional[float] = None
        # metric handles are registered only for an ENABLED cache — a
        # disabled component must never register permanently-zero
        # series (the rule the keyspace observatory follows)
        if self.cfg.enabled:
            reg = telemetry.get_registry()
            self._m_hits = reg.counter("dht_cache_hits_total",
                                       **self._labels)
            self._m_misses = reg.counter("dht_cache_misses_total",
                                         **self._labels)
            self._m_admit = reg.counter("dht_cache_admissions_total",
                                        **self._labels)
            self._m_evict = reg.counter("dht_cache_evictions_total",
                                        **self._labels)
            self._m_inval = reg.counter("dht_cache_invalidations_total",
                                        **self._labels)
            self._m_occ = reg.gauge("dht_cache_occupancy", **self._labels)
            self._m_ratio = reg.gauge("dht_cache_hit_ratio",
                                      **self._labels)
            self._m_widened = reg.gauge("dht_cache_widened_keys",
                                        **self._labels)
            reg.gauge("dht_cache_capacity", **self._labels).set(
                self.cfg.capacity)
            self._m_ratio.set(-1.0)     # -1 = unknown (no window yet)

    # ------------------------------------------------------------- device
    @property
    def enabled(self) -> bool:
        return self.cfg.enabled and self._device_ok is not False

    def active(self) -> bool:
        """Whether the wave builder should bother probing: enabled AND
        at least one entry admitted (an empty cache must not cost the
        wave a launch)."""
        return self.enabled and bool(self._entries)

    def _ensure_device(self) -> bool:
        if self._device_ok is not None:
            return self._device_ok
        try:
            cap = max(1, int(self.cfg.capacity))
            self._ids_dev = to_keys(np.zeros((cap, N_LIMBS), np.uint32),
                                    self._device)
            self._valid_dev = torch.zeros(cap, dtype=torch.bool,
                                          device=self._ids_dev.device)
            self._dirty = True
            self._device_ok = True
        except Exception:
            log.warning("hot-cache probe unavailable (device %s does not "
                        "work); cache disabled", self._device,
                        exc_info=True)
            self._device_ok = False
        return self._device_ok

    def _go_dark_locked(self) -> None:
        """Device failure mid-probe: disable AND clear every entry
        (callers hold the lock) — a dead cache must serve nothing and
        report unknown, never a frozen hot set (the keyspace go-dark
        contract)."""
        self._device_ok = False
        self._entries.clear()
        self._hot = set()
        self._slots = []
        self._ids_dev = self._valid_dev = None
        self._ratio = None
        self._win_hits = self._win_misses = 0
        self._dirty = True

    def _rebuild_device_locked(self) -> None:
        """Re-place the id table after a mutation (callers hold the
        lock): the slot rows are written in place into the device
        tensors allocated by :meth:`_ensure_device` (the table is
        [capacity, 5] — tiny, so a full rewrite per admission/eviction
        is cheaper than tracking slot deltas)."""
        cap = max(1, int(self.cfg.capacity))
        keys = list(self._entries)[:cap]
        ids = np.zeros((cap, N_LIMBS), np.uint32)
        if keys:
            ids[:len(keys)] = ids_from_bytes(b"".join(keys))
        valid = np.arange(cap) < len(keys)
        self._ids_dev.copy_(to_keys(ids, "cpu"))
        self._valid_dev.copy_(torch.from_numpy(valid))
        self._slots = keys + [None] * (cap - len(keys))
        self._dirty = False

    # ---------------------------------------------------------- admission
    def on_keyspace_tick(self, top: List[dict]) -> None:
        """The observatory-tick subscription (``KeyspaceObservatory.
        subscribe``): ``top`` is the tick's heavy-hitter list (dicts
        with ``_key`` canonical bytes, ``estimate``, ``hot``).  Admits
        newly-hot keys, refreshes still-hot store-backed entries,
        evicts keys that decayed out of the hot set and sweeps expired
        entries; then rolls the hit-ratio window and refreshes the
        gauges."""
        if not self.enabled:
            return
        now = self._clock()
        hot = [t for t in top if t.get("hot") and t.get("_key")]
        tr = tracing.get_tracer()
        admitted, evicted = [], []
        with self._lock:
            self._hot = set(t["_key"] for t in hot)
            # rank preserves the observatory's estimate order so the
            # capacity bound keeps the HOTTEST keys
            for t in hot[:max(1, int(self.cfg.capacity))]:
                kb = t["_key"]
                ent = self._entries.get(kb)
                values = self._pull_values(kb)
                if ent is None:
                    if values:
                        self._entries[kb] = _Entry(
                            kb, values, now + self.cfg.entry_ttl, True)
                        admitted.append((kb, t))
                        self._dirty = True
                    # a hot key with no local values stays un-admitted;
                    # offer() fills it when a get completes
                elif values:
                    # refresh from the store while hot: the TTL only
                    # ever expires entries with no local backing
                    ent.values = values
                    ent.expires = now + self.cfg.entry_ttl
                    ent.store_backed = True
            # evict: decayed out of the hot set, past capacity, or
            # expired (fill-on-get entries whose backing never
            # materialized)
            for kb in list(self._entries):
                ent = self._entries[kb]
                if kb not in self._hot or ent.expires <= now:
                    del self._entries[kb]
                    evicted.append(kb)
                    self._dirty = True
            while len(self._entries) > max(1, int(self.cfg.capacity)):
                kb = min(self._entries,
                         key=lambda k: self._entries[k].hits)
                del self._entries[kb]
                evicted.append(kb)
                self._dirty = True
            # prune freshness tokens to the hot set: every observed put
            # bumps a key's sequence, and only keys that can be offered
            # (hot ones) need their history kept across the tick
            self._inval_seq = {kb: s for kb, s in self._inval_seq.items()
                               if kb in self._hot}
            # roll the hit-ratio window
            probes = self._win_hits + self._win_misses
            self._ratio = (self._win_hits / probes) if probes else None
            self._win_hits = self._win_misses = 0
        if admitted:
            self._m_admit.inc(len(admitted))
            if tr.enabled:
                for kb, t in admitted:
                    tr.event("cache_admit", node=self.node, key=kb.hex(),
                             estimate=t.get("estimate"),
                             share=t.get("share"))
        if evicted:
            self._m_evict.inc(len(evicted))
        self._export_gauges()

    def _pull_values(self, kb: bytes) -> list:
        if self._local_values is None:
            return []
        try:
            return list(self._local_values(kb) or [])
        except Exception:
            log.exception("hot-cache local-value pull failed")
            return []

    def offer_token(self, key) -> int:
        """The key's current invalidation sequence — capture it BEFORE
        starting a get whose completion may :meth:`offer`; the offer is
        rejected if an invalidate bumped the sequence in between (the
        observed values predate the put)."""
        with self._lock:
            return self._inval_seq.get(bytes(key), 0)

    def offer(self, key, values: list,
              token: Optional[int] = None) -> bool:
        """Fill-on-get (the Kademlia lookup-path caching move): a
        completed get observed values for ``key`` — admit them if the
        key is currently hot and not yet cached.  ``token`` (from
        :meth:`offer_token` at get start) guards freshness: a stale
        token means a put invalidated the key mid-get and these values
        must not re-enter.  Returns True when the offer was taken."""
        if not self.enabled or not values:
            return False
        kb = bytes(key)
        with self._lock:
            if kb not in self._hot or kb in self._entries:
                return False
            if token is not None and token != self._inval_seq.get(kb, 0):
                return False
            self._entries[kb] = _Entry(
                kb, list(values), self._clock() + self.cfg.entry_ttl,
                False)
            self._dirty = True
        self._m_admit.inc()
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("cache_admit", node=self.node, key=kb.hex(),
                     source="get_fill")
        self._export_gauges()
        return True

    def wants(self, key) -> bool:
        """Whether :meth:`offer` would take values for this key (a hot,
        not-yet-cached key) — the get path's cheap pre-check."""
        if not self.enabled:
            return False
        kb = bytes(key)
        with self._lock:
            return kb in self._hot and kb not in self._entries

    # --------------------------------------------------------- freshness
    def invalidate(self, key) -> bool:
        """An observed put landed on ``key``: drop the cached entry so
        the NEXT get takes the full path (and re-admission re-reads the
        store) — a stale hit is never served.  Called from
        ``Dht.storage_store`` (local puts, incoming announces) and
        ``Dht.put`` (the origin side, even when the local store
        rejects)."""
        if not self.enabled:
            return False
        kb = bytes(key)
        with self._lock:
            # bump the freshness token even when nothing is cached: an
            # in-flight get's offer must also be rejected when the put
            # lands between admission windows
            self._inval_seq[kb] = self._inval_seq.get(kb, 0) + 1
            ent = self._entries.pop(kb, None)
            if ent is not None:
                self._dirty = True
        if ent is None:
            return False
        self._m_inval.inc()
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("cache_invalidate", node=self.node, key=kb.hex())
        self._export_gauges()
        return True

    # ------------------------------------------------------------ serving
    def probe_wave(self, targets, eligible) -> List[Optional[list]]:
        """ONE batched XOR-compare launch over a wave's targets
        (``ops/cache_probe.py``): returns per-target cached value lists
        (None = miss or ineligible).  Only ELIGIBLE targets (pure-get
        refills — the caller decides) are served and counted; the rest
        ride along in the same launch uncounted.  Any device failure
        goes dark: every target reports miss and the cache disables —
        the wave proceeds unchanged, serving is never blocked."""
        n = len(targets)
        out: List[Optional[list]] = [None] * n
        if not self.active() or not self._ensure_device():
            return out
        try:
            with self._lock:
                if self._dirty or self._ids_dev is None:
                    self._rebuild_device_locked()
                ids_dev, valid_dev = self._ids_dev, self._valid_dev
                slots = list(self._slots)
            hit, slot = cache_probe(ids_dev, valid_dev,
                                    ids_from_hashes(targets))
            hit = hit.cpu().numpy()
            slot = slot.cpu().numpy()
        except Exception:
            log.exception("hot-cache probe failed; disabling")
            with self._lock:
                self._go_dark_locked()
            self._export_gauges()
            return out
        hits = misses = 0
        with self._lock:
            for i in range(n):
                if not eligible[i]:
                    continue
                ent = None
                if hit[i]:
                    kb = slots[int(slot[i])]
                    # re-check the host dict: an invalidate between the
                    # table rebuild and this scatter must win (freshness
                    # beats the stale device row)
                    ent = self._entries.get(kb) if kb is not None else None
                if ent is not None:
                    ent.hits += 1
                    out[i] = list(ent.values)
                    hits += 1
                else:
                    misses += 1
            self._win_hits += hits
            self._win_misses += misses
        if hits:
            self._m_hits.inc(hits)
        if misses:
            self._m_misses.inc(misses)
        return out

    def serve_one(self, key) -> Optional[list]:
        """Per-op membership test for the batching-off escape hatch
        (``Dht._refill`` when the wave builder is disabled): the host
        dict IS the device table's source of truth, so the decision is
        identical to :meth:`probe_wave`'s (pinned vs the probe_host
        oracle in the JAX package's tests/test_hotcache.py)."""
        if not self.active():
            return None
        kb = bytes(key)
        with self._lock:
            ent = self._entries.get(kb)
            if ent is not None:
                ent.hits += 1
                self._win_hits += 1
                vals = list(ent.values)
            else:
                self._win_misses += 1
                vals = None
        (self._m_hits if vals is not None else self._m_misses).inc()
        return vals

    # --------------------------------------------------- replica widening
    def is_hot(self, key) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            return bytes(key) in self._hot

    def replica_k(self, key) -> int:
        """The adaptive replica set for ``key``: ``widen_k`` (16) while
        the key is in the observatory's hot set, ``base_k`` (8)
        otherwise — announce walks and the calendar-binned republish
        resolve consult this, so hot keys widen and narrow back on
        decay (pinned vs a scalar oracle in the JAX package's
        tests/test_hotcache.py)."""
        return self.cfg.widen_k if self.is_hot(key) else self.cfg.base_k

    # ---------------------------------------------------------- read side
    def hit_ratio(self) -> Optional[float]:
        """Last completed window's hit ratio (None = unknown: disabled,
        dark, or no probes in the window) — the ``cache_hit_ratio``
        health-signal source and the ``dht_cache_hit_ratio`` gauge."""
        if not self.enabled:
            return None
        with self._lock:
            return self._ratio

    def _export_gauges(self) -> None:
        with self._lock:
            occ = len(self._entries)
            ratio = self._ratio
            widened = len(self._hot)
        self._m_occ.set(occ)
        self._m_ratio.set(-1.0 if ratio is None else ratio)
        self._m_widened.set(widened)

    def snapshot(self) -> dict:
        """JSON-able cache state — the proxy ``GET /cache`` body, the
        ``cache`` REPL command and the scanner section."""
        with self._lock:
            entries = [{
                "key": ent.key.hex(),
                "values": len(ent.values),
                "hits": ent.hits,
                "store_backed": ent.store_backed,
                "ttl_s": round(ent.expires - self._clock(), 1),
            } for ent in sorted(self._entries.values(),
                                key=lambda e: -e.hits)]
            ratio = self._ratio
            hot = [kb.hex() for kb in self._hot]
        if not self.cfg.enabled:
            return {"enabled": False}
        return {
            "enabled": bool(self.enabled),
            "capacity": self.cfg.capacity,
            "occupancy": len(entries),
            "entry_ttl_s": self.cfg.entry_ttl,
            "hit_ratio": (round(ratio, 4) if ratio is not None else None),
            "hits": int(self._m_hits.value),
            "misses": int(self._m_misses.value),
            "admissions": int(self._m_admit.value),
            "evictions": int(self._m_evict.value),
            "invalidations": int(self._m_inval.value),
            "replica_k": {"base": self.cfg.base_k,
                          "widened": self.cfg.widen_k},
            "hot_keys": hot,
            "entries": entries,
        }
