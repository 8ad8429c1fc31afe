"""Wave-scale listen/push: the device-resident listener table.

The port of the JAX package's ``listeners.py``, with its behaviour
unchanged.  Lookups ride ``[Q]`` ingest waves and hot gets are served
from one XOR-compare probe; this layer batches the last per-put host
probe on the hot path — which stored puts have listeners — the fan-out
the reference's proxy layer exists for (``DhtProxyServer`` push,
``Dht::storageChanged`` → ``tell_listener``):

- :class:`ListenerTable` — a bounded table of canonical 20-byte key
  ids (``[L, 5]`` int32 keys on the node's device — the operand of
  ``ops/listener_match.py``) tracking exactly the keys that currently
  have ≥1 listener (local API listeners, remote ``(node, sid)``
  sockets — ``runtime/dht.py`` syncs the per-key count on every
  listener mutation).  Slots are append+tombstone+compact, the
  ``ops/sorted_table.py`` churn discipline: a cancelled/expired key
  tombstones its row (``valid=False`` — never matches), and compaction
  re-packs live rows when tombstones pile past the threshold.  Keys
  past capacity overflow to a host-side set (matched by dict, so
  correctness never depends on fitting).
- **Delivery batching** — with ``listen_batching="on"``,
  ``Dht._storage_changed`` buffers each stored put here instead of
  probing listeners synchronously; the next ingest wave (or the flush
  deadline, whichever first) answers membership for the WHOLE buffer
  in ONE ``listener_match`` pass, and the Dht dispatches one coalesced
  callback / ``tell_listener`` per wave per listener — same values,
  same per-listener order as the synchronous path, just fewer
  dispatches (the JAX package pins this in its tests/test_listener.py).
- **Go-dark on device failure**: any exception in the match disables
  the table, clears its state, reports unknown (-1) gauges — and hands
  the in-flight buffer back for HOST delivery, so a dead device can
  delay a delivery by one flush but never lose one.
  ``listen_batching="off"`` is the escape hatch: the synchronous path,
  no table, no match.

Surfaces: ``dht_listener_*`` occupancy/match/delivery-latency series
on the port's registry and history ring, and
``DhtRunner.get_listeners()``.

The host mirror of the table is numpy; the device copy lives on the
node's device (``device=``, None = the card), allocated once and
rewritten in place at the flush that finds the mirror dirty.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from . import telemetry
from .ops.ids import N_LIMBS, ids_from_bytes, to_keys
from .ops.listener_match import listener_match

log = logging.getLogger("opendht_tpu_torch.listeners")

__all__ = ["ListenerTableConfig", "ListenerTable"]


# ========================================================== configuration
@dataclass
class ListenerTableConfig:
    """Declarative listener-table configuration (lives on
    ``runtime.config.Config.listeners``; the ``listen_batching``
    on/off switch is a top-level Config field, mirroring
    ``ingest_batching``)."""

    #: master switch for the table itself; off = no device table, no
    #: metrics, every delivery synchronous (identical results — the
    #: table only batches dispatches, it never changes what a listener
    #: receives)
    enabled: bool = True
    #: bounded table slots (canonical 20-byte key ids on device);
    #: keys with listeners beyond it overflow to a host-side set, so
    #: capacity bounds device memory, never correctness
    capacity: int = 1024
    #: max seconds a table entry may sit without a listener-count
    #: re-sync before the flush sweep re-checks it against the live
    #: store (remote listeners silently expire NODE_EXPIRE_TIME after
    #: their last refresh — the sweep is how their rows leave the
    #: table without an explicit cancel)
    entry_ttl: float = 600.0
    #: max seconds a buffered stored-put may wait for an ingest wave
    #: before a deadline flush delivers it anyway (idle nodes still
    #: deliver promptly; busy nodes piggyback on the wave cadence)
    flush_deadline: float = 0.01
    #: buffered puts that force an immediate flush (bounds host memory
    #: under a put flood between waves)
    buffer_max: int = 4096
    #: tombstone count that triggers compaction at the next flush
    #: (also compacts when live rows can't otherwise fit — the
    #: sorted_table churn discipline: append+tombstone, re-pack when
    #: the wasted lanes matter)
    compact_min: int = 64


# ============================================================== the table
class ListenerTable:
    """Bounded device key-id table + host delivery buffer (module
    docstring).  One per :class:`~opendht_tpu_torch.runtime.dht.Dht`
    (``dht.listener_table``); standalone construction is the unit-test
    surface — call :meth:`sync_key`/:meth:`note_stored`/:meth:`flush`
    manually."""

    def __init__(self, cfg: Optional[ListenerTableConfig] = None, *,
                 node: str = "", batching: str = "on",
                 live_count: Optional[Callable[[bytes], int]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 request_flush: Optional[Callable[[float], None]] = None,
                 device=None):
        """``live_count(key_bytes) -> int`` re-counts a key's live
        listeners at TTL-sweep time (``runtime/dht.py`` wires the
        storage walk); ``request_flush(delay_s)`` asks the owner to
        run :meth:`flush` within ``delay_s`` seconds (the Dht arms a
        scheduler job); ``clock`` defaults to a monotonic host clock
        (nodes pass ``scheduler.time``); ``device``: where the device
        copy of the table lives (None = the CUDA card)."""
        import time as _time
        self.cfg = cfg or ListenerTableConfig()
        self.batching = batching
        self.node = node
        self._labels = {"node": node} if node else {}
        self._live_count = live_count
        self._clock = clock or _time.monotonic
        self._request_flush = request_flush
        self._device = device
        self._lock = threading.Lock()
        cap = max(1, int(self.cfg.capacity))
        # host mirror of the device table, maintained incrementally —
        # only a DIRTY table is re-pushed to device, and only at flush
        # (listener churn between flushes costs numpy row writes, not
        # transfers)
        self._ids = np.zeros((cap, N_LIMBS), np.uint32)
        self._valid = np.zeros((cap,), bool)
        self._slot_of: Dict[bytes, int] = {}
        self._expires: Dict[bytes, float] = {}
        self._top = 0                 # first never-used slot
        self._tombstones = 0
        self._overflow: set = set()   # keys past capacity (host-matched)
        self._dirty = True
        # delivery buffer: key -> [(value, new_value)] in arrival
        # order (dict preserves both key and per-key value order — the
        # per-listener ordering guarantee rides on it)
        self._buf: Dict[bytes, List[Tuple[object, bool]]] = {}
        self._buf_t0: Dict[bytes, float] = {}
        # device state (lazy; a failed backend goes dark)
        self._device_ok: "bool | None" = None if self._tracking else False
        self._ids_dev = None
        self._valid_dev = None
        # windowed delivery-lag samples (rolled on the history frame —
        # the dht_listener_lag_p95 gauge reads the LAST window, the
        # dhtmon --max-imbalance lesson applied to delivery latency)
        self._win_lags: List[float] = []
        self._lag_p95: Optional[float] = None
        # metric handles only for an ACTIVE table — a disabled/off
        # component must never register permanently-zero series (the
        # zero-series rule)
        if self._tracking:
            reg = telemetry.get_registry()
            self._m_occ = reg.gauge("dht_listener_occupancy", **self._labels)
            self._m_tomb = reg.gauge("dht_listener_tombstones",
                                     **self._labels)
            self._m_lag = reg.gauge("dht_listener_lag_p95", **self._labels)
            reg.gauge("dht_listener_capacity", **self._labels).set(cap)
            self._m_matches = reg.counter("dht_listener_matches_total",
                                          **self._labels)
            self._m_misses = reg.counter("dht_listener_misses_total",
                                         **self._labels)
            self._m_flushes = reg.counter("dht_listener_flushes_total",
                                          **self._labels)
            self._m_deliv = reg.counter("dht_listener_deliveries_total",
                                        **self._labels)
            self._m_values = reg.counter("dht_listener_values_total",
                                         **self._labels)
            self._m_compact = reg.counter("dht_listener_compactions_total",
                                          **self._labels)
            self._m_match_s = reg.histogram("dht_listener_match_seconds",
                                            **self._labels)
            self._m_deliv_s = reg.histogram("dht_listener_delivery_seconds",
                                            **self._labels)
            self._m_occ.set(0)
            self._m_tomb.set(0)
            self._m_lag.set(-1.0)     # -1 = unknown (no window yet)

    # ------------------------------------------------------------- state
    @property
    def _tracking(self) -> bool:
        """Whether this table participates at all (config-level)."""
        return self.cfg.enabled and self.batching != "off"

    @property
    def enabled(self) -> bool:
        """Config-on AND the device hasn't gone dark — when False,
        ``note_stored`` refuses the buffer and every delivery takes
        the synchronous host path (the escape-hatch semantics)."""
        return self._tracking and self._device_ok is not False

    def pending(self) -> int:
        return len(self._buf)

    def tracked(self) -> int:
        with self._lock:
            return len(self._slot_of) + len(self._overflow)

    # ------------------------------------------------------------- device
    @staticmethod
    def _pack(kb: bytes) -> np.ndarray:
        """Big-endian uint32 limbs for ONE canonical 20-byte key —
        the incremental-row mirror of ``ops.ids.ids_from_bytes``
        (the JAX package pins it bit-identical in its
        tests/test_listener.py; inlined as there)."""
        b = np.frombuffer(kb, dtype=np.uint8).astype(np.uint32)
        b = b.reshape(N_LIMBS, 4)
        return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]

    def _ensure_device(self) -> bool:
        if self._device_ok is not None:
            return self._device_ok
        try:
            cap = self._ids.shape[0]
            self._ids_dev = to_keys(self._ids, self._device)
            self._valid_dev = torch.zeros(cap, dtype=torch.bool,
                                          device=self._ids_dev.device)
            self._dirty = True
            self._device_ok = True
        except Exception:
            log.warning("listener match unavailable (device %s does not "
                        "work); batched delivery disabled", self._device,
                        exc_info=True)
            self._device_ok = False
        return self._device_ok

    def _go_dark_locked(self) -> None:
        """Device failure mid-match: disable AND clear every row
        (callers hold the lock) — a dead table must report unknown and
        hand delivery back to the host path, never serve a frozen
        membership set (the hotcache go-dark contract)."""
        self._device_ok = False
        self._slot_of.clear()
        self._expires.clear()
        self._overflow.clear()
        self._valid[:] = False
        self._top = 0
        self._tombstones = 0
        self._ids_dev = self._valid_dev = None
        self._win_lags = []
        self._lag_p95 = None
        self._dirty = True
        if self._tracking:
            self._m_occ.set(-1.0)
            self._m_tomb.set(-1.0)
            self._m_lag.set(-1.0)

    # ----------------------------------------------------------- registry
    def sync_key(self, kb: bytes, count: int) -> None:
        """Re-sync one key's listener count after a mutation
        (``runtime/dht.py`` calls this from listen/cancel/remote-add/
        expiry — every site that changes a Storage's listener sets).
        ``count > 0`` ensures the key has a live row (or overflow
        membership) and refreshes its TTL; ``count == 0`` tombstones
        it."""
        if not self.enabled:
            return
        with self._lock:
            if count > 0:
                self._insert_locked(kb)
            else:
                self._remove_locked(kb)
        self._export_gauges()

    def _insert_locked(self, kb: bytes) -> None:
        now = self._clock()
        if kb in self._slot_of:
            self._expires[kb] = now + self.cfg.entry_ttl
            return
        if kb in self._overflow:
            return
        cap = self._ids.shape[0]
        if self._top >= cap and self._tombstones > 0:
            self._compact_locked()
        if self._top < cap:
            slot = self._top
            self._top += 1
            self._ids[slot] = self._pack(kb)
            self._valid[slot] = True
            self._slot_of[kb] = slot
            self._expires[kb] = now + self.cfg.entry_ttl
            self._dirty = True
        else:
            self._overflow.add(kb)

    def _remove_locked(self, kb: bytes) -> None:
        slot = self._slot_of.pop(kb, None)
        self._expires.pop(kb, None)
        if slot is not None:
            self._valid[slot] = False
            self._tombstones += 1
            self._dirty = True
            if self._overflow:
                # a slot freed up (after compaction) — promote an
                # overflow key so capacity pressure self-heals
                self._insert_locked(self._overflow.pop())
        else:
            self._overflow.discard(kb)

    def _compact_locked(self) -> None:
        """Re-pack live rows to the front (the sorted_table churn
        discipline: tombstones accumulate cheaply, one compaction
        amortizes them away).  Slots move; the device copy is rebuilt
        at the next flush."""
        keys = list(self._slot_of)
        self._valid[:] = False
        for i, kb in enumerate(keys):
            self._ids[i] = self._pack(kb)
            self._valid[i] = True
            self._slot_of[kb] = i
        self._top = len(keys)
        self._tombstones = 0
        self._dirty = True
        if self._tracking:
            self._m_compact.inc()

    def _sweep_locked(self) -> None:
        """TTL sweep at flush time: entries past ``entry_ttl`` without
        a re-sync are re-counted against the live store (remote
        listeners expire silently — no cancel reaches sync_key) and
        refreshed or tombstoned; then compaction if tombstones piled
        past the threshold."""
        now = self._clock()
        stale = [kb for kb, t in self._expires.items() if t <= now]
        for kb in stale:
            n = 0
            if self._live_count is not None:
                try:
                    n = int(self._live_count(kb) or 0)
                except Exception:
                    log.exception("listener live-count probe failed")
            if n > 0:
                self._expires[kb] = now + self.cfg.entry_ttl
            else:
                self._remove_locked(kb)
        if self._tombstones > max(int(self.cfg.compact_min),
                                  len(self._slot_of) // 4):
            self._compact_locked()

    # ----------------------------------------------------------- buffering
    def note_stored(self, kb: bytes, value, new_value: bool) -> bool:
        """Buffer one stored put for the next wave's match launch.
        Returns True when buffered (the caller defers delivery) or
        False when the synchronous path must run NOW (batching off,
        table disabled, or gone dark) — the Dht branches on this, so
        go-dark degrades to the exact synchronous behavior."""
        if not self.enabled:
            return False
        if not self._slot_of and not self._overflow:
            # nobody listens on ANY key right now: the synchronous
            # path would walk empty dicts to the same no-delivery end
            # — skip buffer, launch and flush job entirely (an idle
            # table must not tax the put path; the <1% overhead
            # capture rides on this).  Unlocked read is safe: all
            # mutations run on the DHT thread.
            return True
        arm: Optional[float] = None
        with self._lock:
            items = self._buf.get(kb)
            if items is None:
                self._buf[kb] = [(value, new_value)]
                self._buf_t0[kb] = self._clock()
                if len(self._buf) == 1:
                    arm = self.cfg.flush_deadline
            else:
                items.append((value, new_value))
            if len(self._buf) >= max(1, int(self.cfg.buffer_max)):
                arm = 0.0
        if arm is not None and self._request_flush is not None:
            try:
                self._request_flush(arm)
            except Exception:
                log.exception("listener flush arm failed")
        return True

    # -------------------------------------------------------------- flush
    def flush(self) -> List[Tuple[bytes, List[Tuple[object, bool]]]]:
        """Answer membership for the whole buffer in ONE
        ``listener_match`` launch and hand back ``[(key_bytes,
        [(value, new_value), ...]), ...]`` — exactly the puts whose
        key currently has listeners, in arrival order, for the Dht to
        dispatch coalesced.  Any device failure goes dark and returns
        the ENTIRE buffer (host fallback): a delivery can be late,
        never lost."""
        with self._lock:
            if not self._buf:
                return []
            buf, t0s = self._buf, self._buf_t0
            self._buf, self._buf_t0 = {}, {}
            if not self.enabled:
                # dark between buffer and flush: everything falls back
                return list(buf.items())
            self._sweep_locked()
            n_live = len(self._slot_of)
            overflow = set(self._overflow)
        if not self._ensure_device():
            return list(buf.items())
        keys = list(buf)
        if n_live == 0:
            # nobody listens on-table: the launch would answer all-miss
            # — skip it (an idle table must not cost the wave a launch,
            # the hotcache active() rule); overflow still matches host-side
            hit = np.zeros(len(keys), bool)
        else:
            import time as _time
            try:
                with self._lock:
                    if self._dirty:
                        # rewrite the device copy in place
                        self._ids_dev.copy_(to_keys(self._ids, "cpu"))
                        self._valid_dev.copy_(torch.from_numpy(self._valid))
                        self._dirty = False
                    ids_dev, valid_dev = self._ids_dev, self._valid_dev
                stored = ids_from_bytes(b"".join(keys))
                t_launch = _time.time()
                hit, _slot = listener_match(ids_dev, valid_dev, stored)
                hit = hit.cpu().numpy()
                self._m_match_s.observe(max(0.0, _time.time() - t_launch))
            except Exception:
                log.exception("listener match failed; going dark "
                              "(synchronous delivery from here on)")
                with self._lock:
                    self._go_dark_locked()
                return list(buf.items())
        self._m_flushes.inc()
        now = self._clock()
        out: List[Tuple[bytes, List[Tuple[object, bool]]]] = []
        hits = misses = 0
        lags: List[float] = []
        for i, kb in enumerate(keys):
            if bool(hit[i]) or kb in overflow:
                out.append((kb, buf[kb]))
                hits += 1
                lags.append(max(0.0, now - t0s.get(kb, now)))
            else:
                misses += 1
        if hits:
            self._m_matches.inc(hits)
            for lag in lags:
                self._m_deliv_s.observe(lag)
            with self._lock:
                self._win_lags.extend(lags)
        if misses:
            self._m_misses.inc(misses)
        self._export_gauges()
        return out

    def note_delivered(self, dispatches: int, values: int) -> None:
        """Post-dispatch accounting from the Dht: ``dispatches``
        coalesced callback/tell_listener/push dispatches fanned
        ``values`` value deliveries this flush."""
        if not self._tracking:
            return
        if dispatches:
            self._m_deliv.inc(dispatches)
        if values:
            self._m_values.inc(values)

    # ---------------------------------------------------------- read side
    def frame_tick(self) -> None:
        """History-ring frame hook: roll the windowed delivery-lag p95
        into the ``dht_listener_lag_p95`` gauge (-1 = no deliveries in
        the window — unknown never violates the dhtmon gate)."""
        if not self._tracking:
            return
        with self._lock:
            lags = self._win_lags
            self._win_lags = []
        if lags and self._device_ok is not False:
            lags.sort()
            self._lag_p95 = lags[min(len(lags) - 1,
                                     int(0.95 * len(lags)))]
        else:
            self._lag_p95 = None
        self._m_lag.set(-1.0 if self._lag_p95 is None else self._lag_p95)

    def lag_p95(self) -> Optional[float]:
        """Last completed window's delivery-lag p95 (None = unknown)."""
        return self._lag_p95 if self.enabled else None

    def _export_gauges(self) -> None:
        if not self._tracking or self._device_ok is False:
            return
        with self._lock:
            occ = len(self._slot_of) + len(self._overflow)
            tomb = self._tombstones
        self._m_occ.set(occ)
        self._m_tomb.set(tomb)

    def snapshot(self) -> dict:
        """JSON-able table state — the proxy ``GET /listeners`` body,
        the ``listeners`` REPL command and the scanner section."""
        if not self.cfg.enabled or self.batching == "off":
            return {"enabled": False, "batching": self.batching}
        with self._lock:
            occ = len(self._slot_of)
            overflow = len(self._overflow)
            tomb = self._tombstones
            buf = len(self._buf)
            now = self._clock()
            entries = [{"key": kb.hex(),
                        "ttl_s": round(self._expires.get(kb, now) - now, 1)}
                       for kb in sorted(
                           self._slot_of,
                           key=lambda k: self._expires.get(k, now))[:32]]
        dark = self._device_ok is False
        return {
            "enabled": bool(self.enabled),
            "batching": self.batching,
            "dark": dark,
            "capacity": int(self.cfg.capacity),
            "occupancy": (-1 if dark else occ),
            "overflow": overflow,
            "tombstones": (-1 if dark else tomb),
            "buffered": buf,
            "entry_ttl_s": self.cfg.entry_ttl,
            "flush_deadline_s": self.cfg.flush_deadline,
            "matches": int(self._m_matches.value),
            "misses": int(self._m_misses.value),
            "flushes": int(self._m_flushes.value),
            "deliveries": int(self._m_deliv.value),
            "values_delivered": int(self._m_values.value),
            "compactions": int(self._m_compact.value),
            "lag_p95_s": self._lag_p95,
            "entries": entries,
        }
