"""Continuous-batching ingest: coalesce live lookups into shared waves.

The port of the JAX package's ``runtime/wave_builder.py``, with its
behaviour unchanged but for two points.  A wave's launch is
``Dht.find_closest_nodes_launch``, whose handle's ``ready()`` is the
port's CUDA-event probe (``core/table.py`` ``PendingLookup.ready``:
``event.query()``, no host sync), so the drainer polls the card the way
the JAX builder polls an async dispatch.  And the ``dht.search.wave``
span carries no device-cost attributes: the JAX builder takes them from
its XLA cost ledger (``profiling.ingest_wave_attrs``), which has no
torch counterpart yet.  The planes' hooks are the JAX builder's: the
keyspace observatory sees each wave's targets, the hot-value cache's
probe serves cached gets before the launch, and the buffered stored
puts ride each fire's listener flush.  The resharding plane's hook (the
boundary generation a wave ran on) is left out with the plane: every
wave reports generation 0, the uniform split.

Five rounds of kernel work made the device side of a lookup a ``[Q]``
wave (``find_closest_nodes_batched`` → one lane-padded top-k launch for
*many* targets), but live traffic never fed it one: every proxy/REST
request, UDP op and embedder ``get/put/listen`` reached the table
through a per-search refill — a Q=1 launch paying the full 128-lane
padding tax per op.  Benchmarks batched; the service did not.

This module is the ingest layer that closes that gap (ROADMAP item 2),
the same iteration-level insight that made continuous batching the
serving architecture for LLM engines (Orca-style: admit work
mid-flight, keep launches full, never barrier a wave on its slowest
member):

- :class:`WaveBuilder` owns a bounded admission queue of pending
  closest-node lookups (search refills, from ALL traffic sources — the
  runner op queue, the proxy server, the UDP reply path's search
  stepping).  A wave fires when the queue reaches the **fill target Q**
  or when the oldest entry has waited the **deadline knob** (1–5 ms,
  both ``runtime/config.py`` fields), whichever comes first — one
  ``find_closest_nodes_batched`` launch per (family, k) group, results
  scattered back to each search's callback.  An op that joins after a
  wave departed simply rides the next one at whatever round it is on:
  continuous batching, not stop-and-go batch barriers.
- **Backpressure sheds at admission, never mid-search**: NEW ops are
  refused (``admit``) when the queue exceeds ``ingest_queue_max`` or
  the optional ``ingest_admit_per_sec`` sliding-window quota (the same
  :class:`~opendht_tpu.rate_limiter.RateLimiter` the net engine's
  ingress path uses, and the same counted-drop discipline as its
  ``dht_net_ratelimit_drops_total``) — an admitted search's refills
  are always queued, so backpressure can never fail an in-flight
  search.
- ``ingest_batching="off"`` is the escape hatch: ``submit`` resolves
  synchronously through the identical per-op ``[1]`` launch the
  per-op path issued — pinned result-equivalent in
  tests/test_wave_builder.py and the burst-ingest CI smoke
  (testing/ingest_smoke.py).
- **Depth-2+ wave pipeline** (``ingest_pipeline_depth``):
  wave N's ``[Q]`` launch is dispatched *asynchronously*
  (``Dht.find_closest_nodes_launch`` — an async launch; the
  blocking transfer is deferred into the handle's ``consume()``), so
  the builder fills wave N+1 from the admission queue while N runs on
  device and drains wave N−1's scatter fan-out from a dedicated
  drainer job — host callback loops never sit between two launches.
  A wave whose handle is already ready at launch time (the host-scan
  regime: live-protocol tables) drains inline, so small-table latency
  is exactly the depth-1 path's.  ``ingest_pipeline_depth=1`` is the
  escape hatch (launch→block→scatter inline, the exact unpipelined
  behavior); depth 2+ is pinned bit-identical to depth 1 on results,
  listener deliveries and exported storage
  (tests/test_wave_builder.py, testing/pipeline_smoke.py).
  In-flight waves are visible as the ``dht_ingest_pipeline_inflight``
  gauge (+ ``_peak``) and the per-wave ``pipeline_slot`` attr on the
  ``dht.search.wave`` ingest span.
- Observability on the telemetry/tracing spine: ``dht_ingest_queue_depth``
  gauge, ``dht_ingest_wave_occupancy`` / ``dht_ingest_queue_seconds`` /
  ``dht_ingest_wave_seconds`` histograms, shed/wave/op counters, a
  ``dht.search.wave`` (mode="ingest") trace span per launch with each
  carried op's ``dht.ingest.op`` span linked to it.

Threading: the builder lives on the DHT thread like everything else in
``runtime/dht.py`` — submissions come from posted closures, packet
handlers and scheduler jobs, and the wave trigger is itself a scheduler
job, so there are no locks and no re-entrancy (a fill-triggered wave
fires on the *next* scheduler pump, never synchronously inside the
submit that filled it).

Reference mapping: ``DhtRunner::loop_`` (dhtrunner.cpp:387-445) drains
all pending op *closures* onto one thread per pump — coalescing in
time, op by op.  The TPU design deliberately diverges: we coalesce the
ops' *device lookups* onto one launch (coalescing in the lane
dimension), because here the padded launch — not the thread hop — is
the per-op tax.  See PARITY.md "Continuous-batching ingest".
"""

from __future__ import annotations

import logging
import time as _time
from collections import deque
from typing import Callable, List

from .. import telemetry, tracing, waterfall
from ..infohash import InfoHash
from ..pipeline_observatory import PipelineObservatory, PipelineObservatoryConfig
from ..rate_limiter import RateLimiter

log = logging.getLogger("opendht_tpu_torch.ingest")

#: failed-launch re-queues per entry before scattering empty (a
#: transient device error retries on later waves; a persistent one
#: fails the carried ops honestly after this many attempts)
_LAUNCH_RETRIES = 2


class _Entry:
    """One queued lookup: target → per-search scatter callback.

    ``t_enq`` is scheduler time (drives the deadline trigger);
    ``t_wall`` is the wall clock at submit — the honest enqueue stamp
    for the time-in-queue histogram and the ``dht.ingest.op`` span.
    The two deliberately differ: the runner drains op closures BEFORE
    ``periodic()`` re-syncs the scheduler clock, so scheduler time at
    submit can be stale by a whole sleep — reconstructing span starts
    from it put a child span seconds before its parent (caught by the
    cross-node assembler's monotonicity check)."""

    __slots__ = ("target", "af", "k", "cb", "t_enq", "t_wall", "ctx",
                 "kind", "retries", "cache_cb")

    def __init__(self, target: InfoHash, af: int, k: int, cb: Callable,
                 t_enq: float, t_wall: float, ctx, kind: str,
                 cache_cb: "Callable | None" = None):
        self.target = target
        self.af = af
        self.k = k
        self.cb = cb
        self.t_enq = t_enq
        self.t_wall = t_wall
        self.ctx = ctx
        self.kind = kind
        self.retries = 0              # failed-launch re-queues so far
        # non-None marks a CACHE-ELIGIBLE entry (a pure-get refill) — a
        # hot-cache probe hit calls cache_cb(values) and the entry never
        # joins the lookup launch
        self.cache_cb = cache_cb


class _InflightWave:
    """One dispatched-but-not-consumed wave (the pipeline's):
    everything the drain step needs to scatter exactly as the
    synchronous path would have — including the per-launch shard width
    (on the handle) and the dispatch stamp/cost, so the waterfall's
    device stage can be observed at consume."""

    __slots__ = ("af", "k", "entries", "handle", "t_dispatch",
                 "dispatch_s", "t_pick", "probe_s", "slot", "seq")

    def __init__(self, af: int, k: int, entries: List[_Entry], handle,
                 t_dispatch: float, dispatch_s: float, t_pick: float,
                 probe_s: float, slot: int, seq: int = -1):
        self.af = af
        self.k = k
        self.entries = entries
        self.handle = handle          # runtime/dht.py BatchedResolve
        self.t_dispatch = t_dispatch  # wall clock at dispatch
        self.dispatch_s = dispatch_s  # host cost of the async dispatch
        self.t_pick = t_pick          # wall clock at wave pickup
        self.probe_s = probe_s        # cache-probe share of this wave
        self.slot = slot              # waves already in flight at launch
        self.seq = seq                # pipeline-observatory wave id


class WaveBuilder:
    """Fill-or-deadline-triggered aggregator over
    ``Dht.find_closest_nodes_batched`` (see module docstring)."""

    def __init__(self, dht, config):
        self._dht = dht
        self.enabled = getattr(config, "ingest_batching", "on") != "off"
        self.fill_target = max(1, int(
            getattr(config, "ingest_fill_target", 64)))
        self.deadline = float(getattr(config, "ingest_deadline", 0.002))
        self.queue_max = int(getattr(config, "ingest_queue_max", 4096))
        admit_qps = int(getattr(config, "ingest_admit_per_sec", 0) or 0)
        self._admit_limiter = (RateLimiter(admit_qps) if admit_qps > 0
                               else None)
        # waves in flight on device at once; 1 = the exact
        # pre-pipeline launch→block→scatter path (validated ≥ 1 here —
        # a zero/negative knob silently falling back to 2 would hide a
        # config typo behind the default)
        self.pipeline_depth = max(1, int(
            getattr(config, "ingest_pipeline_depth", 2) or 1))
        self._pending: deque = deque()
        self._inflight: deque = deque()   # _InflightWave, oldest first
        self._job = None              # armed scheduler Job or None
        self._drain_job = None        # armed drainer Job or None
        self._exempt = 0              # admission suspended (see exempt())
        self.waves = 0                # launches issued (cheap introspection)
        # windowed in-flight peak: high-water since the last
        # history frame; _peak_prev retains the previous frame so the
        # gauge never blinks to 0 mid-window (frame_tick rolls both)
        self.inflight_peak = 0
        self._peak_prev = 0
        # the pipeline utilization observatory — lane
        # timelines, device occupancy, bubble attribution.  Host-side
        # edge bookkeeping only; kernels stay bit-identical.
        pcfg = getattr(config, "pipeline", None)
        self.observatory = PipelineObservatory(
            pcfg if pcfg is not None else PipelineObservatoryConfig())

        reg = telemetry.get_registry()
        self._m_depth = reg.gauge("dht_ingest_queue_depth")
        self._m_inflight = reg.gauge("dht_ingest_pipeline_inflight")
        self._m_inflight_peak = reg.gauge("dht_ingest_pipeline_inflight_peak")
        self._m_inflight.set(0)
        self._m_inflight_peak.set(0)
        self._m_wave_s = reg.histogram("dht_ingest_wave_seconds")
        self._m_occupancy = reg.histogram("dht_ingest_wave_occupancy")
        self._m_queue_s = reg.histogram("dht_ingest_queue_seconds")
        self._m_waves = reg.counter("dht_ingest_waves_total")
        # waves whose resolve ran against the t-sharded table
        # (config.resolve_mesh_t) — the occupancy/latency histograms
        # above cover both modes; this counter says which mode served
        self._m_sharded_waves = reg.counter("dht_ingest_sharded_waves_total")
        self._m_ops = {}              # kind -> counter (cached handles)
        self._m_sheds = {}            # reason -> counter

    # ------------------------------------------------------------ admission
    def exempt(self):
        """Context manager: suspend admission control for internal
        continuations of ALREADY-admitted work — the proxy hot-swap
        re-registering established listeners on the new backend must
        never be shed (the subscription was admitted when it was
        created; dropping it on swap would violate the never-mid-search
        discipline)."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self._exempt += 1
            try:
                yield
            finally:
                self._exempt -= 1
        return _ctx()

    def admit(self, op: str) -> bool:
        """Admission check for a NEW public op (get/put/listen/query).
        False ⇒ the op must be refused *now*, with a counted drop —
        the only place backpressure acts, so a search that got in can
        always finish (its refills bypass this check via
        :meth:`submit`).  With batching off there is no queue to
        protect and every op is admitted (the per-op path's behavior,
        kept result-equivalent)."""
        if not self.enabled or self._exempt:
            return True
        if len(self._pending) >= self.queue_max:
            self._shed(op, "queue_full")
            return False
        if self._admit_limiter is not None and not self._admit_limiter.limit(
                self._dht.scheduler.time()):
            self._shed(op, "rate")
            return False
        return True

    def _shed(self, op: str, reason: str) -> None:
        c = self._m_sheds.get((op, reason))
        if c is None:
            c = self._m_sheds[(op, reason)] = telemetry.get_registry(
            ).counter("dht_ingest_sheds_total", op=op, reason=reason)
        c.inc()
        tr = tracing.get_tracer()
        if tr.enabled:
            tr.event("ingest_shed", op=op, reason=reason,
                     depth=len(self._pending))
        log.debug("ingest shed %s (%s, depth=%d)", op, reason,
                  len(self._pending))

    # ------------------------------------------------------------- ingest
    def submit(self, target: InfoHash, af: int, k: int,
               cb: Callable[[List], None], *, kind: str = "refill",
               cache_cb: "Callable | None" = None) -> None:
        """Queue one closest-``k`` lookup for ``target``; ``cb(nodes)``
        fires from the wave that carries it (immediately, with the
        identical per-op launch, when batching is off).  Never sheds —
        admission already happened at the op boundary.

        ``cache_cb`` marks the entry cache-eligible: the pre-launch
        hot-cache probe may serve it values instead of nodes
        (``_serve_cached``), in which case it never joins the launch."""
        if not self.enabled:
            # escape hatch: the per-op [1] launch — the keyspace
            # observatory still sees the target (its surfaces must not
            # go dark when batching is off; results are untouched)
            ks = getattr(self._dht, "keyspace", None)
            if ks is not None:
                ks.observe_hashes([target])
            cb(self._dht.find_closest_nodes_batched([target], af, k)[0])
            return
        now = self._dht.scheduler.time()
        t_wall = _time.time()
        if not self._pending:
            # queue went 0 -> 1: the next wave starts batching here —
            # the fill_start edge of its lane timeline
            self.observatory.note_fill_start(t_wall)
        self._pending.append(_Entry(target, af, k, cb, now, t_wall,
                                    tracing.current(), kind, cache_cb))
        depth = len(self._pending)
        self._m_depth.set(depth)
        c = self._m_ops.get(kind)
        if c is None:
            c = self._m_ops[kind] = telemetry.get_registry().counter(
                "dht_ingest_ops_total", kind=kind)
        c.inc()
        # fill target ⇒ pull the trigger to *now* (the next scheduler
        # pump — never synchronously inside a submit, see module doc);
        # otherwise make sure a deadline trigger covers the new oldest
        self._arm(now if depth >= self.fill_target
                  else self._pending[0].t_enq + self.deadline)

    def _arm(self, t: float) -> None:
        job = self._job
        if job is not None and not job.cancelled:
            # job.time is None while the scheduler has the job in its
            # CURRENT due sweep (run() nulls the time before executing,
            # scheduler.py) — a submit() from a sibling due job lands
            # here; the wave fires later this same sweep and drains the
            # new entry, so nothing to reschedule
            if job.time is not None and t < job.time:
                self._job = self._dht.scheduler.edit(job, t)
        else:
            self._job = self._dht.scheduler.add(t, self._fire)

    def pending(self) -> int:
        return len(self._pending)

    # --------------------------------------------------------------- waves
    def _fire(self) -> None:
        """Drain the queue into one launch per (family, k) group and
        scatter results.  Runs as a scheduler job on the DHT thread.

        With ``pipeline_depth >= 2``, launches are dispatched
        asynchronously and queue on ``_inflight``; the only blocking
        wait here is the backpressure bound (a full pipeline drains its
        oldest wave before dispatching the next).  Waves that are
        already ready at the end of the fire (host-scan resolves)
        scatter inline — everything else is left to the drainer job, so
        this fire returns to the runner loop with the device busy."""
        self._job = None
        # stored puts buffered since the last wave ride THIS fire's
        # single listener_match pass — one coalesced delivery dispatch
        # per wave per listener (runtime/dht.py flush_listener_wave; the
        # deadline job is the idle-node fallback)
        lt = getattr(self._dht, "listener_table", None)
        if lt is not None and lt.pending():
            try:
                self._dht.flush_listener_wave()
            except Exception:
                log.exception("listener wave flush failed")
        if not self._pending:
            return
        batch = list(self._pending)
        self._pending.clear()
        self._m_depth.set(0)
        wf = waterfall.get_profiler()
        if self.pipeline_depth > 1:
            # backpressure: never more than depth waves in flight — the
            # oldest wave's scatter is paid here, while its successors
            # keep the device busy
            if len(self._inflight) >= self.pipeline_depth:
                self.observatory.note_backpressure()
            while len(self._inflight) >= self.pipeline_depth:
                self._drain_one(wf)
        # waterfall: queue_wait = admission → wave pickup,
        # off the honest enqueue stamp (t_wall, see _Entry) — stamped
        # here, before the cache probe, so a cache-served op still
        # contributes its coalesce tax
        t_pick = _time.time()
        # fill_done edge: the observatory hands back this wave group's
        # fill_start and re-arms for the next (None with the plane off)
        t_fill = self.observatory.take_fill(t_pick)
        if wf.enabled:
            for e in batch:
                wf.observe("queue_wait", max(0.0, t_pick - e.t_wall),
                           exemplar=e.ctx.trace_hex if e.ctx else None)
        cache = getattr(self._dht, "hotcache", None)
        probe_s = 0.0
        n_submitted = len(batch)
        if cache is not None and cache.active():
            # time the probe ONLY when a cache is actually live — a
            # cache-off wave would flood the cache_probe histogram
            # with ~0 samples and bury the real probe's p50
            t_probe = _time.time()
            batch = self._serve_cached(batch)
            probe_s = max(0.0, _time.time() - t_probe)
            if wf.enabled:
                wf.observe("cache_probe", probe_s)
        else:
            batch = self._serve_cached(batch)
        if not batch and n_submitted:
            # the whole wave was served from cache — the device was
            # (correctly) skipped; the idle gap this opens is a
            # cache_served bubble, not starvation
            self.observatory.note_cache_served(t_fill, n_submitted)
        if batch:
            groups: dict = {}
            for e in batch:
                groups.setdefault((e.af, e.k), []).append(e)
            if self.pipeline_depth <= 1:
                for (af, k), entries in groups.items():
                    self._launch(af, k, entries, wf, t_pick, probe_s, t_fill)
                return
            for (af, k), entries in groups.items():
                self._launch_async(af, k, entries, wf, t_pick, probe_s, t_fill)
            # opportunistic same-pump drain: a wave whose handle is
            # already materialized (host-scan resolve — the live
            # protocol regime) scatters now, keeping small-table
            # latency identical to depth 1.  Never blocks.
            while self._inflight and self._inflight[0].handle.ready():
                self._drain_one(wf)
        if self._inflight:
            self._arm_drain(self._dht.scheduler.time())

    def _serve_cached(self, entries: List[_Entry]) -> List[_Entry]:
        """The serve-from-cache fast path: ONE batched
        XOR-compare (``ops/cache_probe.py``) over the wave's
        targets against the hot-value cache's device id table.  Hits
        on CACHE-ELIGIBLE entries (pure-get refills — ``cache_cb`` set)
        are served host-side values and removed from the wave; misses
        and ineligible entries fall through unchanged.  Served targets
        still feed the keyspace observatory (source="cache") — a
        cache-served key must stay in the hot window, or it would decay
        out, be evicted, and thrash back in."""
        cache = getattr(self._dht, "hotcache", None)
        if cache is None or not cache.active():
            return entries
        eligible = [e.cache_cb is not None for e in entries]
        if not any(eligible):
            return entries
        served = cache.probe_wave([e.target for e in entries], eligible)
        if not any(v is not None for v in served):
            return entries
        ks = getattr(self._dht, "keyspace", None)
        if ks is not None:
            ks.observe_hashes(
                [e.target for e, v in zip(entries, served)
                 if v is not None], source="cache")
        remaining: List[_Entry] = []
        for e, vals in zip(entries, served):
            if vals is None:
                remaining.append(e)
                continue
            try:
                e.cache_cb(vals)
            except Exception:
                log.exception("cache-serve callback failed")
        return remaining

    def _launch(self, af: int, k: int, entries: List[_Entry],
                wf=None, t_pick: "float | None" = None,
                probe_s: float = 0.0,
                t_fill: "float | None" = None) -> None:
        """Depth-1 wave: the exact pre-pipeline launch→block→scatter
        path (``ingest_pipeline_depth=1``, the escape hatch)."""
        reg = telemetry.get_registry()
        if wf is None:
            wf = waterfall.get_profiler()
        t_fire = _time.time()
        # depth-1 lifecycle: device busy exactly for the blocking
        # launch; dispatch and wait are one edge pair here
        seq = self.observatory.on_dispatch(
            t_fill, t_fire, len(entries), af, k, 0, 0)
        with reg.span("dht_ingest_wave_seconds") as sp:
            try:
                results = self._dht.find_closest_nodes_batched(
                    [e.target for e in entries], af, k)
            except Exception:
                log.exception("ingest wave launch failed (af=%d k=%d Q=%d)",
                              af, k, len(entries))
                results = None
        t_avail = _time.time()
        self.observatory.on_device_done(seq, t_avail)
        if results is None:
            entries = self._requeue_failed(entries)
            if not entries:
                # every entry requeued onto a later wave: close THIS
                # wave's lane slices now — no orphan open intervals
                self.observatory.on_scatter_done(seq, _time.time())
                return
            results = [[] for _ in entries]
        shard_t = int(getattr(self._dht, "last_resolve_shard_t", 1) or 1)
        self._scatter(af, k, entries, results, wf, t_pick, probe_s,
                      t_fire, sp.elapsed, shard_t, t_avail, slot=0,
                      obs_seq=seq)

    def _launch_async(self, af: int, k: int, entries: List[_Entry],
                      wf, t_pick: float, probe_s: float,
                      t_fill: "float | None" = None) -> None:
        """Depth-2+ wave: dispatch the ``[Q]`` launch and return with
        the kernel in flight — the scatter belongs to the drainer."""
        t_dispatch = _time.time()
        try:
            handle = self._dht.find_closest_nodes_launch(
                [e.target for e in entries], af, k)
        except Exception:
            log.exception("ingest wave launch failed (af=%d k=%d Q=%d)",
                          af, k, len(entries))
            entries = self._requeue_failed(entries)
            if entries:
                # retries spent: scatter empty honestly, depth-1 style.
                # The dispatch never reached the device, so no device
                # interval is opened (obs_seq=-1: nothing to close).
                self._scatter(af, k, entries, [[] for _ in entries], wf,
                              t_pick, probe_s, t_dispatch, 0.0, 1,
                              _time.time(), slot=len(self._inflight))
            return
        seq = self.observatory.on_dispatch(
            t_fill, t_dispatch, len(entries), af, k,
            len(self._inflight), 0)
        dispatch_s = max(0.0, _time.time() - t_dispatch)
        if wf.enabled:
            # host-side dispatch cost is its
            # own stage, observed AT LAUNCH — the in-flight window no
            # longer folds into queue_wait or the device stage.  The
            # first (af, k) dispatch carries tracing/lowering cost; the
            # consume-side device_compile split still owns that story.
            wf.observe("dispatch", dispatch_s,
                       exemplar=next((e.ctx.trace_hex for e in entries
                                      if e.ctx is not None), None))
        self._inflight.append(_InflightWave(
            af, k, entries, handle, t_dispatch, dispatch_s, t_pick,
            probe_s, slot=len(self._inflight), seq=seq))
        n = len(self._inflight)
        self._m_inflight.set(n)
        if n > self.inflight_peak:
            self.inflight_peak = n
            self._m_inflight_peak.set(max(n, self._peak_prev))

    # ------------------------------------------------------------- drain
    def _arm_drain(self, t: float) -> None:
        job = self._drain_job
        if job is not None and not job.cancelled:
            if job.time is not None and t < job.time:
                self._drain_job = self._dht.scheduler.edit(job, t)
        else:
            self._drain_job = self._dht.scheduler.add(t, self._drain)

    def _drain(self) -> None:
        """Dedicated drainer step: scatter wave N−1's
        fan-out OUTSIDE the fire that launches wave N, so host callback
        loops never sit between two launches.  The sole in-flight wave
        is only consumed when its handle is ready — otherwise the host
        stays free to fill the next wave and the poll re-arms one
        deadline out (a fresh fire's backpressure or inline drain may
        well get there first)."""
        self._drain_job = None
        wf = waterfall.get_profiler()
        while self._inflight:
            if len(self._inflight) > 1 or self._inflight[0].handle.ready():
                self._drain_one(wf)
            else:
                self._arm_drain(self._dht.scheduler.time() + self.deadline)
                return

    def _drain_one(self, wf) -> None:
        w = self._inflight.popleft()
        self._m_inflight.set(len(self._inflight))
        t_wait0 = _time.time()
        try:
            results = w.handle.consume()
        except Exception:
            log.exception("ingest wave consume failed (af=%d k=%d Q=%d)",
                          w.af, w.k, len(w.entries))
            results = None
        t_avail = _time.time()
        self.observatory.on_device_done(w.seq, t_avail)
        # the waterfall device stage at consume: the blocking wait
        # actually paid here (device_wait; the host dispatch cost was
        # observed as its own stage at launch).
        # Host time the wave spent in flight between pumps is overlap,
        # not device cost — it is visible as the wave span's wall
        # duration instead.  The wave_seconds histogram keeps its
        # dispatch+wait semantics.
        wait_s = max(0.0, t_avail - t_wait0)
        self._m_wave_s.observe(w.dispatch_s + wait_s)
        entries = w.entries
        if results is None:
            entries = self._requeue_failed(entries)
            if not entries:
                # fully requeued: close this wave's lane slices so the
                # timeline never leaks an orphan open interval
                self.observatory.on_scatter_done(w.seq, _time.time())
                return
            results = [[] for _ in entries]
        self._scatter(w.af, w.k, entries, results, wf, w.t_pick,
                      w.probe_s, w.t_dispatch, wait_s,
                      w.handle.shard_t, t_avail, slot=w.slot,
                      dispatch_s=w.dispatch_s, obs_seq=w.seq)

    def _requeue_failed(self, entries: List[_Entry]) -> List[_Entry]:
        """A failed launch must not fail its carried (already admitted)
        searches on a transient device error: re-queue each entry for
        the next wave, up to _LAUNCH_RETRIES, and return the exhausted
        remainder (to scatter empty — a fresh search with no candidates
        then expires and fails its op honestly: persistent
        infrastructure failure, not backpressure)."""
        telemetry.get_registry().counter(
            "dht_ingest_wave_failures_total").inc()
        # the retry round-trip owns the device-idle gap it opens: the
        # NEXT dispatch's bubble is attributed launch_retry
        self.observatory.note_launch_retry()
        requeue = [e for e in entries if e.retries < _LAUNCH_RETRIES]
        exhausted = [e for e in entries if e.retries >= _LAUNCH_RETRIES]
        if requeue:
            for e in requeue:
                e.retries += 1
            # oldest-first: retried entries
            # re-join AHEAD of anything submitted while the failed wave
            # was in flight.  Appending them put a newer entry at
            # _pending[0], whose t_enq anchors the deadline trigger
            # (_arm in submit) — silently deferring the oldest op.
            self._pending.extendleft(reversed(requeue))
            self._m_depth.set(len(self._pending))
            self._arm(self._dht.scheduler.time() + self.deadline)
        return exhausted

    # resharding plane (the boundary generation a wave ran on, passed
    # to the observatory as 0 above): not ported

    def _scatter(self, af: int, k: int, entries: List[_Entry], results,
                 wf, t_pick: "float | None", probe_s: float,
                 t_dispatch: float, dev_elapsed: float, shard_t: int,
                 t_avail: float, slot: int, dispatch_s: float = 0.0,
                 obs_seq: int = -1) -> None:
        """Fan a wave's results out to the carried ops' callbacks, with
        all the per-wave bookkeeping (metrics, keyspace, waterfall
        stages, trace spans) — shared verbatim by the synchronous
        depth-1 launch and the pipelined drain, so the two paths cannot
        diverge.  ``t_avail`` is when results materialized (launch end
        / consume end): the per-op scatter_back slices start there."""
        self.waves += 1
        self._m_waves.inc()
        # keyspace observatory: the wave's [Q] target ids feed the
        # device count-min sketch + keyspace histogram in ONE batched
        # scatter-add per wave (never reads the device back; buffered
        # stored-key puts ride along)
        ks = getattr(self._dht, "keyspace", None)
        if ks is not None:
            ks.observe_hashes([e.target for e in entries])
        self._m_occupancy.observe(len(entries))
        for e in entries:
            self._m_queue_s.observe(max(0.0, t_dispatch - e.t_wall))
        # shard_t is truth, not config: what the resolve ACTUALLY used —
        # a wave served by the host scan or the churn view reports t=1
        # even when a resolve mesh is configured.  Carried per launch
        # (BatchedResolve.shard_t / last_resolve_shard_t): overlapping
        # waves must not read a shared flag at consume time.
        if shard_t > 1:
            self._m_sharded_waves.inc()
        # waterfall device stage: the first timed launch of an (af, k)
        # group carries XLA compilation — split so a one-time lowering
        # never poisons the serving p99 (host-side bookkeeping only;
        # the launch itself is untouched).  With the pipeline this is
        # observed at CONSUME (the blocking wait; the host dispatch
        # share was observed as the "dispatch" stage at launch —
        # "device_launch" remains as a one-release
        # alias of device_wait, see waterfall.STAGE_ALIASES).
        dev_stage = "device_wait"
        if wf.enabled:
            dev_stage = ("device_compile" if wf.first_launch((af, k))
                         else "device_wait")
            wf.observe(dev_stage, dev_elapsed,
                       exemplar=next((e.ctx.trace_hex for e in entries
                                      if e.ctx is not None), None))

        # tracing spine: one dht.search.wave span per launch (the
        # ingest-mode sibling of the engine's wave span), each carried
        # op linked to it by a dht.ingest.op child span under the OP'S
        # own trace — a Perfetto load shows which wave served which op
        # and how long the op sat in the queue.  Host-side, after the
        # launch: tracing cannot perturb the kernel.
        tr = tracing.get_tracer()
        wave_ctx = None
        wave_end = t_avail
        if tr.enabled and any(e.ctx is not None for e in entries):
            # no device-cost attrs: the JAX builder reads them from its
            # XLA cost ledger, which has no torch counterpart yet.
            # The span covers dispatch → results materialized (for a
            # pipelined wave that includes the in-flight overlap window
            # — the wall truth); pipeline_slot = waves already in
            # flight when this one launched (0 = head of the pipeline)
            # reshard generation serving this wave: always 0 (the
            # resharding plane is not ported)
            wave_ctx = tr.record(
                "dht.search.wave", t_dispatch,
                max(0.0, t_avail - t_dispatch),
                mode="ingest", occupancy=len(entries), af=af, k=k,
                table_shard_t=shard_t, pipeline_slot=slot,
                reshard_gen=0)
        for e, nodes in zip(entries, results):
            if wave_ctx is not None and e.ctx is not None:
                # span covers submit → scatter, anchored on the entry's
                # own wall stamp so it can never precede its parent op
                tr.record("dht.ingest.op", e.t_wall,
                          max(0.0, wave_end - e.t_wall),
                          parent=e.ctx, kind="internal",
                          op_kind=e.kind, wave_trace=wave_ctx.trace_hex,
                          wave_span=wave_ctx.span_hex,
                          occupancy=len(entries))
            try:
                e.cb(nodes)
            except Exception:
                log.exception("ingest scatter callback failed")
            if wf.enabled:
                # per-op decomposition record: stage sum ≈ end-to-end
                # (admission → this op's scatter returned); rpc_wait
                # overlaps the device stages and is deliberately absent
                t_done = _time.time()
                base = t_pick if t_pick is not None else t_dispatch
                stages = {
                    "queue_wait": max(0.0, base - e.t_wall),
                    "cache_probe": probe_s,
                    dev_stage: dev_elapsed,
                    "scatter_back": max(0.0, t_done - t_avail),
                }
                if dispatch_s > 0.0:
                    stages["dispatch"] = dispatch_s
                wf.record_op(e.kind, stages,
                             end_to_end=max(0.0, t_done - e.t_wall),
                             trace_id=e.ctx.trace_hex if e.ctx else None)
        if wf.enabled:
            # ONE scatter_back observation per wave (the whole fan-out
            # loop) — the per-op slices live in the records above
            wf.observe("scatter_back",
                       max(0.0, _time.time() - t_avail))
        # scatter_done edge: closes the wave's lane slices, linking the
        # timeline record to its dht.search.wave span for Perfetto
        self.observatory.on_scatter_done(
            obs_seq, _time.time(),
            trace=wave_ctx.trace_hex if wave_ctx is not None else "",
            span=wave_ctx.span_hex if wave_ctx is not None else "")

    # ---------------------------------------------------------- inspection
    def frame_tick(self) -> None:
        """History-ring frame hook: roll the windowed
        in-flight peak (``dhtmon --window`` should see
        the CURRENT pipeline depth, not a boot-time spike) and push an
        occupancy window checkpoint into the observatory.  The exported
        gauge is max(previous frame, current frame) so it never blinks
        to zero at the frame edge while waves are still in flight."""
        self._peak_prev = self.inflight_peak
        self.inflight_peak = len(self._inflight)
        self._m_inflight_peak.set(
            float(max(self._peak_prev, self.inflight_peak)))
        self.observatory.on_frame()

    def pipeline_snapshot(self) -> dict:
        """Utilization snapshot for ``GET /pipeline`` / the ``pipeline``
        REPL cmd / ``dhtscanner --json``: the observatory's occupancy /
        bubble / overlap ledger plus the builder's pipeline shape."""
        doc = self.observatory.snapshot()
        doc.update({
            "pipeline_depth": self.pipeline_depth,
            "inflight": len(self._inflight),
            "inflight_peak": max(self.inflight_peak, self._peak_prev),
            "queue_depth": len(self._pending),
        })
        return doc

    def snapshot(self) -> dict:
        """JSON-able ingest state for the ops tools (``dhtscanner
        --json`` "ingest" section, the dhtnode REPL ``ingest`` cmd)."""
        occ = self._m_occupancy
        qs = self._m_queue_s
        mean_occ = (occ.sum / occ.count) if occ.count else 0.0
        try:
            shard_t = self._dht.resolve_mesh_t()
        except Exception:
            shard_t = 1
        return {
            "batching": "on" if self.enabled else "off",
            "pipeline_depth": self.pipeline_depth,
            "inflight": len(self._inflight),
            "inflight_peak": max(self.inflight_peak, self._peak_prev),
            "table_shard_t": shard_t,
            "sharded_waves": int(self._m_sharded_waves.value),
            "fill_target": self.fill_target,
            "deadline_s": self.deadline,
            "queue_depth": len(self._pending),
            "queue_max": self.queue_max,
            "waves": self.waves,
            "occupancy_mean": round(mean_occ, 3),
            "occupancy_p50": round(occ.quantile(0.5), 3),
            "occupancy_p95": round(occ.quantile(0.95), 3),
            "queue_seconds_p50": qs.quantile(0.5),
            "queue_seconds_p95": qs.quantile(0.95),
            "sheds": int(sum(c.value for c in self._m_sheds.values())),
        }
