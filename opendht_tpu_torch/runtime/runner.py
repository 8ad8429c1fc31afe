"""DhtRunner: the thread-safe async process runtime over real UDP sockets.

Behavioral port of the reference runtime (reference:
include/opendht/dhtrunner.h:51-497, src/dhtrunner.cpp):

- **3 threads** (dhtrunner.cpp:115-148,511-608,819-875):
  (1) receive thread — ``selectors`` on the UDP socket(s) plus a stop
  pipe, pushing raw packets into a bounded queue (RX_QUEUE_MAX_SIZE,
  packets older than 500 ms dropped under backlog, :45,414-418);
  (2) DHT thread — drain the pending-op queues (prio ops always; normal
  ops only when connected or idle-disconnected, :393-398), feed packets to
  ``Dht.periodic``, publish status changes, sleep on a condition variable
  until the scheduler's next wakeup; (3) bootstrap thread — while
  disconnected, re-resolve and ping the bootstrap nodes every
  BOOTSTRAP_PERIOD (:819-875).
- Every public API call enqueues a closure and notifies the DHT thread
  (e.g. get :610-620, put :727-750); blocking variants wrap the callback
  pair in a ``concurrent.futures.Future``.
- Non-threaded mode: construct with ``threaded=False`` and pump
  ``loop()`` manually (dhtrunner.h:361-370).

A copy of the JAX package's ``runtime/runner.py`` with its behaviour
unchanged, the REST proxy backend included (``enable_proxy``,
``RunnerConfig(proxy_server=)``: a ``SecureDht`` over the port's
``proxy.DhtProxyClient``).  The device is explicit:
``run(device=None)`` means the CUDA card and raises when there is none;
tests pass ``device="cpu"``.  Every table and device call runs on the
DHT thread (or the caller of ``loop()``); ``run`` builds the kernels
(``Dht.warmup``) on the caller's thread, and on the card first makes
the CUDA context and loads the node's kernels there (``dht.warm_device``)
before the node's scheduler clock starts.
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import os
import selectors
import socket as _socket
import threading
import time as _time
from typing import Callable, List, Optional, Tuple

from .. import (health as _health, history as _history, profiling,
                telemetry, tracing, waterfall as _waterfall)
from .._device import resolve_device
from ..infohash import InfoHash
from ..sockaddr import SockAddr
from ..utils import TIME_MAX, lazy_module

# call-time dependency only (identity handling): lazy so the runner
# imports and runs identity-less without the `cryptography` wheel
crypto = lazy_module("opendht_tpu_torch.crypto")
from ..core.value import Value
from ..scheduler import Scheduler
from .config import Config, NodeStatus
from .dht import Dht, warm_device
from .secure_dht import SecureDht, secure_node_id

log = logging.getLogger("opendht_tpu_torch.runner")

RX_QUEUE_MAX_SIZE = 1024 * 16          # dhtrunner.cpp:45
RX_QUEUE_MAX_DELAY = 0.5               # dhtrunner.cpp:414-418
BOOTSTRAP_PERIOD = 10.0                # dhtrunner.h:409
MAX_PACKET = 1500


def _op_trace(op: str, key, done_cb, node_id=""):
    """Mint the root client span for a public op: the span
    covers enqueue → done callback — the per-request causality anchor
    the whole wire-propagated trace hangs from.  Parentless ops consult
    the head sampler (always-on by default, rate-limited via
    ``Tracer.set_sample_rate`` / ``OPENDHT_TPU_TRACE_RATE`` in
    production); an op called under an already-active ambient context
    (e.g. a test or embedder grouping several ops into one trace)
    becomes that trace's child instead of a new root.

    Returns ``(trace_ctx_or_None, wrapped_done_cb)`` — the context is
    activated around the posted closure so ``Dht._search`` adopts it."""
    tr = tracing.get_tracer()
    if not tr.enabled:
        return None, done_cb
    sp = tr.span("dht.op." + op, parent=tracing.current(), kind="client",
                 node=node_id, op=op, key=str(key))
    if not sp:
        return None, done_cb
    fired = []

    def wrapped(ok, *args, **kw):
        if not fired:
            fired.append(True)
            sp.set(ok=bool(ok))
            sp.end()
        if done_cb:
            return done_cb(ok, *args, **kw)

    return sp.ctx, wrapped


def _op_metrics_cb(op: str, done_cb):
    """Wrap a public-API done callback with the per-op telemetry
    (request lifecycle, user view): latency from enqueue to the
    done callback — queue wait included, that IS the latency an embedder
    observes — into ``dht_op_seconds{op=}`` and the outcome into
    ``dht_ops_total{op=,ok=}``.  Multi-callback ops (a get retrying on
    both families) only time the first completion."""
    reg = telemetry.get_registry()
    if not reg.enabled:
        return done_cb
    t0 = _time.perf_counter()
    fired = []

    def wrapped(ok, *args, **kw):
        if not fired:
            fired.append(True)
            reg.histogram("dht_op_seconds", op=op).observe(
                _time.perf_counter() - t0)
            reg.counter("dht_ops_total", op=op,
                        ok="true" if ok else "false").inc()
        if done_cb:
            return done_cb(ok, *args, **kw)

    return wrapped


class RunnerConfig:
    """DhtRunner::Config (dhtrunner.h:56-61)."""

    def __init__(self, dht_config: Optional[Config] = None,
                 identity: "crypto.Identity | None" = None,
                 threaded: bool = True, proxy_server: str = "",
                 push_node_id: str = "", native_engine: bool = True,
                 native_exempt_loopback: bool = True):
        self.dht_config = dht_config or Config()
        self.identity = identity
        self.threaded = threaded
        self.proxy_server = proxy_server
        self.push_node_id = push_node_id
        #: use the C++ datagram engine (ring buffer + native ingress
        #: guards, opendht_tpu_torch/native) when it is available
        self.native_engine = native_engine
        #: skip native rate limits for 127/8 sources (local clusters);
        #: disable on hosts where loopback spoofing is a concern
        self.native_exempt_loopback = native_exempt_loopback


class DhtRunner:
    """Thread-safe async façade around a SecureDht node."""

    def __init__(self):
        self._dht: Optional[SecureDht] = None
        self._open_bounds = None
        self._health: "_health.NodeHealth | None" = None
        self._history: "_history.MetricsHistory | None" = None
        self._sock4: Optional[_socket.socket] = None
        self._sock6: Optional[_socket.socket] = None
        self._udp = None                       # native UdpEngine (IPv4)
        self._native_thread: Optional[threading.Thread] = None
        self._net_running = False
        self._stop_rd, self._stop_wr = None, None
        self.running = False
        self.bound_port = 0

        self._rcv = collections.deque()            # (recv_time, data, from)
        self._sock_lock = threading.Lock()
        self._ops_lock = threading.Lock()
        self._pending_ops: collections.deque = collections.deque()
        self._pending_ops_prio: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._dht_thread: Optional[threading.Thread] = None
        self._rcv_thread: Optional[threading.Thread] = None
        self._bootstrap_thread: Optional[threading.Thread] = None
        self._bootstrap_nodes: List[Tuple[str, int]] = []
        self._bootstrap_all: List[Tuple[str, int]] = []
        self._bootstraping = False
        self._bootstrap_cv = threading.Condition()

        self.status4 = NodeStatus.DISCONNECTED
        self.status6 = NodeStatus.DISCONNECTED
        self.status_cb: Optional[Callable] = None
        self.on_status_changed: Optional[Callable] = None

        # proxy hot-swap state (↔ dhtrunner.cpp:992-1041)
        self.use_proxy = False
        self._proxy_dht = None                 # SecureDht over DhtProxyClient
        self._proxy_client = None
        self._listeners_lock = threading.Lock()
        self._listener_token = 1
        #: runner token → _RunnerListener (↔ DhtRunner::Listener,
        #: dhtrunner.cpp:47-54: {tokenClassicDht, tokenProxyDht, key, cb, f})
        self._listeners: dict = {}

    # ------------------------------------------------------------- lifecycle
    def run(self, port: int = 0, config: Optional[RunnerConfig] = None,
            *, ipv6: bool = False, device=None) -> None:
        """Bind sockets, build the node, start the threads
        (↔ DhtRunner::run, dhtrunner.cpp:77-149).  ``device``: where the
        node's tables live (None = the CUDA card, raising without one)."""
        if self.running:
            return
        device = resolve_device(device)
        config = config or RunnerConfig()
        self._config = config
        self._start_network(port, ipv6)

        dht_config = config.dht_config
        if config.identity and dht_config.node_id is None:
            dht_config.node_id = secure_node_id(config.identity[1])
        has_v6 = ipv6 and (self._sock6 is not None
                           or (self._udp is not None and self._udp.has_v6))
        if device.type == "cuda":
            # the card's context and the node's kernels, before the
            # node's scheduler clock starts (Dht.warmup's own call is
            # then quick): the wait is no job's lag
            warm_device(dht_config, device)
        dht = Dht(self._send, dht_config, Scheduler(),
                  has_v4=True, has_v6=has_v6, device=device)
        self._dht = SecureDht(dht, config.identity)
        dht.status_cb = lambda s4, s6: None   # runner tracks status itself
        dht.warmup()     # compile hot kernels before serving any packet

        # flight data recorder: the bounded ring of
        # delta-encoded registry frames, ticking on the node scheduler
        # ahead of the health job so a health window never reads frames
        # more than one period stale (host-side subtraction only — no
        # device work, kernels untouched)
        self._history = None
        hcfg = dht_config.history
        if hcfg.period > 0 and hcfg.capacity > 0:
            # the ring is frame-count-bounded while the SLO windows the
            # health engine reads through it are TIME-bounded: at a
            # short recorder period the default capacity would silently
            # truncate the slow-burn window (the private _Window kept
            # slow_window * 1.25 by time regardless of cadence), so
            # scale the capacity up to cover it
            if dht_config.health.period > 0:
                import dataclasses
                import math as _math
                need = int(_math.ceil(
                    dht_config.health.slow_window * 1.25 / hcfg.period))
                if hcfg.capacity < need:
                    log.info("history capacity %d < slow SLO window "
                             "coverage at period %gs; raising to %d",
                             hcfg.capacity, hcfg.period, need)
                    hcfg = dataclasses.replace(hcfg, capacity=need)
            self._history = _history.MetricsHistory(
                hcfg, clock=dht.scheduler.time,
                node=str(dht.get_node_id()))
            self._history.attach(dht.scheduler)
            # the reshard tick's sustain check corroborates its latch
            # against windowed frame evidence (reshard.py) — the ring
            # is built here, after the Dht, so late-bind it
            try:
                dht.reshard.set_history(self._history)
            except AttributeError:
                pass
            # pipeline observatory: the recorder's frame
            # cadence IS the windowed-reset cadence — each committed
            # frame rolls the wave builder's windowed in-flight peak
            # and pushes an occupancy window checkpoint
            self._history.add_frame_hook(
                lambda _frame, _wb=dht.wave_builder: _wb.frame_tick())
            # listener table: the same frame cadence rolls the windowed
            # delivery-lag p95 into the dht_listener_lag_p95 gauge
            self._history.add_frame_hook(
                lambda _frame, _lt=dht.listener_table: _lt.frame_tick())

        # health observatory: the declarative SLO engine +
        # node verdict, evaluated on a periodic scheduler tick riding
        # the same DHT thread as every other job (host-side snapshot
        # subtraction only — no device work, kernels untouched).  With
        # the recorder live, every windowed delta reads through its
        # frames (one delta codepath) and an unhealthy
        # transition captures a black-box bundle.
        self._health = None
        if dht_config.health.period > 0:
            self._health = _health.NodeHealth(
                dht, dht_config.health, node=str(dht.get_node_id()),
                history=self._history)
            if self._history is not None:
                self._health.evaluator.on_transition = \
                    self._on_health_transition
            self._health.attach(dht.scheduler)

        # OPEN-bound tracker: periodic live comparison of achieved wave
        # p50 / occupancy / churny-static ratio against the open bounds
        # of the port's budgets, on the same scheduler (registry reads
        # only — no device work); its status follows the node's device,
        # and each tick re-drops the settling record
        self._open_bounds = None
        wcfg = getattr(dht_config, "waterfall", None)
        period = getattr(wcfg, "open_bound_period", 0.0) if wcfg else 0.0
        if period > 0:
            self._open_bounds = _waterfall.OpenBoundTracker(
                device=dht.device)
            self._open_bounds.attach(dht.scheduler, period=period)

        self.running = True
        if config.threaded:
            self._dht_thread = threading.Thread(
                target=self._dht_loop, name="dht", daemon=True)
            self._dht_thread.start()
        if config.proxy_server:
            # start proxied (↔ DhtRunner::Config::proxy_server,
            # dhtrunner.cpp:98-149 → enableProxy at startup)
            self.enable_proxy(config.proxy_server)

    def _start_network(self, port: int, ipv6: bool) -> None:
        """(↔ DhtRunner::startNetwork, dhtrunner.cpp:511-608).  Both
        families go through the native C++ datagram engine when
        available (recv thread polling the v4 + v6-only sockets, ring
        buffer, martian filter and rate limits in C++; Python drains
        packet batches) and fall back to Python sockets otherwise."""
        self._net_running = True
        if self._config.native_engine:
            try:
                from ..native import UdpEngine, available
                if available():
                    # The native limits are a datagram-level flood
                    # backstop only: the protocol-level request limiting
                    # (requests-only, configurable) stays in the Python
                    # engine (net/engine.py:335).  Per-IP gets 8×
                    # headroom over the request budget (responses, NATed
                    # clusters) while global sits another 2× above it so
                    # one flooding source can never consume the whole
                    # global window; loopback exemption is a config knob
                    # (default on for local clusters).
                    budget = max(self._config.dht_config.max_req_per_sec, 8)
                    self._udp = UdpEngine(
                        port, global_rps=budget * 16,
                        per_ip_rps=budget * 8,
                        exempt_loopback=self._config.native_exempt_loopback,
                        ipv6=ipv6)
                    self.bound_port = self._udp.port
                    self._native_thread = threading.Thread(
                        target=self._native_rcv_loop, name="dht-rcv-native",
                        daemon=True)
            except (OSError, RuntimeError, ImportError):
                self._udp = None
        if self._udp is None:
            self._sock4 = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
            self._sock4.setsockopt(_socket.SOL_SOCKET,
                                   _socket.SO_REUSEADDR, 1)
            self._sock4.bind(("0.0.0.0", port))
            self.bound_port = self._sock4.getsockname()[1]
        if ipv6 and not (self._udp is not None and self._udp.has_v6):
            # v6 rides the native engine's second socket when available;
            # this Python socket is the fallback path only
            try:
                self._sock6 = _socket.socket(_socket.AF_INET6,
                                             _socket.SOCK_DGRAM)
                self._sock6.setsockopt(_socket.IPPROTO_IPV6,
                                       _socket.IPV6_V6ONLY, 1)
                self._sock6.bind(("::", self.bound_port))
            except OSError:
                self._sock6 = None
        self._stop_rd, self._stop_wr = os.pipe()
        if self._sock4 is not None or self._sock6 is not None:
            self._rcv_thread = threading.Thread(
                target=self._rcv_loop, name="dht-rcv", daemon=True)
            self._rcv_thread.start()
        if self._native_thread is not None:
            self._native_thread.start()

    def _send(self, data: bytes, dest: SockAddr) -> int:
        if self._udp is not None and (dest.family != _socket.AF_INET6
                                      or self._udp.has_v6):
            try:
                return self._udp.send(data, dest.to_tuple())
            except OSError as e:
                return e.errno or 1
        sock = self._sock6 if dest.family == _socket.AF_INET6 else self._sock4
        if sock is None:
            return 1
        try:
            sock.sendto(data, dest.to_tuple())
            return 0
        except OSError as e:
            return e.errno or 1

    # --------------------------------------------------- native rcv thread
    def _native_rcv_loop(self) -> None:
        """Drain the C++ engine's ring into the runner queue; the wait
        blocks in C++ (GIL released) until packets arrive."""
        udp = self._udp
        while self._net_running:
            try:
                if not udp.wait(0.1):
                    continue
                pkts = udp.poll(256)
            except Exception:
                if not self._net_running:
                    break
                log.exception("native rcv error; retrying")
                _time.sleep(0.1)
                continue
            if not pkts:
                continue
            # timestamp with the Python clock: the staleness check in
            # _loop compares against time.monotonic(), and the C++
            # steady_clock epoch is not guaranteed to match it
            now = _time.monotonic()
            with self._sock_lock:
                for _rx_time, data, (host, port) in pkts:
                    if len(self._rcv) < RX_QUEUE_MAX_SIZE:
                        self._rcv.append((now, data, SockAddr(host, port)))
            with self._cv:
                self._cv.notify()

    # ------------------------------------------------------------ rcv thread
    def _rcv_loop(self) -> None:
        """(↔ rcv_thread select loop, dhtrunner.cpp:544-607)"""
        sel = selectors.DefaultSelector()
        for sock in (self._sock4, self._sock6):
            if sock is not None:
                sock.setblocking(False)
                sel.register(sock, selectors.EVENT_READ)
        sel.register(self._stop_rd, selectors.EVENT_READ)
        try:
            while True:
                for key, _ in sel.select():
                    if key.fd == self._stop_rd:
                        os.read(self._stop_rd, 64)
                        return
                    try:
                        data, addr = key.fileobj.recvfrom(MAX_PACKET)
                    except OSError:
                        continue
                    if not data:
                        continue
                    with self._sock_lock:
                        if len(self._rcv) < RX_QUEUE_MAX_SIZE:
                            self._rcv.append(
                                (_time.monotonic(), data,
                                 SockAddr(addr[0], addr[1])))
                    with self._cv:
                        self._cv.notify()
        finally:
            sel.close()

    # ------------------------------------------------------------ dht thread
    def _loop(self) -> float:
        """One pump of the DHT: ops, packets, status
        (↔ DhtRunner::loop_, dhtrunner.cpp:387-445).  Returns next wakeup
        (monotonic time) or TIME_MAX."""
        dht = self._dht
        if dht is None:
            return TIME_MAX
        with self._ops_lock:
            status = self.get_status()
            ops = []
            # drain BOTH queues each pump, prio first.  The reference
            # skipped the normal queue whenever prio ops were pending —
            # under sustained prio traffic (bootstrap ping storms, stats
            # polls) normal ops could be deferred indefinitely
            # (starvation regression test in tests/test_runner.py).
            # Draining prio-then-normal in one pump is the fairness
            # bound: prio keeps strict precedence within the pump, and
            # every pump makes progress on eligible normal ops.
            if self._pending_ops_prio:
                ops.extend(self._pending_ops_prio)
                self._pending_ops_prio.clear()
            if self._pending_ops and (
                    self.use_proxy
                    or status is NodeStatus.CONNECTED
                    or (status is NodeStatus.DISCONNECTED
                        and not self._bootstraping)):
                ops.extend(self._pending_ops)
                self._pending_ops.clear()
        active = self._proxy_dht if self.use_proxy else dht
        for op in ops:
            try:
                op(active)
            except Exception:
                log.exception("pending op failed")

        with self._sock_lock:
            received = list(self._rcv)
            self._rcv.clear()
        wakeup = TIME_MAX
        if received:
            now = _time.monotonic()
            for rx_time, data, from_addr in received:
                if now - rx_time > RX_QUEUE_MAX_DELAY:
                    log.warning("dropping packet with high delay %.3fs",
                                now - rx_time)
                    continue
                wakeup = dht.periodic(data, from_addr)
        else:
            wakeup = dht.periodic(None, None)

        s4 = dht.get_status(_socket.AF_INET)
        s6 = dht.get_status(_socket.AF_INET6)
        if s4 is not self.status4 or s6 is not self.status6:
            self.status4, self.status6 = s4, s6
            if s4 is NodeStatus.DISCONNECTED and s6 is NodeStatus.DISCONNECTED:
                with self._bootstrap_cv:
                    self._bootstrap_nodes = list(self._bootstrap_all)
                self._try_bootstrap_continuously()
            else:
                with self._bootstrap_cv:
                    self._bootstrap_nodes = []
            cb = self.status_cb or self.on_status_changed
            if cb:
                try:
                    cb(s4, s6)
                except Exception:
                    log.exception("status callback failed")
        return wakeup

    def _dht_loop(self) -> None:
        """(↔ dht_thread body, dhtrunner.cpp:115-148)"""
        while self.running:
            try:
                wakeup = self._loop()
            except Exception:
                log.exception("dht loop error")
                wakeup = _time.monotonic() + 0.1

            def has_job():
                if not self.running:
                    return True
                with self._sock_lock:
                    if self._rcv:
                        return True
                with self._ops_lock:
                    if self._pending_ops_prio:
                        return True
                    if self._pending_ops:
                        if self.use_proxy:
                            return True
                        s = self.get_status()
                        if s is NodeStatus.CONNECTED or (
                                s is NodeStatus.DISCONNECTED
                                and not self._bootstraping):
                            return True
                return False

            with self._cv:
                if wakeup == TIME_MAX:
                    self._cv.wait_for(has_job)
                else:
                    delay = max(0.0, wakeup - _time.monotonic())
                    self._cv.wait_for(has_job, timeout=delay)

    def loop(self) -> float:
        """Non-threaded mode: pump once, return next wakeup
        (dhtrunner.h:361-370)."""
        return self._loop()

    # ------------------------------------------------------------- op queues
    def _post_node(self, op, prio: bool = False) -> None:
        """Post an op that must run on the UDP node even while the proxy
        backend is active (node-level ops: ping/insert/export — the REST
        backend has no node table)."""
        self._post(lambda _active: op(self._dht), prio)

    def _post(self, op, prio: bool = False) -> None:
        with self._ops_lock:
            (self._pending_ops_prio if prio else self._pending_ops).append(op)
        with self._cv:
            self._cv.notify()

    # ------------------------------------------------------------- bootstrap
    def bootstrap(self, host: str, port: "int | str" = 4222,
                  done_cb=None) -> None:
        """Add a bootstrap node and ping it continuously until connected
        (↔ DhtRunner::bootstrap, dhtrunner.cpp:877-931)."""
        port = int(port)
        with self._bootstrap_cv:
            self._bootstrap_all.append((host, port))
            self._bootstrap_nodes.append((host, port))
        self._ping((host, port), done_cb)
        self._try_bootstrap_continuously()

    def bootstrap_node(self, node_id: InfoHash, addr: SockAddr) -> None:
        """Insert a known node directly (no ping) — import path
        (dhtrunner.cpp:933-947)."""
        self._post_node(lambda dht: dht.insert_node(node_id, addr),
                        prio=True)

    def _ping(self, hostport: Tuple[str, int], done_cb=None) -> None:
        host, port = hostport
        try:
            addrs = SockAddr.resolve(host, port)
        except OSError:
            addrs = []
        for a in addrs:
            self._post_node(lambda dht, a=a: dht.ping_node(a, done_cb),
                            prio=True)

    def _try_bootstrap_continuously(self) -> None:
        """(↔ tryBootstrapContinuously, dhtrunner.cpp:819-875)"""
        with self._bootstrap_cv:
            if self._bootstraping or not self._bootstrap_nodes:
                return
            self._bootstraping = True

        def loop():
            while self.running:
                with self._bootstrap_cv:
                    nodes = list(self._bootstrap_nodes)
                    if not nodes:
                        break
                if self.get_status() is NodeStatus.CONNECTED:
                    break
                for hp in nodes:
                    self._ping(hp)
                with self._bootstrap_cv:
                    self._bootstrap_cv.wait(BOOTSTRAP_PERIOD)
            with self._bootstrap_cv:
                self._bootstraping = False

        self._bootstrap_thread = threading.Thread(
            target=loop, name="dht-bootstrap", daemon=True)
        self._bootstrap_thread.start()

    # ------------------------------------------------------------------ API
    def get(self, key: InfoHash, get_cb=None, done_cb=None, f=None,
            where=None) -> None:
        """(dhtrunner.cpp:610-620)"""
        done_cb = _op_metrics_cb("get", done_cb)
        tctx, done_cb = _op_trace("get", key, done_cb,
                                  str(self.get_node_id()))
        self._post(lambda dht: tracing.run_with(
            tctx, lambda: dht.get(key, get_cb, done_cb, f, where)))

    def get_sync(self, key: InfoHash, timeout: Optional[float] = 30.0,
                 f=None, where=None) -> List[Value]:
        """Blocking get: returns all values found (python binding style)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        out: List[Value] = []
        self.get(key, lambda vals: out.extend(vals) or True,
                 lambda ok, ns: fut.done() or fut.set_result(ok), f, where)
        fut.result(timeout)
        return out

    def query(self, key: InfoHash, query_cb, done_cb=None, q=None) -> None:
        self._post(lambda dht: dht.query(key, query_cb, done_cb, q))

    def put(self, key: InfoHash, value: Value, done_cb=None,
            created: Optional[float] = None, permanent: bool = False) -> None:
        """(dhtrunner.cpp:727-750)"""
        done_cb = _op_metrics_cb("put", done_cb)
        tctx, done_cb = _op_trace("put", key, done_cb,
                                  str(self.get_node_id()))
        self._post(lambda dht: tracing.run_with(
            tctx, lambda: dht.put(key, value, done_cb, created,
                                  permanent)))

    def put_sync(self, key: InfoHash, value: Value,
                 timeout: Optional[float] = 30.0,
                 permanent: bool = False) -> bool:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self.put(key, value,
                 lambda ok, ns: fut.done() or fut.set_result(ok),
                 permanent=permanent)
        return bool(fut.result(timeout))

    def put_signed(self, key: InfoHash, value: Value, done_cb=None,
                   permanent: bool = False) -> None:
        done_cb = _op_metrics_cb("put_signed", done_cb)
        tctx, done_cb = _op_trace("put_signed", key, done_cb,
                                  str(self.get_node_id()))
        self._post(lambda dht: tracing.run_with(
            tctx, lambda: dht.put_signed(key, value, done_cb, permanent)))

    def put_encrypted(self, key: InfoHash, to: InfoHash, value: Value,
                      done_cb=None, permanent: bool = False) -> None:
        done_cb = _op_metrics_cb("put_encrypted", done_cb)
        tctx, done_cb = _op_trace("put_encrypted", key, done_cb,
                                  str(self.get_node_id()))
        self._post(lambda dht: tracing.run_with(
            tctx, lambda: dht.put_encrypted(key, to, value, done_cb,
                                            permanent)))

    def cancel_put(self, key: InfoHash, vid: int) -> None:
        self._post(lambda dht: dht.cancel_put(key, vid))

    def listen(self, key: InfoHash, cb, f=None,
               where=None) -> concurrent.futures.Future:
        """Returns a Future resolving to the (runner-level) listen token
        (↔ DhtRunner::listen futures, dhtrunner.cpp:638-671).  The runner
        keeps the listener record so subscriptions survive a proxy
        hot-swap (↔ DhtRunner::Listener, dhtrunner.cpp:47-54)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        # Dedup wrapper: a backend swap replays current values on the new
        # subscription; remember what this runner-level listener already
        # delivered so user callbacks fire once per value (the role the
        # reference's per-listener OpValueCache plays).
        seen: dict = {}

        def wrapped_cb(values, expired):
            out = []
            for v in values:
                if expired:
                    seen.pop(v.id, None)
                    out.append(v)
                else:
                    prev = seen.get(v.id)
                    if prev is not None and prev == v:
                        continue
                    seen[v.id] = v
                    out.append(v)
            if not out:
                return True
            return cb(out, expired)

        # base callback is a no-op so listen_done stays callable even
        # when the registry is disabled (_op_metrics_cb passes the base
        # through untouched in that case)
        listen_done = _op_metrics_cb("listen", lambda ok, *a, **kw: None)
        tctx, listen_done = _op_trace("listen", key, listen_done,
                                      str(self.get_node_id()))

        def op(dht):
            backend_token = tracing.run_with(
                tctx, lambda: dht.listen(key, wrapped_cb, f, where))
            if backend_token is None:
                # shed at ingest admission (Dht.listen's None
                # sentinel): no subscription exists — do not register a
                # runner record that a proxy hot-swap would faithfully
                # re-subscribe; surface the shed as a 0 future result.
                # (A backend return of 0 is DIFFERENT: the listener
                # consumed local values and stopped — a satisfied op,
                # which keeps the pre-existing success path below.)
                listen_done(False)
                fut.set_result(0)
                return
            with self._listeners_lock:
                token = self._listener_token
                self._listener_token += 1
                self._listeners[token] = {
                    "key": key, "cb": wrapped_cb, "f": f, "where": where,
                    "backend_token": backend_token,
                    "on_proxy": self.use_proxy,
                }
            # registration latency (enqueue → backend token issued)
            listen_done(backend_token is not None)
            fut.set_result(token)

        self._post(op)
        return fut

    def cancel_listen(self, key: InfoHash, token) -> None:
        def op(dht):
            t = (token.result(0)
                 if isinstance(token, concurrent.futures.Future) else token)
            with self._listeners_lock:
                rec = self._listeners.pop(t, None)
            if rec is not None:
                dht.cancel_listen(rec["key"], rec["backend_token"])
            # unknown runner tokens are dropped: forwarding them into the
            # backend token namespace could cancel someone else's listener

        self._post(op)

    # ----------------------------------------------------------- proxy swap
    def enable_proxy(self, proxy: "str | None") -> None:
        """Hot-swap the backend between the UDP node and a REST proxy
        client, re-registering every live listener on the new backend
        (↔ DhtRunner::enableProxy, dhtrunner.cpp:992-1041).

        ``proxy`` is "host:port" (or "http://host:port") to enable,
        None/"" to fall back to the UDP node.
        """
        def op(_dht):
            from ..proxy.client import DhtProxyClient

            old = self._proxy_dht if self.use_proxy else self._dht
            old_client = self._proxy_client
            if proxy:
                spec = proxy
                for prefix in ("http://", "https://"):
                    if spec.startswith(prefix):
                        spec = spec[len(prefix):]
                spec = spec.rstrip("/")
                # host[:port], [v6]:port, bare v6 literal, bare host
                if spec.startswith("["):                   # [::1]:8080
                    host, _, rest = spec[1:].partition("]")
                    port_s = rest.lstrip(":")
                elif spec.count(":") == 1:                 # host:port
                    host, _, port_s = spec.partition(":")
                else:                                      # bare host / v6
                    host, port_s = spec, ""
                try:
                    port_n = int(port_s) if port_s else 8080
                except ValueError:
                    log.error("enable_proxy: invalid proxy spec %r", proxy)
                    return
                client = DhtProxyClient(host or "127.0.0.1", port_n,
                                        client_id=self._config.push_node_id)
                ident = self._config.identity
                new = SecureDht(client,
                                (ident.first, ident.second) if ident else None)
                self._proxy_client = client
                self._proxy_dht = new
                self.use_proxy = True
            else:
                if not self.use_proxy:
                    return
                new = self._dht
                self.use_proxy = False
            # re-register listeners on the new backend (:1005-1032).
            # Established subscriptions were admitted when created:
            # exempt the re-subscribes from ingest admission so a full
            # queue at swap time cannot shed them (shed at admission
            # only, never an existing listener)
            import contextlib
            wb = getattr(new, "wave_builder", None)
            exempt = wb.exempt() if wb is not None else \
                contextlib.nullcontext()
            with self._listeners_lock:
                recs = list(self._listeners.values())
            with exempt:
                for rec in recs:
                    try:
                        old.cancel_listen(rec["key"], rec["backend_token"])
                    except Exception:
                        pass
                    rec["backend_token"] = new.listen(
                        rec["key"], rec["cb"], rec["f"], rec["where"])
                    rec["on_proxy"] = self.use_proxy
            # retire the previous proxy client (proxy→proxy swap or
            # fall-back to UDP): stop its maintenance/long-poll threads
            if old_client is not None and old_client is not self._proxy_client:
                old_client.join()
            if not proxy and self._proxy_client is not None:
                self._proxy_client.join()
                self._proxy_client = None
                self._proxy_dht = None

        self._post(op, prio=True)

    def find_certificate(self, node: InfoHash, cb) -> None:
        self._post(lambda dht: dht.find_certificate(node, cb))

    def find_public_key(self, node: InfoHash, cb) -> None:
        self._post(lambda dht: dht.find_public_key(node, cb))

    # ----------------------------------------------------------- inspection
    def get_status(self, af: int = 0) -> NodeStatus:
        """Best status across families (dhtrunner.h:165-172); when the
        proxy backend is active, its connectivity is the node's status."""
        if self.use_proxy and self._proxy_dht is not None:
            return self._proxy_dht.get_status(af)
        if af == _socket.AF_INET:
            return self.status4
        if af == _socket.AF_INET6:
            return self.status6
        return (self.status4 if self.status4.value >= self.status6.value
                else self.status6)

    def is_running(self) -> bool:
        return self.running

    def get_id(self) -> InfoHash:
        return self._dht.get_id() if self._dht else InfoHash()

    def get_node_id(self) -> InfoHash:
        return self._dht.get_node_id() if self._dht else InfoHash()

    def get_bound_port(self) -> int:
        return self.bound_port

    def get_node_stats(self, af: int = _socket.AF_INET):
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._post(lambda dht: fut.set_result(dht.get_nodes_stats(af)),
                   prio=True)
        return fut.result(10.0)

    def get_metrics(self) -> dict:
        """JSON snapshot of the unified telemetry registry — the SAME
        registry the proxy's ``GET /stats`` route serves as
        Prometheus text.  Refreshes the routing-table health gauges
        (``dht_routing_*{family=}`` — the ``get_nodes_stats`` island
        folded into the spine, ↔ Dht::getNodesStats) before dumping, so
        a scrape always sees current table state alongside the
        cumulative counters/histograms."""
        reg = telemetry.get_registry()
        if self.running and self._dht is not None:
            for af, fam in ((_socket.AF_INET, "ipv4"),
                            (_socket.AF_INET6, "ipv6")):
                try:
                    st = self.get_node_stats(af)
                except Exception:
                    continue
                for field, v in st.to_dict().items():
                    reg.gauge("dht_routing_" + field, family=fam).set(v)
        # kernel cost ledger: publish dht_kernel_* gauges when the
        # ledger has been computed, or compute it on the node's device
        # first when OPENDHT_TPU_LEDGER=1 arms eager mode — a no-op flag
        # check otherwise, so a bare scrape stays cheap
        dev = getattr(self._dht, "device", None) if self._dht else None
        profiling.maybe_export(reg, device=dev)
        return reg.snapshot()

    def get_health(self) -> dict:
        """The node's current health report: the verdict
        (``healthy | degraded | unhealthy``; ``unknown`` before the
        first tick or with ``health.period = 0``) plus per-signal and
        per-SLO attribution — the JSON the proxy's ``GET /healthz``
        route serves."""
        h = self._health
        if h is None:
            return {"verdict": "unknown", "enabled": False,
                    "signals": {}, "slo": {}, "unknown": []}
        rep = dict(h.report())
        rep["enabled"] = True
        return rep

    def get_history(self, since: Optional[float] = None,
                    limit: Optional[int] = None) -> dict:
        """The flight data recorder's retained frames: the JSON the
        proxy's ``GET /history`` route serves.
        ``since`` keeps frames from the last SEC seconds (recorder
        clock), ``limit`` the newest N.  The envelope carries the
        server's wall/mono clocks so the cluster timeline assembler
        can estimate scrape skew."""
        h = self._history
        if h is None:
            return {"enabled": False, "frames": []}
        t0 = (h.clock() - since) if since is not None else None
        doc = h.meta()
        doc["node_id"] = self.get_node_id().hex()
        doc["time"] = _time.time()
        doc["mono"] = h.clock()
        doc["frames"] = h.frames(t0=t0, limit=limit)
        return doc

    def dump_bundle(self, reason: str = "on_demand", *,
                    refresh: bool = True) -> dict:
        """Assemble one post-mortem black-box bundle: the
        last N history frames + the flight-recorder ring (spans AND
        events) + keyspace/cache/ingest snapshots + the health report
        in ONE JSON artifact — the reference's ``dumpTables`` instant,
        retained and machine-readable; captured automatically (with
        ``refresh=False``) on every health transition to unhealthy.

        ``refresh=False`` skips the routing-gauge refresh, which posts
        to the DHT thread and waits — REQUIRED when called FROM that
        thread (the health tick's transition hook), where the wait
        would deadlock."""
        metrics: dict = {}
        try:
            metrics = (self.get_metrics() if refresh
                       else telemetry.get_registry().snapshot())
        except Exception:
            pass
        ingest: dict = {}
        try:
            ingest = self._dht.wave_builder.snapshot()
        except Exception:
            pass
        return _history.build_bundle(
            reason=reason,
            node_id=self.get_node_id().hex(),
            status=self.get_status().name,
            history=self._history,
            health=self.get_health(),
            metrics=metrics,
            keyspace=self.get_keyspace(),
            cache=self.get_cache(),
            ingest=ingest,
            waterfall=self.get_profile(),
            pipeline=self.get_pipeline(),
            peers=self.get_peers(),
            listeners=self.get_listeners(),
        )

    def get_bundles(self) -> list:
        """Auto-captured black-box bundles (newest last; bounded by
        ``history.retain_bundles``) — the evidence retained from past
        unhealthy transitions."""
        return self._history.bundles() if self._history is not None else []

    def _on_health_transition(self, prev: str, new: str,
                              report: dict) -> None:
        """Evaluator transition hook (runs ON the DHT thread inside
        the health tick): capture the black-box bundle the moment the
        verdict goes unhealthy — by the time a human looks, the
        counters have moved on but the bundle has the frames."""
        if new != _health.UNHEALTHY or self._history is None:
            return
        try:
            b = self.dump_bundle(reason="health_transition",
                                 refresh=False)
            b["transition"] = {"from": prev, "to": new,
                               "causes": report.get("causes", [])}
            self._history.store_bundle(b)
        except Exception:
            log.exception("black-box bundle capture failed")

    def get_keyspace(self) -> dict:
        """The keyspace traffic observatory snapshot: the
        256-bin keyspace histogram, the heavy-hitter top-K with
        windowed estimates/shares, and the per-shard load attribution
        + imbalance ratio."""
        try:
            ks = getattr(self._dht, "keyspace", None)
            if ks is None:
                return {"enabled": False}
            return ks.snapshot()
        except Exception:
            return {"enabled": False}

    def get_reshard(self) -> dict:
        """The load-aware resharding snapshot: installed layout
        generation + edges, tick/swap/skip counters (skips
        reason-labeled), the sustain latch age and the post-swap refolded
        imbalance."""
        try:
            rs = getattr(self._dht, "reshard", None)
            if rs is None:
                return {"enabled": False}
            return rs.snapshot()
        except Exception:
            return {"enabled": False}

    def get_cache(self) -> dict:
        """The hot-key serving cache snapshot: occupancy,
        per-entry hit counts, windowed hit ratio, invalidation/eviction
        totals and the current widened hot set."""
        try:
            hc = getattr(self._dht, "hotcache", None)
            if hc is None:
                return {"enabled": False}
            return hc.snapshot()
        except Exception:
            return {"enabled": False}

    def get_profile(self) -> dict:
        """The per-op latency waterfall snapshot: per-stage
        ``dht_stage_seconds`` histograms with p50/p95/p99 and bucket
        exemplars, the stage budgets, the recent per-op decomposition
        records and the live OPEN-bound comparison."""
        try:
            doc = _waterfall.get_profiler().snapshot()
            if self._open_bounds is not None:
                doc["open_bounds"] = self._open_bounds.snapshot()
            return doc
        except Exception:
            return {"enabled": False}

    def get_pipeline(self) -> dict:
        """The pipeline utilization snapshot: the windowed
        device-occupancy gauge, per-cause bubble attribution, measured
        fill∥device overlap ratio and the pipeline shape (depth /
        in-flight / windowed peak)."""
        try:
            wb = getattr(self._dht, "wave_builder", None)
            if wb is None:
                return {"enabled": False}
            return wb.pipeline_snapshot()
        except Exception:
            return {"enabled": False}

    def get_peers(self) -> dict:
        """The per-peer network observatory snapshot:
        per-peer srtt/rttvar/RTO, request outcome counts, attempt
        timeouts + spurious retransmits, bytes in/out by message type
        and good<->dubious<->expired flap transitions."""
        try:
            led = getattr(self._dht, "peers", None)
            if led is None:
                return {"enabled": False}
            return led.snapshot()
        except Exception:
            return {"enabled": False}

    def get_listeners(self) -> dict:
        """The wave-scale listener-table snapshot:
        occupancy/tombstones/overflow of the device key-id table,
        buffered puts, match/flush/delivery counters, the windowed
        delivery-lag p95 and the soonest-expiring entries."""
        try:
            lt = getattr(self._dht, "listener_table", None)
            if lt is None:
                return {"enabled": False}
            return lt.snapshot()
        except Exception:
            return {"enabled": False}

    def get_pipeline_trace(self) -> dict:
        """Perfetto lane export of the retained wave timeline: one pid
        per lane (fill / device /
        drain), waves as slices linked to their ``dht.search.wave``
        spans.  Empty trace when the observatory is off."""
        try:
            obs = getattr(self._dht.wave_builder, "observatory", None)
            if obs is None or not obs.enabled:
                return {"traceEvents": [], "displayTimeUnit": "ms"}
            return obs.chrome_trace()
        except Exception:
            return {"traceEvents": [], "displayTimeUnit": "ms"}

    def get_trace(self, trace_id) -> list:
        """JSON-able span list of one distributed trace: the
        op root span plus every per-hop client span this node sent and
        every server span it recorded for that trace.  ``trace_id``
        accepts an int, a 32-hex string, or a TraceContext."""
        return tracing.get_tracer().spans(trace_id)

    def get_flight_recorder(self, limit: "int | None" = None,
                            name: "str | None" = None) -> dict:
        """The bounded-ring flight recorder dump (↔ the reference's
        ``Dht::dumpTables`` postmortem surface, structured): last-N
        spans + events (request transitions, timeouts, rate-limit
        drops, compactions, churn swaps, health transitions).

        ``name`` filters by event/span name substring at DUMP time
        (e.g. ``"health"`` keeps ``health_transition`` events and
        nothing else) — the ring itself is untouched, so eviction
        order is identical with or without a filter."""
        d = tracing.get_tracer().dump(name=name)
        if limit:
            d["spans"] = d["spans"][-limit:]
            d["events"] = d["events"][-limit:]
        return d

    def get_node_message_stats(self, incoming: bool = False) -> list:
        """[ping, find, get, listen, put] counters
        (↔ DhtRunner::getNodeMessageStats, dhtrunner.cpp:317-321)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._post(lambda dht: fut.set_result(
            dht.engine.get_node_message_stats(incoming)
            if hasattr(dht, "engine") else []), prio=True)
        return fut.result(10.0)

    def get_searches_log(self, af: int = 0) -> str:
        """(↔ DhtRunner::getSearchesLog, dhtrunner.cpp:305-309)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._post(lambda dht: fut.set_result(dht.get_searches_log(af)),
                   prio=True)
        return fut.result(10.0)

    def export_nodes(self) -> list:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._post_node(lambda dht: fut.set_result(dht.export_nodes()),
                        prio=True)
        return fut.result(10.0)

    def export_values(self) -> list:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._post_node(lambda dht: fut.set_result(dht.export_values()),
                        prio=True)
        return fut.result(10.0)

    def import_values(self, values: list) -> None:
        self._post_node(lambda dht: dht.import_values(values), prio=True)

    # ------------------------------------------------------------- shutdown
    def shutdown(self, cb=None) -> None:
        """Graceful stop of ongoing operations (dhtrunner.cpp:1060-1081)."""
        if not self.running:
            if cb:
                cb()
            return
        self._post(lambda dht: dht.shutdown(cb), prio=True)

    def join(self) -> None:
        """Stop threads, close sockets (↔ DhtRunner::join,
        dhtrunner.cpp:151-195)."""
        self.running = False
        self._net_running = False
        with self._cv:
            self._cv.notify_all()
        with self._bootstrap_cv:
            self._bootstrap_cv.notify_all()
        if self._stop_wr is not None:
            try:
                os.write(self._stop_wr, b"x")
            except OSError:
                pass
        for t in (self._dht_thread, self._rcv_thread,
                  self._native_thread, self._bootstrap_thread):
            if t is not None and t.is_alive():
                t.join(timeout=5.0)
        for sock in (self._sock4, self._sock6):
            if sock is not None:
                sock.close()
        self._sock4 = self._sock6 = None
        if self._udp is not None:
            if self._native_thread is not None and \
                    self._native_thread.is_alive():
                # receiver thread failed to join within timeout and may
                # still be blocked in the engine: freeing it would be a
                # use-after-free, so leak the handle instead
                log.warning("native receiver thread did not join; "
                            "leaking UDP engine handle")
                self._udp.detach()
            else:
                self._udp.close()
            self._udp = None
        self._native_thread = None
        if self._stop_rd is not None:
            os.close(self._stop_rd)
            os.close(self._stop_wr)
            self._stop_rd = self._stop_wr = None
        with self._ops_lock:
            self._pending_ops.clear()
            self._pending_ops_prio.clear()
        if self._proxy_client is not None:
            self._proxy_client.join()
            self._proxy_client = None
            self._proxy_dht = None
        self.use_proxy = False
        self._dht = None
