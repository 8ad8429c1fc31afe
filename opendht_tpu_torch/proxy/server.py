"""DhtProxyServer: REST facade over a running DhtRunner.

Behavioral port of the reference proxy server (reference:
src/dht_proxy_server.cpp:70-93 routes, include/opendht/dht_proxy_server.h):

routes
    ``GET /``                  node info (node id + per-family stats)
    ``STATS /``                server stats (listen/put counts, request rate)
    ``GET /trace``             flight-recorder dump
    ``GET /trace/{id}``        one distributed trace's spans
                               (``?fmt=chrome`` = Perfetto-loadable dump)
    ``GET /{hash}``            stream values as JSON lines
    ``GET /{hash}/{value_id}`` one value by id
    ``LISTEN /{hash}``         long-poll stream of value updates
    ``POST /{hash}``           put a JSON value (``permanent`` supported,
                               with server-side refresh-or-expire
                               bookkeeping, dht_proxy_server.cpp:505-620)
    ``SIGN /{hash}``           sign the posted value with the node identity
    ``ENCRYPT /{hash}?to=``    sign+encrypt the posted value
    ``SUBSCRIBE /{hash}``      register a push listener (push gateway is a
                               pluggable callback — the reference posts to
                               a Gorush instance, :411-469)
    ``UNSUBSCRIBE /{hash}``    drop a push listener
    ``OPTIONS /{hash}``        CORS preflight

Values stream as line-delimited JSON exactly like the reference
(``Json::writeString(...) + "\\n"`` per value, :293).  The server is a
threading HTTP/1.0 server: each streaming request holds one handler
thread, responses are close-delimited.

The port's copy of the JAX package's ``proxy/server.py``, behaviour
unchanged, in front of the port's ``DhtRunner``.  The observability
routes (``GET /stats``, ``/profile``, ``/keyspace``, ``/reshard``,
``/cache``, ``/listeners``, ``/history``, ``/healthz``, ``/peers``,
``/pipeline``, ``/debug/bundle``) serve the port's own planes:
``GET /stats`` refreshes the runner's metrics, so it carries the port's
``dht_kernel_*`` ledger gauges once the ledger is computed, and
``GET /profile`` carries the OPEN-bound tracker, whose status follows
the node's device.
"""

from __future__ import annotations

import concurrent.futures
import json
import queue
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import urlparse, parse_qs

from .. import telemetry, tracing
from ..infohash import InfoHash
from ..core.value import Value
from .json_codec import value_to_json, value_from_json, permanent_deadline

# reference: proxy::OP_TIMEOUT/OP_MARGIN (include/opendht/proxy.h:25-26) —
# permanent ops expire server-side unless the client refreshes them; a
# refresh push is sent OP_MARGIN before expiry (dht_proxy_server.cpp:462-470).
OP_TIMEOUT = 60 * 60.0
OP_MARGIN = 5 * 60.0
STATS_PERIOD = 120.0            # dht_proxy_server.cpp:138-148

# strict query-param grammars for the history/trace routes: a
# bare int()/float() accepts Python literal niceties — digit-group
# underscores ('1_5'), sign prefixes ('+5'), surrounding whitespace,
# 'nan'/'inf' — that the malformed-param 400 contract must reject
# (the same leniency _trace_hex rejects)
_Q_INT = re.compile(r"^\d+$")
_Q_NUM = re.compile(r"^\d+(?:\.\d+)?$")


class ServerStats:
    """dht_proxy_server.h:71-116."""

    def __init__(self):
        self.listen_count = 0
        self.put_count = 0
        self.push_listeners_count = 0
        self.request_rate = 0.0
        self.total_requests = 0
        self.node_info: dict = {}

    def to_dict(self) -> dict:
        return {
            "listenCount": self.listen_count,
            "putCount": self.put_count,
            "pushListenersCount": self.push_listeners_count,
            "requestRate": self.request_rate,
            "totalRequests": self.total_requests,
            "nodeInfo": self.node_info,
        }


class _PermanentPut:
    __slots__ = ("value", "deadline", "client_id")

    def __init__(self, value: Value, deadline: float, client_id: str = ""):
        self.value = value
        self.deadline = deadline
        self.client_id = client_id


class _PushListener:
    __slots__ = ("key", "client_id", "token", "deadline",
                 "push_token", "is_android", "client_token", "refresh_sent")

    def __init__(self, key: InfoHash, client_id: str, token, deadline: float,
                 push_token: str = "", is_android: bool = True,
                 client_token: int = 0):
        self.key = key
        self.client_id = client_id
        self.token = token              # backend (runner.listen) token
        self.deadline = deadline
        self.push_token = push_token    # gateway device token (body "key")
        self.is_android = is_android    # body "platform" == "android"
        self.client_token = client_token  # client's token number (body "token")
        self.refresh_sent = False       # expiry-refresh push dispatched


class DhtProxyServer:
    """Serve a DhtRunner over REST (dht_proxy_server.cpp:96-136)."""

    def __init__(self, runner, port: int = 8080, *,
                 push_sender: Optional[Callable[[str, dict], None]] = None,
                 push_server: Optional[str] = None,
                 address: str = "127.0.0.1"):
        """``push_server`` ("host:port") enables the HTTP Gorush gateway
        client (↔ the reference's pushServer ctor arg,
        dht_proxy_server.cpp:96-136); ``push_sender`` is the injectable
        callback alternative, kept for tests and embedding."""
        self._runner = runner
        self._push_sender = push_sender
        self._gorush = None
        if push_server:
            from .push import GorushPushSender
            self._gorush = GorushPushSender(push_server)
        self.stats = ServerStats()
        self._req_times: list = []
        self._lock = threading.Lock()
        # (hash, value_id) -> _PermanentPut   (dht_proxy_server.cpp:505-620)
        self._puts: Dict[Tuple[InfoHash, int], _PermanentPut] = {}
        # (hash, client_id) -> _PushListener  (:411-469)
        self._push_listeners: Dict[Tuple[InfoHash, str], _PushListener] = {}

        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((address, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._stop = threading.Event()
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="proxy-http", daemon=True)
        self._serve_thread.start()
        self._maint_thread = threading.Thread(
            target=self._maintenance_loop, name="proxy-maint", daemon=True)
        self._maint_thread.start()

    # ------------------------------------------------------------------ api
    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._gorush is not None:
            self._gorush.join()

    def get_stats(self) -> ServerStats:
        return self.stats

    # ------------------------------------------------------------- internal
    def _count_request(self) -> None:
        now = time.monotonic()
        telemetry.get_registry().counter("dht_proxy_requests_total").inc()
        with self._lock:
            self.stats.total_requests += 1
            self._req_times.append(now)
            cutoff = now - 60.0
            while self._req_times and self._req_times[0] < cutoff:
                self._req_times.pop(0)
            self.stats.request_rate = len(self._req_times) / 60.0

    def prometheus_stats(self) -> str:
        """Text exposition for ``GET /stats`` (the reference's
        ``STATS /`` server-stats island joined to the unified registry).
        Refreshes the ServerStats gauges and — when the runner exposes
        ``get_metrics`` — the routing-table gauges, then dumps the whole
        process registry."""
        reg = telemetry.get_registry()
        with self._lock:
            reg.gauge("dht_proxy_listen_count").set(self.stats.listen_count)
            reg.gauge("dht_proxy_put_count").set(self.stats.put_count)
            reg.gauge("dht_proxy_push_listeners").set(
                self.stats.push_listeners_count)
            reg.gauge("dht_proxy_request_rate").set(self.stats.request_rate)
        get_metrics = getattr(self._runner, "get_metrics", None)
        if get_metrics is not None:
            try:
                get_metrics()        # refresh dht_routing_* gauges
            except Exception:
                pass
        return reg.prometheus()

    def _node_info(self) -> dict:
        """GET / payload (dht_proxy_server.cpp:206-232)."""
        import socket as _s
        r = self._runner
        info = {"node_id": r.get_node_id().hex(), "id": r.get_id().hex()}
        try:
            info["ipv4"] = r.get_node_stats(_s.AF_INET).to_dict()
        except Exception:
            info["ipv4"] = {}
        try:
            info["ipv6"] = r.get_node_stats(_s.AF_INET6).to_dict()
        except Exception:
            info["ipv6"] = {}
        try:
            # ingest surface: the wave builder's coalescing
            # health next to the routing stats (queue depth, occupancy
            # percentiles, sheds) — the JSON sibling of the
            # dht_ingest_* series GET /stats exports
            info["ingest"] = r._dht.wave_builder.snapshot()
        except Exception:
            info["ingest"] = {}
        return info

    def _maintenance_loop(self) -> None:
        """Expire unrefreshed permanent puts and push listeners; refresh
        the stats snapshot (dht_proxy_server.cpp:138-148, :560-620)."""
        last_stats = 0.0
        while not self._stop.wait(1.0):
            now = time.monotonic()
            with self._lock:
                expired_puts = [(k, p) for k, p in self._puts.items()
                                if p.deadline <= now]
                for k, _ in expired_puts:
                    del self._puts[k]
                expired_push = [k for k, l in self._push_listeners.items()
                                if l.deadline <= now]
                push_expired_records = [self._push_listeners.pop(k)
                                        for k in expired_push]
                self.stats.put_count = len(self._puts)
                self.stats.push_listeners_count = len(self._push_listeners)
            for (key, vid), _ in expired_puts:
                try:
                    self._runner.cancel_put(key, vid)
                except Exception:
                    pass
            for rec in push_expired_records:
                if rec.token is None:   # backend listen still registering;
                    continue            # do_SUBSCRIBE's re-check cancels it
                try:
                    self._runner.cancel_listen(rec.key, rec.token)
                except Exception:
                    pass
            # refresh pushes: OP_MARGIN before a listener expires, tell
            # the client to re-subscribe (dht_proxy_server.cpp:462-470:
            # expireNotifyJob sends {"timeout": key, "to", "token"})
            with self._lock:
                refresh = [l for l in self._push_listeners.values()
                           if not l.refresh_sent
                           and l.deadline - OP_MARGIN <= now]
                for l in refresh:
                    l.refresh_sent = True
            for rec in refresh:
                self._notify_push(rec, {
                    "timeout": rec.key.hex(),
                    "to": rec.client_id,
                    "token": str(rec.client_token),
                })
            if now - last_stats >= STATS_PERIOD or last_stats == 0.0:
                last_stats = now
                try:
                    self.stats.node_info = self._node_info()
                except Exception:
                    pass

    # Push notifications: the Gorush HTTP gateway gets the reference's
    # exact data shape (dht_proxy_server.cpp:446-470); the injected
    # callback additionally receives `extra` (value ids) for embedders.
    def _notify_push(self, rec: _PushListener, data: dict,
                     extra: Optional[dict] = None) -> None:
        if self._gorush is not None and rec.push_token:
            try:
                self._gorush.notify(rec.push_token, data, rec.is_android)
            except Exception:
                pass
        if self._push_sender is not None:
            try:
                self._push_sender(rec.client_id,
                                  dict(data, **extra) if extra else data)
            except Exception:
                pass


def _make_handler(server: DhtProxyServer):
    runner = server._runner

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"
        server_version = "OpenDhtTpuProxy/1.0"

        # silence default stderr logging
        def log_message(self, fmt, *args):
            pass

        # ------------------------------------------------------- helpers
        def _parse(self):
            u = urlparse(self.path)
            parts = [p for p in u.path.split("/") if p]
            return parts, parse_qs(u.query)

        def _send_json(self, obj, code: int = 200) -> None:
            body = (json.dumps(obj) + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str) -> None:
            self._send_json({"err": msg}, code)

        def _read_body_json(self) -> Optional[dict]:
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n) if n else b"{}"
                obj = json.loads(raw.decode() or "{}")
                return obj if isinstance(obj, dict) else None
            except Exception:
                return None

        def _hash_arg(self, parts) -> Optional[InfoHash]:
            if not parts:
                return None
            try:
                h = InfoHash(parts[0])
            except Exception:
                # reference hashes any non-hex key (dht_proxy_client
                # semantics); keep strict-hex here like the server.
                return None
            if not h:
                return None
            return h

        def _begin_stream(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()

        def _write_line(self, obj) -> bool:
            try:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()
                return True
            except (BrokenPipeError, ConnectionResetError, OSError):
                return False

        # --------------------------------------------------------- routes
        def do_OPTIONS(self):
            self.send_response(200)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header(
                "Access-Control-Allow-Methods",
                "OPTIONS, GET, POST, LISTEN, SIGN, ENCRYPT, "
                "SUBSCRIBE, UNSUBSCRIBE, STATS")
            self.send_header("Access-Control-Allow-Headers", "content-type")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            server._count_request()
            parts, _q = self._parse()
            if not parts:                      # GET / → node info (:206-232)
                self._send_json(server._node_info())
                return
            if parts == ["healthz"]:
                # GET /healthz → readiness probe: 200 when the
                # node's health verdict is healthy/degraded (serving,
                # possibly impaired), 503 when unhealthy or unknown
                # (disconnected, pre-first-tick, or health disabled) —
                # k8s/LB readiness semantics, with the full verdict +
                # per-signal/SLO attribution as the JSON body.  Like
                # /stats, "healthz" is not a valid hash so the path was
                # previously a 400 and stays unambiguous.
                rep = {}
                try:
                    rep = runner.get_health()
                except Exception:
                    pass
                verdict = rep.get("verdict", "unknown")
                ready = verdict in ("healthy", "degraded")
                body = {"ready": ready, "verdict": verdict,
                        "node_id": runner.get_node_id().hex(),
                        "status": runner.get_status().name,
                        "health": rep}
                self._send_json(body, 200 if ready else 503)
                return
            if parts == ["stats"]:
                # GET /stats → Prometheus text exposition of the unified
                # telemetry registry (extends the reference's
                # STATS / JSON route — "stats" is not a valid hash, so
                # the path was previously a 400 and stays unambiguous)
                body = server.prometheus_stats().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts == ["keyspace"]:
                # GET /keyspace → the keyspace traffic observatory
                # snapshot: 256-bin keyspace histogram,
                # heavy-hitter top-K with windowed estimates/shares +
                # hot flags, per-shard load attribution and the
                # imbalance ratio.  "keyspace" is not a valid hash, so
                # — like /stats — the path was previously a 400 and
                # stays unambiguous.
                # get_keyspace already degrades to {"enabled": False}
                # on any internal failure — no second wrapper here
                self._send_json(runner.get_keyspace())
                return
            if parts == ["cache"]:
                # GET /cache → the hot-key serving cache snapshot
                #: occupancy, per-entry hit counts, windowed
                # hit ratio, invalidations and the widened hot set.
                # "cache" is not a valid hash, so — like /stats — the
                # path was previously a 400 and stays unambiguous.
                # get_cache already degrades to {"enabled": False} on
                # any internal failure — no second wrapper here
                self._send_json(runner.get_cache())
                return
            if parts == ["reshard"]:
                # GET /reshard → the load-aware resharding snapshot
                #: layout generation + solved edges,
                # tick/swap/reason-labeled skip counters, sustain latch
                # age and post-swap refolded imbalance.  "reshard" is
                # not a valid hash, so — like /stats — the path was
                # previously a 400 and stays unambiguous.
                # get_reshard already degrades to {"enabled": False} on
                # any internal failure — no second wrapper here
                self._send_json(runner.get_reshard())
                return
            if parts == ["history"]:
                # GET /history[?since=SEC][&limit=N] → the
                # flight data recorder's retained frames (delta-encoded
                # registry history) with the server clocks for skew
                # estimation — what dhtmon --window/--since and the
                # timeline assembler consume instead of
                # scrape-diff-scrape.  "history" is not a valid hash,
                # so — like /stats — the path was previously a 400 and
                # stays unambiguous.
                since = limit = None
                sq = (_q.get("since") or [None])[0]
                lq = (_q.get("limit") or [None])[0]
                if sq is not None:
                    if not _Q_NUM.match(sq):
                        self._err(400, "invalid since/limit")
                        return
                    since = float(sq)
                if lq is not None:
                    if not _Q_INT.match(lq):
                        self._err(400, "invalid since/limit")
                        return
                    limit = int(lq)
                self._send_json(runner.get_history(since=since,
                                                   limit=limit))
                return
            if parts == ["debug", "bundle"]:
                # GET /debug/bundle → a fresh post-mortem black-box
                # bundle: last-N history frames + flight
                # ring + kernel ledger + keyspace/cache snapshots in
                # one artifact (summaries of the auto-captured bundles
                # ride along under "auto_captures").  "debug" is not a
                # valid hash, so the path was previously a 400 and
                # stays unambiguous.
                self._send_json(runner.dump_bundle())
                return
            if parts == ["profile"]:
                # GET /profile → the per-op latency waterfall:
                # per-stage dht_stage_seconds histograms
                # with p50/p95/p99 + bucket exemplars, the stage
                # budgets, the per-op decomposition ring and the live
                # OPEN-bound comparison; ?fmt=folded serves
                # flamegraph-shaped folded stacks as text/plain
                # ("stack weight" lines for flamegraph.pl/speedscope).
                # "profile" is not a valid hash, so — like /stats —
                # the path was previously a 400 and stays unambiguous.
                fmt = (_q.get("fmt") or [None])[0]
                if fmt == "folded":
                    from .. import waterfall as _wf
                    body = _wf.get_profiler().folded().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if fmt is not None:
                    self._err(400, "invalid fmt")
                    return
                # get_profile already degrades to {"enabled": False}
                # on any internal failure — no second wrapper here
                self._send_json(runner.get_profile())
                return
            if parts == ["pipeline"]:
                # GET /pipeline → the pipeline utilization observatory
                #: windowed device occupancy,
                # per-cause bubble attribution, measured fill∥device
                # overlap and the pipeline shape; ?fmt=trace serves
                # the Perfetto lane export (one pid per fill/device/
                # drain lane, waves as slices linked to their
                # dht.search.wave spans).  "pipeline" is not a valid
                # hash, so — like /profile — the path was previously a
                # 400 and stays unambiguous.
                fmt = (_q.get("fmt") or [None])[0]
                if fmt == "trace":
                    self._send_json(runner.get_pipeline_trace())
                    return
                if fmt is not None:
                    self._err(400, "invalid fmt")
                    return
                # get_pipeline already degrades to {"enabled": False}
                self._send_json(runner.get_pipeline())
                return
            if parts == ["listeners"]:
                # GET /listeners → the wave-scale listener-table
                # snapshot: occupancy/tombstones/overflow,
                # buffered puts, match/delivery counters and the
                # windowed delivery-lag p95.  "listeners" is not a
                # valid hash, so — like /stats — the route cannot
                # shadow a key fetch.  get_listeners already degrades
                # to {"enabled": False} on a node without the table.
                self._send_json(runner.get_listeners())
                return
            if parts == ["peers"]:
                # GET /peers → the per-peer network observatory
                #: per-peer srtt/rttvar/RTO,
                # request outcome counts, attempt timeouts + spurious
                # retransmits, bytes by message type and status flap
                # transitions — the wire-map assembler's scrape
                # surface.  "peers" is not a valid hash, so — like
                # /stats — the path was previously a 400 and stays
                # unambiguous.
                # get_peers already degrades to {"enabled": False} on
                # any internal failure — no second wrapper here
                self._send_json(runner.get_peers())
                return
            if parts[0] == "trace":
                # GET /trace[?name=] → the node's flight-recorder dump
                # (the reference's dumpTables as a scrapeable
                # surface), name-filterable like the REPL's
                # `dump [n] [name]` and get_flight_recorder(name=)
                # GET /trace/<id> → one trace's span list, or the
                # Perfetto-loadable Chrome dump with ?fmt=chrome.
                # "trace" is not a valid hash, so — like /stats — the
                # path was previously a 400 and stays unambiguous.
                # ?limit=N pagination: a full ring
                # dump over the proxy was unbounded; limit keeps the
                # NEWEST N spans and events.  Malformed (non-integer /
                # negative) limits are a 400, matching the
                # malformed-trace-id contract below.
                limit = None
                lq = (_q.get("limit") or [None])[0]
                if lq is not None:
                    if not _Q_INT.match(lq):
                        self._err(400, "invalid limit")
                        return
                    limit = int(lq)
                tr = tracing.get_tracer()
                if len(parts) == 1:
                    d = tr.dump(name=(_q.get("name") or [None])[0])
                    if limit is not None:
                        d["spans"] = d["spans"][-limit:] if limit else []
                        d["events"] = d["events"][-limit:] if limit else []
                        d["limit"] = limit
                    self._send_json(d)
                    return
                # a malformed (non-hex / oversized) trace id is a 400,
                # not an empty span list — only a WELL-FORMED unknown
                # id reports {"spans": []}
                if tracing._trace_hex(parts[1]) is None:
                    self._err(400, "invalid trace id")
                elif _q.get("fmt", [""])[0] == "chrome":
                    spans = tr.spans(parts[1])
                    if limit is not None:
                        spans = spans[-limit:] if limit else []
                    self._send_json(tracing.to_chrome_trace(spans))
                else:
                    spans = tr.spans(parts[1])
                    if limit is not None:
                        spans = spans[-limit:] if limit else []
                    self._send_json({"trace_id": parts[1],
                                     "spans": spans})
                return
            key = self._hash_arg(parts)
            if key is None:
                self._err(400, "invalid hash")
                return
            vid: Optional[int] = None
            if len(parts) > 1:                 # GET /{hash}/{vid} (:655-700)
                try:
                    vid = int(parts[1])
                except ValueError:
                    self._err(400, "invalid value id")
                    return
            done = threading.Event()
            lines: "queue.Queue" = queue.Queue()

            def get_cb(values):
                for v in values:
                    if vid is None or v.id == vid:
                        lines.put(v)
                return True

            def done_cb(ok, nodes):
                done.set()

            runner.get(key, get_cb, done_cb)
            self._begin_stream()
            ok = True
            while ok and not (done.is_set() and lines.empty()):
                try:
                    v = lines.get(timeout=0.05)
                except queue.Empty:
                    continue
                ok = self._write_line(value_to_json(v))

        def do_STATS(self):
            server._count_request()
            server.stats.node_info = server._node_info()
            self._send_json(server.stats.to_dict())

        def do_LISTEN(self):
            """Long-poll value stream (dht_proxy_server.cpp:320-409)."""
            server._count_request()
            parts, _q = self._parse()
            key = self._hash_arg(parts)
            if key is None:
                self._err(400, "invalid hash")
                return
            updates: "queue.Queue" = queue.Queue()

            def cb(values, expired):
                # the batched listener path delivers a wave's values as ONE callback — enqueue
                # the batch as a unit so the stream writer wakes once
                # per wave per stream (wire format unchanged: still
                # one JSON line per value, in delivery order)
                updates.put((list(values), expired))
                return True

            token_fut = runner.listen(key, cb)
            # 0 sentinel: the backend listen was shed at
            # ingest admission — no subscription exists, so fail the
            # request instead of streaming heartbeats forever.  Short
            # wait only: while the node is still bootstrapping the
            # listen op is legitimately queued (normal-op gating), and
            # the queued behavior — start streaming, subscription
            # materializes when the node connects — must be preserved.
            try:
                if token_fut.result(2.0) == 0:
                    self._err(503, "listen shed by ingest backpressure")
                    return
            except concurrent.futures.TimeoutError:
                pass                     # still queued: stream as before
            except Exception:
                self._err(500, "listen failed")
                return
            with server._lock:
                server.stats.listen_count += 1
            self._begin_stream()
            try:
                alive = True
                while alive:
                    try:
                        batch, expired = updates.get(timeout=1.0)
                    except queue.Empty:
                        # heartbeat so dead peers are detected
                        alive = self._write_line({"t": int(time.time())})
                        continue
                    for v in batch:
                        obj = value_to_json(v)
                        if expired:        # expired marker (:741-748)
                            obj["expired"] = True
                        alive = self._write_line(obj)
                        if not alive:
                            break
            finally:
                with server._lock:
                    server.stats.listen_count -= 1
                try:
                    runner.cancel_listen(key, token_fut)
                except Exception:
                    pass

        def do_POST(self):
            """Put a value (dht_proxy_server.cpp:471-620)."""
            server._count_request()
            parts, _q = self._parse()
            key = self._hash_arg(parts)
            if key is None:
                self._err(400, "invalid hash")
                return
            obj = self._read_body_json()
            if obj is None:
                self._err(400, "invalid json")
                return
            try:
                value = value_from_json(obj)
            except Exception:
                self._err(400, "invalid value")
                return
            timeout = permanent_deadline(obj, OP_TIMEOUT)
            permanent = timeout is not None
            done: "queue.Queue" = queue.Queue()
            runner.put(key, value,
                       lambda ok, nodes: done.put(bool(ok)),
                       permanent=permanent)
            try:
                ok = done.get(timeout=30.0)
            except queue.Empty:
                ok = None   # unknown: the put may still land on the DHT
            # track refresh bookkeeping unless the DHT definitively
            # rejected the put; an unknown (timed-out) permanent put is
            # recorded so the maintenance sweep cancels it at deadline
            # instead of leaking it on the DHT forever
            if ok is not False and permanent and value.id != Value.INVALID_ID:
                with server._lock:
                    server._puts[(key, value.id)] = _PermanentPut(
                        value, time.monotonic() + timeout)
                    server.stats.put_count = len(server._puts)
            if ok:
                self._send_json(value_to_json(value))
            else:
                self._err(502, "put failed")

        def do_SIGN(self):
            """dht_proxy_server.cpp:707-760."""
            server._count_request()
            parts, _q = self._parse()
            key = self._hash_arg(parts)
            obj = self._read_body_json()
            if key is None or obj is None:
                self._err(400, "invalid request")
                return
            try:
                value = value_from_json(obj)
                sdht = runner._dht          # SecureDht façade
                sdht.sign(value)
                self._send_json(value_to_json(value))
            except Exception as e:
                self._err(500, "sign failed: %s" % e)

        def do_ENCRYPT(self):
            """dht_proxy_server.cpp:762-820: body carries ``to``."""
            server._count_request()
            parts, q = self._parse()
            key = self._hash_arg(parts)
            obj = self._read_body_json()
            if key is None or obj is None:
                self._err(400, "invalid request")
                return
            to_hex = obj.pop("to", None) or (q.get("to") or [None])[0]
            if not to_hex:
                self._err(400, "missing 'to'")
                return
            try:
                value = value_from_json(obj)
                sdht = runner._dht
                done: "queue.Queue" = queue.Queue()

                def on_pk(pk):
                    try:
                        if pk is None:
                            done.put(None)
                        else:
                            sdht.sign(value)
                            done.put(sdht.encrypt(value, pk))
                    except Exception:
                        done.put(None)

                runner.find_public_key(InfoHash(to_hex), on_pk)
                ev = done.get(timeout=30.0)
                if ev is None:
                    self._err(404, "recipient key not found")
                else:
                    self._send_json(value_to_json(ev))
            except Exception as e:
                self._err(500, "encrypt failed: %s" % e)

        def do_SUBSCRIBE(self):
            """Register a push listener (dht_proxy_server.cpp:411-469)."""
            server._count_request()
            parts, _q = self._parse()
            key = self._hash_arg(parts)
            obj = self._read_body_json()
            if key is None or obj is None:
                self._err(400, "invalid request")
                return
            client_id = str(obj.get("client_id", ""))
            if not client_id:
                self._err(400, "missing client_id")
                return
            # gateway fields (dht_proxy_server.cpp:404-412): "key" is the
            # device push token, "platform" selects android/ios payloads,
            # "token" is the client's own listen-token number
            push_token = str(obj.get("key", ""))
            is_android = str(obj.get("platform", "android")) == "android"
            try:
                client_token = int(obj.get("token", 0) or 0)
            except (TypeError, ValueError):
                client_token = 0
            # reserve the slot under the lock so concurrent subscribes for
            # the same (key, client_id) can't both register a listener
            rec = _PushListener(key, client_id, None,
                                time.monotonic() + OP_TIMEOUT,
                                push_token=push_token, is_android=is_android,
                                client_token=client_token)
            with server._lock:
                existing = server._push_listeners.get((key, client_id))
                if existing is not None:       # refresh (:436-442)
                    existing.deadline = time.monotonic() + OP_TIMEOUT
                    existing.refresh_sent = False
                    existing.push_token = push_token or existing.push_token
                    existing.is_android = is_android
                    if client_token:
                        existing.client_token = client_token
                else:
                    server._push_listeners[(key, client_id)] = rec
                    server.stats.push_listeners_count = \
                        len(server._push_listeners)
            if existing is not None:
                self._send_json(
                    {"token": existing.client_token or id(existing)})
                return

            def cb(values, expired):
                # reference data shape :446-453; ids/expired ride along
                # for the injected-callback embedders.  One _notify_push
                # per callback: with the batched listener path
                # a whole wave's values arrive as ONE callback, so this
                # is one push dispatch per wave per subscription
                server._notify_push(
                    rec,
                    {"key": key.hex(), "to": client_id,
                     "token": str(rec.client_token)},
                    extra={"expired": bool(expired),
                           "ids": [v.id for v in values]})
                return True

            rec.token = runner.listen(key, cb)
            try:
                # 0 sentinel: shed at ingest admission — the
                # push subscription does not exist; drop the reserved
                # slot and tell the client instead of returning a token
                # that will never deliver.  Short wait only: a listen
                # still queued behind bootstrap gating keeps the
                # register-asynchronously behavior.
                if rec.token.result(2.0) == 0:
                    with server._lock:
                        if server._push_listeners.get(
                                (key, client_id)) is rec:
                            del server._push_listeners[(key, client_id)]
                            server.stats.push_listeners_count = \
                                len(server._push_listeners)
                    self._err(503, "listen shed by ingest backpressure")
                    return
            except concurrent.futures.TimeoutError:
                pass                     # still queued: register as before
            except Exception:
                self._err(500, "listen failed")
                return
            # a concurrent UNSUBSCRIBE (or expiry sweep) may have removed
            # the record while the backend listen was registering; tear
            # the fresh listener down instead of leaking it
            with server._lock:
                still_mine = server._push_listeners.get(
                    (key, client_id)) is rec
            if not still_mine:
                try:
                    runner.cancel_listen(key, rec.token)
                except Exception:
                    pass
                self._err(410, "unsubscribed")
                return
            self._send_json({"token": rec.client_token or id(rec)})

        def do_UNSUBSCRIBE(self):
            """dht_proxy_server.cpp:548-554."""
            server._count_request()
            parts, _q = self._parse()
            key = self._hash_arg(parts)
            obj = self._read_body_json()
            if key is None or obj is None:
                self._err(400, "invalid request")
                return
            client_id = str(obj.get("client_id", ""))
            with server._lock:
                rec = server._push_listeners.pop((key, client_id), None)
                server.stats.push_listeners_count = len(server._push_listeners)
            if rec is not None and rec.token is not None:
                try:
                    runner.cancel_listen(rec.key, rec.token)
                except Exception:
                    pass
            self._send_json({"ok": rec is not None})

    return Handler
