"""DhtProxyClient: the DhtInterface over REST instead of UDP.

Behavioral port of the reference proxy client (reference:
src/dht_proxy_client.cpp, include/opendht/dht_proxy_client.h:1-383):

- ``get``  — streaming ``GET /{hash}`` parsing line-delimited JSON
  (:243-314), filter applied client-side.
- ``put``  — ``POST /{hash}``; permanent puts are re-sent periodically so
  the proxy's server-side bookkeeping keeps them alive (:316-437).
- ``listen`` — a background long-poll ``LISTEN /{hash}`` per subscribed
  key with a value cache deduplicating repeats and emitting expirations
  (:465-620); reconnects with backoff while active.
- status — polling ``GET /`` for the proxy's node info (:211-241):
  reachable proxy + known nodes ⇒ Connected.

The client is ``DhtInterface``-shaped: :class:`SecureDht` can wrap it
unchanged (the reference hot-swaps the same way, dhtrunner.cpp:967-975),
which is what gives signed/encrypted puts over REST.

The port's copy of the JAX package's ``proxy/client.py``, behaviour
unchanged; it talks to either package's ``DhtProxyServer``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Callable, Dict, List, Optional

from ..infohash import InfoHash
from ..core.value import Value, ValueType, TypeStore, Filters
from ..runtime.config import NodeStatus, NodeStats
from .json_codec import value_to_json, value_from_json

# re-send period for permanent puts; must undercut the server's
# OP_TIMEOUT window (reference: proxy::OP_TIMEOUT − OP_MARGIN).
PUT_REFRESH_PERIOD = 5 * 60.0
STATUS_PERIOD = 15.0
RECONNECT_BACKOFF = 1.0


class _ProxyListen:
    __slots__ = ("key", "cb", "f", "thread", "active", "cache")

    def __init__(self, key: InfoHash, cb, f):
        self.key = key
        self.cb = cb
        self.f = f
        self.thread: Optional[threading.Thread] = None
        self.active = True
        #: value id -> Value already delivered (ValueCache dedup role)
        self.cache: Dict[int, Value] = {}


class DhtProxyClient:
    """REST backend with the Dht surface (dht_proxy_client.h:60-383)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8080, *,
                 client_id: str = "", timeout: float = 30.0):
        self.host = host
        self.port = int(port)
        self.client_id = client_id
        self.timeout = timeout
        self.types = TypeStore()
        self._id = InfoHash.get_random()
        self._lock = threading.Lock()
        self._listen_token = 1
        self._listens: Dict[int, _ProxyListen] = {}
        #: (key, value id) -> (key, Value) for permanent re-puts (:316-437)
        self._puts: Dict[tuple, tuple] = {}
        self._running = True
        self._status = NodeStatus.CONNECTING
        self._maint = threading.Thread(target=self._maintenance_loop,
                                       name="proxy-client", daemon=True)
        self._maint.start()

    # ------------------------------------------------------------ transport
    def _conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _request_json(self, method: str, path: str,
                      body: Optional[dict] = None) -> Optional[dict]:
        try:
            c = self._conn()
            payload = json.dumps(body).encode() if body is not None else None
            c.request(method, path, body=payload,
                      headers={"Content-Type": "application/json"}
                      if payload else {})
            r = c.getresponse()
            data = r.read()
            c.close()
            if r.status >= 400:
                return None
            return json.loads(data.decode() or "{}")
        except Exception:
            return None

    def _stream_lines(self, method: str, path: str,
                      line_cb: Callable[[dict], bool],
                      idle_timeout: Optional[float] = None) -> bool:
        """Issue a streaming request, invoking ``line_cb`` per JSON line.
        Returns True when the stream ended cleanly."""
        c = None
        try:
            c = self._conn()
            if idle_timeout is not None:
                c.timeout = idle_timeout
            c.request(method, path)
            r = c.getresponse()
            if r.status >= 400:
                return False
            buf = b""
            while True:
                chunk = r.read1(65536) if hasattr(r, "read1") else r.read(4096)
                if not chunk:
                    return True
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        obj = json.loads(line.decode())
                    except Exception:
                        continue
                    if not line_cb(obj):
                        return True
        except Exception:
            return False
        finally:
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass

    # ------------------------------------------------------------ identity
    def get_id(self) -> InfoHash:
        return self._id

    def get_node_id(self) -> InfoHash:
        return self._id

    def register_type(self, vt: ValueType) -> None:
        self.types.register_type(vt)

    def is_running(self, af: int = 0) -> bool:
        return self._running

    # ------------------------------------------------------------------ ops
    def get(self, key: InfoHash, get_cb=None, done_cb=None,
            f=None, where=None) -> None:
        """Async streaming GET (dht_proxy_client.cpp:243-314)."""
        flt = f
        if where is not None:
            try:
                flt = Filters.chain(f, where.get_filter())
            except Exception:
                pass

        def run():
            seen: List[Value] = []

            def on_line(obj) -> bool:
                try:
                    v = value_from_json(obj)
                except Exception:
                    return True
                if flt is not None and not flt(v):
                    return True
                if any(s == v for s in seen):
                    return True
                seen.append(v)
                if get_cb is not None:
                    return bool(get_cb([v]))
                return True

            ok = self._stream_lines("GET", "/" + key.hex(), on_line)
            if done_cb:
                done_cb(ok, [])

        threading.Thread(target=run, daemon=True).start()

    def get_sync(self, key: InfoHash, timeout: Optional[float] = 30.0,
                 f=None, where=None) -> List[Value]:
        ev = threading.Event()
        out: List[Value] = []
        self.get(key, lambda vs: out.extend(vs) or True,
                 lambda ok, ns: ev.set(), f, where)
        ev.wait(timeout)
        return out

    def query(self, key: InfoHash, query_cb, done_cb=None, q=None) -> None:
        """Client-side query: full get then project fields locally —
        the proxy protocol has no field-query verb (the reference sends
        the whole value too, dht_proxy_client.cpp:243-259)."""
        fields = getattr(getattr(q, "select", None), "get_selection",
                         lambda: [])()

        def gcb(values: List[Value]) -> bool:
            if q is not None and getattr(q, "where", None) is not None:
                wf = q.where.get_filter()
                values = [v for v in values if wf is None or wf(v)]
            if not values:
                return True
            if fields:
                return bool(query_cb([v.pack_fields(fields)
                                      for v in values]))
            return bool(query_cb(values))

        self.get(key, gcb, done_cb)

    def put(self, key: InfoHash, value: Value, done_cb=None,
            created: Optional[float] = None, permanent: bool = False) -> None:
        """POST, with periodic re-send when permanent
        (dht_proxy_client.cpp:316-437)."""
        if value.id == Value.INVALID_ID:
            from ..core.value import random_value_id
            value.id = random_value_id()

        def run():
            body = value_to_json(value)
            if permanent:
                body["permanent"] = True
            res = self._request_json("POST", "/" + key.hex(), body)
            if permanent and res is not None:
                with self._lock:
                    self._puts[(key, value.id)] = (key, value)
            if done_cb:
                done_cb(res is not None, [])

        threading.Thread(target=run, daemon=True).start()

    def cancel_put(self, key: InfoHash, vid: int) -> bool:
        with self._lock:
            return self._puts.pop((key, vid), None) is not None

    def get_put(self, key: InfoHash, vid: Optional[int] = None):
        """Announced-value lookup (↔ DhtProxyClient::getPut): returns the
        tracked permanent put for (key, vid), a list for the key when
        ``vid`` is None, else None."""
        with self._lock:
            if vid is not None:
                rec = self._puts.get((key, vid))
                return rec[1] if rec else None
            return [v for (k, _vid), (_k, v) in self._puts.items()
                    if k == key]

    def listen(self, key: InfoHash, cb, f=None, where=None) -> int:
        """Long-poll LISTEN (dht_proxy_client.cpp:465-620)."""
        flt = f
        if where is not None:
            try:
                flt = Filters.chain(f, where.get_filter())
            except Exception:
                pass
        with self._lock:
            token = self._listen_token
            self._listen_token += 1
            rec = _ProxyListen(key, cb, flt)
            self._listens[token] = rec

        def run():
            while rec.active and self._running:
                def on_line(obj) -> bool:
                    if not rec.active:
                        return False
                    if "t" in obj and "id" not in obj:
                        return True            # heartbeat
                    try:
                        v = value_from_json(obj)
                    except Exception:
                        return True
                    if rec.f is not None and not rec.f(v):
                        return True
                    expired = bool(obj.get("expired"))
                    if expired:
                        rec.cache.pop(v.id, None)
                        return bool(rec.cb([v], True))
                    known = rec.cache.get(v.id)
                    if known is not None and known == v:
                        return True            # dedup on reconnect replay
                    rec.cache[v.id] = v
                    return bool(rec.cb([v], False))

                self._stream_lines("LISTEN", "/" + key.hex(), on_line,
                                   idle_timeout=max(self.timeout, 30.0))
                if rec.active and self._running:
                    time.sleep(RECONNECT_BACKOFF)

        rec.thread = threading.Thread(target=run, daemon=True)
        rec.thread.start()
        return token

    def cancel_listen(self, key: InfoHash, token) -> bool:
        with self._lock:
            rec = self._listens.pop(token, None)
        if rec is None:
            return False
        rec.active = False
        return True

    # ------------------------------------------------------ push (SUBSCRIBE)
    def subscribe(self, key: InfoHash, *, push_token: str = "",
                  platform: str = "android",
                  token: int = 0) -> Optional[dict]:
        """Register for push notifications (dht_proxy_client.cpp:622-700).
        Requires a ``client_id``; ``push_token``/``platform``/``token``
        are the gateway fields the reference sends (body "key",
        "platform", "token" — dht_proxy_server.cpp:404-412)."""
        if not self.client_id:
            return None
        body = {"client_id": self.client_id}
        if push_token:
            body["key"] = push_token
            body["platform"] = platform
        if token:
            body["token"] = token
        return self._request_json("SUBSCRIBE", "/" + key.hex(), body)

    def unsubscribe(self, key: InfoHash) -> Optional[dict]:
        if not self.client_id:
            return None
        return self._request_json("UNSUBSCRIBE", "/" + key.hex(),
                                  {"client_id": self.client_id})

    # ----------------------------------------------------------- inspection
    def get_status(self, af: int = 0) -> NodeStatus:
        return self._status

    def get_proxy_info(self) -> Optional[dict]:
        return self._request_json("GET", "/")

    def get_nodes_stats(self, af: int = 0) -> NodeStats:
        import socket as _s
        info = self.get_proxy_info() or {}
        fam = info.get("ipv6" if af == _s.AF_INET6 else "ipv4", {}) or {}
        st = NodeStats()
        st.good_nodes = int(fam.get("good", 0))
        st.dubious_nodes = int(fam.get("dubious", 0))
        st.searches = int(fam.get("searches", 0))
        st.table_depth = int(fam.get("table_depth", 0))
        return st

    # ---------------------------------------------------------- maintenance
    def _maintenance_loop(self) -> None:
        """Status poll + permanent-put refresh
        (dht_proxy_client.cpp:211-241, :316-437)."""
        last_refresh = time.monotonic()
        while self._running:
            info = self.get_proxy_info()
            if info is None:
                self._status = NodeStatus.DISCONNECTED
            else:
                known = 0
                for fam in ("ipv4", "ipv6"):
                    stats = info.get(fam, {}) or {}
                    known += (int(stats.get("good", 0))
                              + int(stats.get("dubious", 0)))
                self._status = (NodeStatus.CONNECTED if known > 0
                                else NodeStatus.CONNECTING)
            now = time.monotonic()
            if now - last_refresh >= PUT_REFRESH_PERIOD:
                last_refresh = now
                with self._lock:
                    puts = list(self._puts.values())
                for key, value in puts:
                    body = value_to_json(value)
                    body["permanent"] = True
                    self._request_json("POST", "/" + key.hex(), body)
            t0 = time.monotonic()
            while self._running and time.monotonic() - t0 < STATUS_PERIOD:
                time.sleep(0.2)

    def shutdown(self, cb=None) -> None:
        if cb:
            cb()

    def join(self) -> None:
        self._running = False
        with self._lock:
            listens = list(self._listens.values())
            self._listens.clear()
        for rec in listens:
            rec.active = False

    # parity with Dht's periodic-driven surface: nothing to pump — all
    # client I/O lives on its own threads (the reference pumps its own
    # Scheduler the same way, dht_proxy_client.cpp:211+).
    def periodic(self, data, from_addr, now: Optional[float] = None) -> float:
        return time.monotonic() + 10.0
