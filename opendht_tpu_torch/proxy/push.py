"""Push-notification gateway client (Gorush-shaped).

HTTP port of the reference sender (src/dht_proxy_server.cpp:548-583):
every notification POSTs ``http://<push_server>/api/push`` with

    {"notifications": [{
        "tokens": [<device push token>],
        "platform": 2 | 1,            # android | ios (gorush convention)
        "data": {...},                # e.g. {"key", "to", "token"}
        "priority": "high",
        "time_to_live": 600,
    }]}

The reference fires requests asynchronously (restbed::Http::async) and
ignores the response; here a single daemon worker drains a queue so a
slow or dead gateway never blocks DHT listener callbacks.  (The port's
copy of the JAX package's ``proxy/push.py``.)
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import urllib.request

log = logging.getLogger("opendht_tpu_torch.proxy.push")

HTTP_PROTO = "http://"          # proxy.h:27


class GorushPushSender:
    """Fire-and-forget Gorush client; one worker thread, bounded queue."""

    def __init__(self, push_server: str, *, timeout: float = 10.0,
                 max_queue: int = 1024):
        self.push_server = push_server
        self._timeout = timeout
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self.sent = 0
        self.dropped = 0
        self.errors = 0
        self._worker = threading.Thread(target=self._run, name="push-gorush",
                                        daemon=True)
        self._worker.start()

    def notify(self, push_token: str, data: dict,
               is_android: bool = True) -> None:
        """Queue one notification (dht_proxy_server.cpp:548-583 shape)."""
        body = json.dumps({"notifications": [{
            "tokens": [push_token],
            "platform": 2 if is_android else 1,
            "data": data,
            "priority": "high",
            "time_to_live": 600,
        }]}).encode()
        try:
            self._q.put_nowait(body)
        except queue.Full:
            self.dropped += 1

    def join(self, timeout: float = 5.0) -> None:
        """Drain the queue (best-effort) — for tests and shutdown."""
        self._q.put(None)
        self._worker.join(timeout=timeout)

    # ------------------------------------------------------------- internal
    def _run(self) -> None:
        while True:
            body = self._q.get()
            if body is None:
                return
            req = urllib.request.Request(
                HTTP_PROTO + self.push_server + "/api/push", data=body,
                headers={"Content-Type": "application/json", "Accept": "*/*"},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self._timeout):
                    pass
                self.sent += 1
            except Exception as e:
                self.errors += 1
                log.debug("push gateway error: %s", e)
