"""http_server: minimal HTTP control interface over one DHT node.

Analog of the reference tool (reference python/tools/http_server.py:
26-78, a twisted app): GET /<key>?id=..&user_type=.. runs a filtered
``get`` and returns ``{"<vid hex>": {"base64": ...}}``; POST /<key> with
``data`` (or ``base64``) + optional ``id``/``user_type`` form fields
puts a value.  Keys are a 40-hex infohash or any string (hashed with
InfoHash.get, like the reference).  Built on the stdlib HTTP server —
twisted is not a dependency here.

This is the *census/ops* helper; the full REST facade with streaming,
listen and push lives in opendht_tpu_torch.proxy.

Usage::

    python -m opendht_tpu_torch.testing.http_server -p 0 -hp 8080 \
        -b host:port [--cpu]

The port's copy of the JAX package's ``testing/http_server.py``,
behaviour unchanged but for the device: the CLI's node runs on the CUDA
card unless ``--cpu`` is given, and without a card (and without
``--cpu``) it raises before any socket is bound.
:class:`DhtHttpServer` serves whatever runner it is given.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .._device import resolve_device
from ..core.value import Value, Where
from ..infohash import InfoHash
from ..runtime.runner import DhtRunner

WHERE_FIELDS = ("id", "user_type", "value_type", "owner", "seq")


def _key_of(path_part: str) -> InfoHash:
    """40-hex → literal infohash, else hash the string
    (http_server.py:36,59)."""
    if len(path_part) == 40:
        try:
            return InfoHash(bytes.fromhex(path_part))
        except ValueError:
            pass
    return InfoHash.get(path_part)


def make_handler(node: DhtRunner):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code: int = 200) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            uri = u.path.lstrip("/")
            args = parse_qs(u.query)
            h = _key_of(uri)
            # build 'WHERE k=v,...' from whitelisted query params
            # (http_server.py:38-41); the reference's 'owner' param is
            # the Where grammar's 'owner_pk'
            clauses = ",".join(
                "%s=%s" % ("owner_pk" if k == "owner" else k, v[0])
                for k, v in args.items() if k in WHERE_FIELDS and v)
            try:
                where = Where("WHERE " + clauses) if clauses else None
            except ValueError as e:
                self._json({"error": str(e)}, code=400)
                return
            values = node.get_sync(h, where=where) or []
            self._json({"%x" % v.id:
                        {"base64": base64.b64encode(v.data).decode()}
                        for v in values})

        def do_POST(self):
            u = urlparse(self.path)
            uri = u.path.lstrip("/")
            ln = int(self.headers.get("Content-Length", 0))
            args = parse_qs(self.rfile.read(ln).decode())
            data = args.get("data", [None])[0]
            data = data.encode() if data is not None else None
            if not data and "base64" in args:
                data = base64.b64decode(args["base64"][0])
            try:
                vid = int(args.get("id", ["0"])[0])
            except ValueError:
                vid = 0
            user_type = args.get("user_type", [""])[0]
            if not data:
                self._json({"success": False,
                            "error": "no data parameter"}, code=400)
                return
            v = Value(data, value_id=vid, user_type=user_type)
            ok = node.put_sync(_key_of(uri), v, timeout=30.0)
            self._json({"success": bool(ok)})

    return Handler


class DhtHttpServer:
    """Bind the HTTP control interface to a running node."""

    def __init__(self, node: DhtRunner, http_port: int = 8080,
                 address: str = "127.0.0.1"):
        self.node = node
        self._httpd = ThreadingHTTPServer((address, http_port),
                                          make_handler(node))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dht-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Launch a DHT node with an HTTP control interface")
    p.add_argument("-p", "--port", type=int, default=0,
                   help="DHT port to bind")
    p.add_argument("-hp", "--http-port", type=int, default=8080)
    p.add_argument("-b", "--bootstrap", help="bootstrap address host:port")
    p.add_argument("--cpu", action="store_true",
                   help="run the node's tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    args = p.parse_args(argv)

    # the card unless --cpu; resolved before any socket is bound
    device = "cpu" if args.cpu else None
    resolve_device(device)
    node = DhtRunner()
    node.run(args.port, device=device)
    if args.bootstrap:
        host, _, port = args.bootstrap.partition(":")
        node.bootstrap(host, int(port or 4222))
    srv = DhtHttpServer(node, args.http_port)
    print("dht node %s on udp port %d, http port %d"
          % (node.get_node_id().hex()[:16], node.get_bound_port(), srv.port))
    try:
        import time
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
