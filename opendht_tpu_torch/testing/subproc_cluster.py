"""Out-of-process cluster tier: a whole DHT cluster in a CHILD process,
remote-controlled over a msgpack-stdin RPC channel.

Analog of the reference's ``DhtNetworkSubProcess`` (reference
python/tools/dht/network.py:42-281), which spawns clusters in separate
processes (there: via NSPopen into a netns) and drives them with
line-commands over stdin.  This build keeps the process boundary —
it is what makes concurrency bugs in runner/engine visible instead of
GIL-masked, and lets a test kill an entire cluster with one signal —
but upgrades the control channel to length-delimited msgpack request/
response frames (the project wire codec) instead of ad-hoc text.

Protocol (child stdin → request, child stdout → response, stderr free
for logs):  each frame is one msgpack map ``{"op": str, ...}`` /
``{"ok": bool, ...}``.  Ops:

  launch {n}            → {ok, ports: [int], ids: [bytes]}
  resize {n}            → {ok, n}
  bootstrap {host,port} → {ok}   (every node dials the address —
                                  interconnects clusters across processes)
  put {key, value}      → {ok, stored: bool}
  get {key}             → {ok, values: [bytes]}
  ids {}                → {ok, ids: [bytes]}
  stats {}              → {ok, n, msgs: int}
  quit {}               → {ok} then child exits

The port's copy of the JAX package's ``testing/subproc_cluster.py``,
with the same ops, replies and frame bytes (the port's own codec,
:mod:`opendht_tpu_torch._msgpack`, packs and streams them as the
``msgpack`` wheel does).  What differs is the device:

- The child gets its device on its argv (``--device cuda`` or
  ``--device cpu``); ``ClusterSubProcess(device=None)`` means the CUDA
  card and raises without one before any child starts.  A child asked
  for the card on a host without one answers every op but ``quit`` with
  the RuntimeError's text, so the parent raises; it never carries on on
  the CPU.
- On the card the parent builds the select kernels (and the native UDP
  engine) before the child starts; the child only loads them.  Then it
  warms up before any node binds: CUDA's context, the kernels' library,
  and one resolve through the device route, so that context creation
  never stalls the packet path.
- stdout is the RPC channel.  The child keeps fd 1 for its frames only
  and points fd 1 at its stderr before anything else runs, so a stray
  ``print`` or library warning cannot corrupt the frame stream.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from .. import _msgpack
from .._device import resolve_device

# the directory holding the opendht_tpu_torch package: the child imports
# it from there whatever its working directory
_ROOT = str(Path(__file__).resolve().parents[2])


def child_argv(device) -> list:
    """The child's command line for ``device`` (a torch.device or its
    string)."""
    # fd 1 is set aside for frames before anything is imported
    boot = ("import os, sys; frames = os.dup(1); os.dup2(2, 1); "
            "from opendht_tpu_torch.testing.subproc_cluster import "
            "_child_main; sys.exit(_child_main(sys.argv[1:], frames))")
    return [sys.executable, "-c", boot, "--device", str(device)]


def child_env() -> dict:
    """The child's environment: this one, with the package's directory
    first on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def _prebuild(device) -> None:
    """On the card: build what the child would otherwise build on first
    use, before it starts (a child never runs a compiler)."""
    if device.type != "cuda":
        return
    from ..native import available
    from ..ops import _build
    _build.build_all()
    available()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class ClusterSubProcess:
    """Parent-side handle: spawn, RPC, and (ungracefully) kill a child
    process hosting a whole cluster of live UDP DHT nodes."""

    def __init__(self, n_nodes: int = 0, *, timeout: float = 60.0,
                 argv_prefix: tuple = (), device=None):
        """``argv_prefix``: argv prepended to the child command — e.g.
        ``("ip", "netns", "exec", ns)`` runs the whole cluster inside a
        network namespace (the real-kernel tier, testing/netns_net.py).
        ``device``: where the child's nodes keep their tables (None =
        the CUDA card, raising without one before the child starts)."""
        self.timeout = timeout
        self.device = resolve_device(device)
        _prebuild(self.device)
        self.proc = subprocess.Popen(
            [*argv_prefix, *child_argv(self.device)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=child_env())
        self._unpacker = _msgpack.Unpacker(raw=True)
        self.ports: list[int] = []
        self.ids: list[bytes] = []
        if n_nodes:
            try:
                self.launch(n_nodes)
            except BaseException:
                self.kill()
                raise

    # -- framing -----------------------------------------------------------
    def _call(self, op: str, **kw) -> dict:
        import selectors
        req = {"op": op, **kw}
        self.proc.stdin.write(_msgpack.packb(req))
        self.proc.stdin.flush()
        deadline = time.monotonic() + self.timeout
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        try:
            while True:
                for msg in self._unpacker:
                    out = {k.decode(): v for k, v in msg.items()}
                    if not out.get("ok"):
                        raise RuntimeError(
                            f"child {op} failed: {out.get('error')!r}")
                    return out
                # poll with a bounded wait so a hung-but-alive child
                # raises TimeoutError instead of blocking read1 forever
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"child {op} timed out after {self.timeout}s")
                if not sel.select(timeout=min(left, 1.0)):
                    continue
                chunk = self.proc.stdout.read1(65536)
                if not chunk:
                    raise RuntimeError(
                        f"child died mid-{op} (rc={self.proc.poll()})")
                self._unpacker.feed(chunk)
        finally:
            sel.close()

    # -- cluster ops -------------------------------------------------------
    def launch(self, n: int) -> list[int]:
        out = self._call("launch", n=n)
        self.ports = list(out["ports"])
        self.ids = list(out["ids"])
        return self.ports

    def resize(self, n: int) -> None:
        self._call("resize", n=n)

    def bootstrap(self, host: str, port: int) -> None:
        self._call("bootstrap", host=host, port=port)

    def put(self, key: bytes, value: bytes) -> bool:
        return bool(self._call("put", key=key, value=value)["stored"])

    def get(self, key: bytes) -> list[bytes]:
        return list(self._call("get", key=key)["values"])

    def node_ids(self) -> list[bytes]:
        return list(self._call("ids")["ids"])

    def stats(self) -> dict:
        return self._call("stats")

    # -- lifecycle ---------------------------------------------------------
    def quit(self) -> None:
        """Graceful shutdown: nodes join, child exits 0."""
        try:
            self._call("quit")
        except Exception:
            pass
        self.proc.wait(timeout=self.timeout)

    def kill(self) -> None:
        """Simulate whole-cluster failure: SIGKILL, no goodbyes — every
        node in the child vanishes without expiring its peers' routing
        entries (↔ the reference churn scenarios killing NSPopen
        clusters)."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=self.timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.quit()


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------

def _frames_out(frames_fd=None):
    """A writer on the process's original fd 1 (``frames_fd``, its copy
    if the boot line made one), which from here on carries frames only:
    fd 1 itself, and so ``sys.stdout``, points at stderr."""
    if frames_fd is None:
        frames_fd = os.dup(1)
        os.dup2(2, 1)
    return os.fdopen(frames_fd, "wb")


def _warm_up(device: str):
    """Resolve ``device`` and warm it before any node binds: on the card
    CUDA's context, the kernels' library (built by the parent) and one
    resolve through the device route (a NodeTable lookup of more than
    HOST_SCAN_MAX_QUERIES targets, Snapshot.lookup_launch); on the CPU
    the same resolve through the plain versions."""
    import torch
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        from ..ops import _build
        for stem in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
            if not _build.library_path(stem).is_file():
                raise RuntimeError(
                    f"the {stem} kernels are not built: the parent builds "
                    "them before a child starts (ops/_build.build_all)")
            _build.library(stem)
    from ..core.table import HOST_SCAN_MAX_QUERIES, NodeTable
    from ..infohash import InfoHash
    from ..sockaddr import SockAddr
    warm = NodeTable(InfoHash.get("warmup-self"), device=dev)
    warm.insert(InfoHash.get("warmup-peer"), SockAddr("127.0.0.1", 1), 0.0,
                confirm=2)
    warm.find_closest([InfoHash.get("warmup-target-%d" % i)
                       for i in range(HOST_SCAN_MAX_QUERIES + 1)], now=0.0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dev


def _child_main(argv=None, frames_fd=None) -> int:
    import argparse
    stdout = _frames_out(frames_fd)
    p = argparse.ArgumentParser(prog="subproc_cluster child")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..core.value import Value
    from ..infohash import InfoHash
    from .dhtcluster import NodeCluster

    cluster, startup_error = None, None
    try:
        cluster = NodeCluster(device=_warm_up(args.device))
    except Exception as e:          # every op but quit reports it
        startup_error = e
    stdin = sys.stdin.buffer
    unpacker = _msgpack.Unpacker(raw=True)

    def reply(**kw):
        stdout.write(_msgpack.packb({"ok": True, **kw}))
        stdout.flush()

    def fail(err):
        import traceback
        text = ("".join(traceback.format_exception(err)).strip()
                if isinstance(err, BaseException) else str(err))
        stdout.write(_msgpack.packb({"ok": False, "error": text}))
        stdout.flush()

    while True:
        chunk = stdin.read1(65536)
        if not chunk:
            break
        unpacker.feed(chunk)
        for msg in unpacker:
            req = {k.decode(): v for k, v in msg.items()}
            op = req.get("op", b"").decode() \
                if isinstance(req.get("op"), bytes) else req.get("op")
            try:
                if op == "quit":
                    reply()
                    if cluster is not None:
                        cluster.resize(0)
                    return 0
                if startup_error is not None:
                    fail(startup_error)
                elif op == "launch":
                    cluster.resize(int(req["n"]))
                    reply(ports=[n.get_bound_port() for n in cluster.nodes],
                          ids=[bytes(n.get_node_id())
                               for n in cluster.nodes])
                elif op == "resize":
                    cluster.resize(int(req["n"]))
                    reply(n=len(cluster.nodes))
                elif op == "bootstrap":
                    host = req["host"]
                    host = host.decode() if isinstance(host, bytes) else host
                    for n in cluster.nodes:
                        n.bootstrap(host, int(req["port"]))
                    reply()
                elif op == "put":
                    ok = cluster.nodes[0].put_sync(
                        InfoHash(req["key"]), Value(req["value"]),
                        timeout=30.0)
                    reply(stored=bool(ok))
                elif op == "get":
                    vals = cluster.nodes[0].get_sync(
                        InfoHash(req["key"]), timeout=30.0) or []
                    reply(values=[bytes(v.data) for v in vals])
                elif op == "ids":
                    reply(ids=[bytes(n.get_node_id())
                               for n in cluster.nodes])
                elif op == "stats":
                    msgs = 0
                    for n in cluster.nodes:
                        st = n.get_node_message_stats()
                        msgs += sum(st) if st else 0
                    reply(n=len(cluster.nodes), msgs=msgs)
                else:
                    fail(f"unknown op {op!r}")
            except Exception as e:                      # keep serving
                fail(e)
    if cluster is not None:
        cluster.resize(0)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.exit(_child_main([a for a in sys.argv[1:] if a != "--child"]))
    print(__doc__)
