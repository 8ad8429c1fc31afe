"""Shared CLI plumbing for the tools (↔ reference tools/tools_common.h:
argv parsing — port, bootstrap, netid, identity, proxy, device,
logging — plus identity save/load and the node-info dump).

``--cpu`` runs the tool's node on the host; without it the node runs on
the CUDA card, and ``setup_node`` raises when there is none."""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Tuple

from .._device import resolve_device
from ..infohash import InfoHash
from ..runtime.config import Config
from ..runtime.runner import DhtRunner, RunnerConfig
from ..utils import lazy_module

# crypto is a CALL-time dependency only (identity generate/load/save):
# lazy so the CLI tools import — and the identity-less REPL/scanner
# paths run — without the `cryptography` wheel (same pattern as
# runtime/runner.py)
crypto = lazy_module("opendht_tpu_torch.crypto")


def make_arg_parser(description: str) -> argparse.ArgumentParser:
    """(↔ parseArgs, tools_common.h:120-210)"""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-p", "--port", type=int, default=0,
                   help="UDP port to bind (default: any)")
    p.add_argument("-b", "--bootstrap", default="",
                   help="bootstrap node host[:port]")
    p.add_argument("-n", "--network", type=int, default=0,
                   help="network id (partitions the DHT)")
    p.add_argument("-i", "--identity", action="store_true",
                   help="generate a cryptographic identity")
    p.add_argument("--save-identity", default="",
                   help="path prefix to save/load the identity")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="enable debug logging")
    p.add_argument("--proxyserver", type=int, default=0,
                   help="run a REST proxy server on this port")
    p.add_argument("--proxyclient", default="",
                   help="use a REST proxy at host:port instead of UDP")
    p.add_argument("--cpu", action="store_true",
                   help="run the node's tables on the host (default: the "
                        "CUDA card, and no card is an error)")
    return p


def parse_bootstrap(spec: str) -> Optional[Tuple[str, int]]:
    """host[:port], [v6]:port, or bare IPv6 literal → (host, port)."""
    if not spec:
        return None
    if spec.startswith("["):                    # [2001:db8::1]:4222
        host, _, rest = spec[1:].partition("]")
        port = rest.lstrip(":")
    elif spec.count(":") == 1:                  # host:port
        host, _, port = spec.partition(":")
    else:                                       # bare host or IPv6 literal
        host, port = spec, ""
    return host, int(port or 4222)


def load_identity(path_prefix: str) -> Optional[crypto.Identity]:
    """(↔ loadIdentity, tools_common.h:216-245)"""
    key_path, crt_path = path_prefix + ".pem", path_prefix + ".crt"
    if not (os.path.exists(key_path) and os.path.exists(crt_path)):
        return None
    with open(key_path, "rb") as f:
        key = crypto.PrivateKey(f.read())
    with open(crt_path, "rb") as f:
        cert = crypto.Certificate(f.read())
    return crypto.Identity(key, cert)


def save_identity(ident: crypto.Identity, path_prefix: str) -> None:
    """(↔ saveIdentity, tools_common.h:247-259)"""
    with open(path_prefix + ".pem", "wb") as f:
        f.write(ident.first.serialize())
    with open(path_prefix + ".crt", "wb") as f:
        f.write(ident.second.pack())


def setup_node(args) -> DhtRunner:
    """Build + start a runner from parsed args (↔ dhtnode main,
    tools/dhtnode.cpp:480-545)."""
    if args.verbose:
        logging.basicConfig(level=logging.DEBUG)
    # the card unless --cpu; resolved before any identity is generated
    # or socket bound, so a missing card fails first
    device = "cpu" if getattr(args, "cpu", False) else None
    resolve_device(device)
    ident = None
    if args.save_identity:
        ident = load_identity(args.save_identity)
    if ident is None and (args.identity or args.save_identity):
        ident = crypto.generate_identity("dhtnode", key_length=2048)
        if args.save_identity:
            save_identity(ident, args.save_identity)
    conf = RunnerConfig(dht_config=Config(network=args.network),
                        identity=ident)
    node = DhtRunner()
    node.run(args.port, conf, device=device)
    bs = parse_bootstrap(args.bootstrap)
    if bs:
        node.bootstrap(*bs)
    if args.proxyclient:
        node.enable_proxy(args.proxyclient)
    return node


def save_state(node: DhtRunner, path: str) -> None:
    """Persist good nodes + stored values to a msgpack file (↔ the
    reference's exportNodes/exportValues persistence, SURVEY.md §5
    checkpoint/resume; dhtnode identity/state save in tools_common.h)."""
    from ..utils import pack_msg
    state = {"nodes": node.export_nodes(), "values": node.export_values()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pack_msg(state))
    os.replace(tmp, path)


def load_state(node: DhtRunner, path: str) -> Tuple[int, int]:
    """Re-insert persisted nodes (bootstrap without ping, insertNode
    semantics dht.h:109-119) and values (clamped creation dates).
    Returns (n_nodes, n_keys)."""
    from ..sockaddr import SockAddr as _SA
    from ..utils import unpack_msg
    with open(path, "rb") as f:
        state = unpack_msg(f.read())
    inserted = 0
    for n in state.get("nodes", []):
        try:
            # after a msgpack round-trip addr can only be compact bytes;
            # anything else is corrupt and would fail asynchronously on
            # the DHT thread, so skip it here
            if not isinstance(n["addr"], (bytes, bytearray)):
                continue
            node.bootstrap_node(InfoHash(n["id"]),
                                _SA.from_compact(n["addr"]))
            inserted += 1
        except Exception:
            continue
    values = state.get("values", [])
    node.import_values(values)
    return inserted, len(values)


def print_node_info(node: DhtRunner) -> None:
    """(↔ print_node_info, tools_common.h:97-107)"""
    print("OpenDHT-TPU node %s" % node.get_node_id())
    if node.get_id():
        print("Public key ID %s" % node.get_id())
    print("Bound to port %d" % node.get_bound_port())


def print_node_stats(node: DhtRunner) -> None:
    import socket
    for name, af in (("IPv4", socket.AF_INET), ("IPv6", socket.AF_INET6)):
        try:
            st = node.get_node_stats(af)
        except Exception:
            continue
        print("%s stats: %s" % (name, st.to_dict()))
