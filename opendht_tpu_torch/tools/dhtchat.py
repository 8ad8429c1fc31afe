"""dhtchat: minimal IM over the DHT (↔ reference tools/dhtchat.cpp).

Joins a chat room (any string, hashed to a key), listens for signed
``ImMessage`` values on it, and putSigned's what you type.  Usage::

    python -m opendht_tpu_torch.tools.dhtchat [--cpu] -b host:port <room>

The port's copy of the JAX package's ``tools/dhtchat.py``; its node runs
on the CUDA card unless ``--cpu`` is given.  Chat signs its messages, so
it needs the ``cryptography`` wheel.
"""

from __future__ import annotations

import random
import sys
import time

from ..infohash import InfoHash
from ..core.default_types import IM_MESSAGE_TYPE, ImMessage
from .common import make_arg_parser, print_node_info, setup_node


def main(argv=None) -> int:
    p = make_arg_parser("OpenDHT-TPU chat")
    p.add_argument("room", help="chat room name")
    args = p.parse_args(argv)
    if not args.identity and not args.save_identity:
        args.identity = True        # chat requires a signing identity
    node = setup_node(args)
    print_node_info(node)
    room = InfoHash.get("room:" + args.room)
    my_id = node.get_id()
    start = time.time()

    def on_msg(values, expired) -> bool:
        # (dhtchat.cpp:55-77): show only fresh messages from others
        for v in values:
            if expired or v.type != IM_MESSAGE_TYPE.id:
                continue
            try:
                m = ImMessage.from_value(v)
            except Exception:
                continue
            if m.from_id == my_id or m.date < start * 1000 - 60_000:
                continue
            who = str(m.from_id)[:8] if m.from_id else "???"
            print("\r%s at %s: %s\n> " % (who, time.strftime(
                "%H:%M:%S", time.localtime(m.date / 1000)), m.msg),
                end="", flush=True)
        return True

    tok = node.listen(room, on_msg, ImMessage.get_filter())
    try:
        # runner.listen returns a Future resolving to the runner token;
        # 0 = shed at ingest admission — warn instead of
        # silently joining a room that will never deliver messages
        if hasattr(tok, "result") and not tok.result(10.0):
            print("warning: listen shed by ingest backpressure — "
                  "incoming messages will not be delivered")
    except Exception:
        pass
    print("Joined room %s as %s (empty line to quit)" % (args.room, my_id))
    try:
        while True:
            line = input("> ")
            if not line:
                break
            msg = ImMessage(random.getrandbits(64), line,
                            int(time.time() * 1000))
            node.put_signed(room, msg.to_value(),
                            lambda ok, ns: ok or print("(send failed)"))
    except (EOFError, KeyboardInterrupt):
        print()
    finally:
        node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
