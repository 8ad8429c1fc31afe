"""Time the port's msgpack decoder on real protocol packets.

The corpus is the wire goldens (``tests/goldens/*.bin``: every request,
reply and error the node sends, one packet per message).  Each round decodes
every packet once through ``_msgpack.unpackb``, the decoder under
``utils.unpack_msg``; the line printed is the best of ``--rounds`` rounds,
in microseconds per packet.  ``--against DIR`` times another checkout's
``opendht_tpu_torch/_msgpack.py`` in the same process, interleaved
(this tree, other, other, this tree, ...; repeatable), so two versions are compared
on one host under one load.  Host CPU only: no device is touched.

    python3 codec_timing.py [--rounds 200] [--against OTHER_CHECKOUT ...]
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def load_codec(root: str, name: str):
    """``opendht_tpu_torch/_msgpack.py`` of the checkout at ``root``, as
    a module of its own (it imports only the standard library)."""
    path = os.path.join(root, "opendht_tpu_torch", "_msgpack.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(codec) -> list:
    """One packet per message: a golden that holds several concatenated
    messages (a value sent in parts) is split into them."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "tests", "goldens",
                                              "*.bin"))):
        with open(path, "rb") as f:
            out += [codec.packb(o) for o in codec.unpack_stream(f.read())]
    return out


def one_round(unpackb, packets) -> float:
    t0 = time.perf_counter()
    for p in packets:
        unpackb(p)
    return (time.perf_counter() - t0) / len(packets) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout to time in the same process "
                         "(repeatable; named by its directory)")
    args = ap.parse_args(argv)
    codecs = {"this": load_codec(HERE, "_codec_this")}
    for i, root in enumerate(args.against):
        codecs[os.path.basename(os.path.normpath(root))] = \
            load_codec(root, f"_codec_other{i}")
    names = list(codecs)
    packets = corpus(codecs["this"])
    for name in names:                    # both decode every packet alike
        assert [codecs[name].unpackb(p) for p in packets] == \
            [codecs[names[0]].unpackb(p) for p in packets]
    best = {name: float("inf") for name in names}
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]     # ABBA
        for name in order:
            best[name] = min(best[name],
                             one_round(codecs[name].unpackb, packets))
    print(json.dumps({"packets": len(packets),
                      "bytes": sum(map(len, packets)),
                      "rounds": args.rounds,
                      "us_per_packet": {k: round(v, 3)
                                        for k, v in best.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
