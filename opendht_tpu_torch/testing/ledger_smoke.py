"""End-to-end kernel-cost-ledger smoke.

Boots one node + its REST proxy, computes a subset of the kernel cost
ledger (opendht_tpu_torch/profiling.py — the subset keeps the CI step in
seconds; ``python -m opendht_tpu_torch.perf_gate`` computes the FULL
set), then asserts the ledger actually reaches both export surfaces the
spine serves:

1. ``DhtRunner.get_metrics()`` carries ``dht_kernel_*`` gauges with
   the computed cost-model values;
2. the proxy's ``GET /stats`` Prometheus exposition carries the same
   series and still parses line-by-line against the v0.0.4 grammar
   (reusing telemetry_smoke's validator);
3. the two exports agree on the values (one registry, two views).

Run directly::

    python -m opendht_tpu_torch.testing.ledger_smoke [--cpu]

Its nodes run on the CUDA card unless ``--cpu`` is given; without a card
(and without ``--cpu``) it raises before any socket is bound.

The port's copy of the JAX package's ``testing/ledger_smoke.py``,
behaviour unchanged but for the nodes' device and the names of the
port ledger's fields (:func:`exported`).
"""

from __future__ import annotations

import sys
import urllib.request

from .._device import resolve_device
from ..runtime.runner import DhtRunner
from .telemetry_smoke import parse_exposition

#: computed in the smoke — small, fast, and covering one kernel from
#: each family (window lookup / gather / maintenance)
SMOKE_KERNELS = ["expanded_topk", "fused_gather_planar",
                 "maintenance_sweep"]


def exported(entry: dict) -> dict:
    """The ``dht_kernel_*`` values the ledger exports for ``entry``, by
    the JAX entry's field names (``KernelLedger.export_to_registry``:
    ``flops`` is the operations model, ``bytes_accessed`` the byte
    bound, ``hbm_bytes`` arguments + outputs + the measured
    temporaries)."""
    return {"flops": entry["flops_model"],
            "bytes_accessed": entry["bytes_bound"],
            "hbm_bytes": (entry["argument_bytes"] + entry["output_bytes"]
                          + (entry.get("peak_temp_bytes") or 0))}


def main(argv=None) -> int:
    from .. import profiling
    from ..proxy import DhtProxyServer

    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    resolve_device(device)        # no card and no --cpu: raise here
    node = DhtRunner()
    proxy = None
    try:
        node.run(0, device=device)
        led = profiling.get_ledger()
        entries = led.compute(SMOKE_KERNELS, device=device)
        bad = {n: e["error"] for n, e in entries.items() if "error" in e}
        if bad:
            print("ledger_smoke: kernels failed to compute: %s" % bad,
                  file=sys.stderr)
            return 1
        led.export_to_registry()

        # surface 1: get_metrics JSON
        metrics = node.get_metrics()
        gauges = metrics.get("gauges", {})
        for name in SMOKE_KERNELS:
            key = 'dht_kernel_bytes_accessed{kernel="%s"}' % name
            if key not in gauges:
                print("ledger_smoke: %s missing from get_metrics()" % key,
                      file=sys.stderr)
                return 1
            if gauges[key] != exported(entries[name])["bytes_accessed"]:
                print("ledger_smoke: %s = %r disagrees with the ledger "
                      "entry %r" % (key, gauges[key],
                                    exported(entries[name])
                                    ["bytes_accessed"]),
                      file=sys.stderr)
                return 1

        # surface 2: the proxy's Prometheus exposition
        proxy = DhtProxyServer(node, 0)
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/stats" % proxy.port, timeout=10.0) as r:
            text = r.read().decode()
        series = parse_exposition(text)         # raises on grammar errors
        for name in SMOKE_KERNELS:
            for fam in ("dht_kernel_flops", "dht_kernel_bytes_accessed",
                        "dht_kernel_hbm_bytes"):
                key = '%s{kernel="%s"}' % (fam, name)
                if key not in series:
                    print("ledger_smoke: %s missing from GET /stats"
                          % key, file=sys.stderr)
                    return 1
                if series[key] != float(exported(entries[name])
                                        [fam.replace("dht_kernel_", "")]):
                    print("ledger_smoke: /stats %s disagrees with the "
                          "ledger" % key, file=sys.stderr)
                    return 1
        print("ledger_smoke ok: %d kernels exported, %d exposition "
              "series parsed" % (len(SMOKE_KERNELS), len(series)))
        return 0
    finally:
        if proxy is not None:
            try:
                proxy.stop()
            except Exception:
                pass
        node.join()


if __name__ == "__main__":
    sys.exit(main())
