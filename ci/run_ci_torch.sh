#!/bin/sh
# CI entry point for the PyTorch/CUDA port (opendht_tpu_torch/), on a
# host without a card: the port's end-to-end smokes, each in a fresh
# process with --cpu (the metrics registry and the tracer are
# process-wide), as ci/run_ci.sh runs the JAX package's, then the port's
# kernel cost gate.  On a machine with a card, `python3 chip_smoke.py
# --phases smokes` runs the same smokes on it.
set -e
cd "$(dirname "$0")/.."
# the port's tiny smoke shapes: two intra-op threads (all-core OpenMP
# pools spin against any other busy process on the host)
export OMP_NUM_THREADS=2
for smoke in telemetry_smoke ledger_smoke health_smoke history_smoke \
        waterfall_smoke peer_smoke keyspace_smoke cache_smoke \
        listener_smoke ingest_smoke pipeline_smoke pipeline_util_smoke \
        reshard_smoke chaos_smoke; do
    echo "== $smoke"
    python -m "opendht_tpu_torch.testing.$smoke" --cpu
done
# the kernel cost ledger against opendht_tpu_torch/perf_budgets.json
python -m opendht_tpu_torch.perf_gate
echo "port ci ok"
