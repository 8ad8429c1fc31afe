"""The wall-clock soak tier on the port: tests/test_soak.py's three cases
over the port's ``DhtRunner`` and ``Dht`` on the CPU.

Each case is the JAX file's own function, executed with its imports read
as the port's (in the manner of tests/test_torch_storage.py) and the
port's ``device=None`` read as the CPU (:func:`cpu_by_default`), so the
assertions are the JAX file's, unchanged:

- ``test_scheduler_heap_o1_under_permanent_puts``: 10,000 stored keys
  cost calendar bins, not heap entries, across three republish horizons;
- ``test_soak_cluster_resources``: a real-UDP cluster of runners under
  puts, gets, standing listeners and node churn for
  ``OPENDHT_TPU_SOAK_SECS`` wall seconds (default 60), then bounded RSS
  growth, scheduler heaps bounded per put, and drained reassembly
  buffers and listener records;
- ``test_soak_burst_ingest``: a burst of ~10x the steady rate through
  the wave builder drains its queue, keeps every op's queue wait within
  the deadline plus one wave, coalesces, and bounds RSS.

Each prints its resource line (``-s`` shows it).  Slow-marked, as the
JAX file is.  ``chip_smoke.py --phases soak`` runs the cluster on the
card, with a bound on the card's allocated bytes besides.
"""

from __future__ import annotations

import pytest

from test_torch_cluster_tools import cpu_by_default
from test_torch_storage import case_names, jax_case_namespace

pytestmark = pytest.mark.slow

CASES = case_names("test_soak.py")


def test_every_soak_case_is_twinned():
    assert CASES == ["test_scheduler_heap_o1_under_permanent_puts",
                     "test_soak_cluster_resources",
                     "test_soak_burst_ingest"]


@pytest.mark.parametrize("name", CASES)
def test_soak_case_on_the_port(name, monkeypatch):
    ns = jax_case_namespace("test_soak.py", "port")
    assert ns["DhtRunner"].__module__ == "opendht_tpu_torch.runtime.runner"
    cpu_by_default(monkeypatch)
    ns[name]()
