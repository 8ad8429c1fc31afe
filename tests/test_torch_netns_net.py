"""The port's network-namespace tier (``testing/netns_net.py``) against
the JAX package's, on the CPU.

Both cases of tests/test_netns_net.py on both packages (the JAX file
executed as written, then with its imports read as the port's, the
port's default device read as the CPU, so its namespaced clusters are
port children on the host): both pass the case's assertions, a put in
one namespace read from the other with the seed up and again with it
gone, and make the same calls into the tier.  The file keeps the JAX
file's marks: slow, and skipped where namespaces cannot be made.
"""

from __future__ import annotations

import pytest
import torch

from opendht_tpu_torch.testing.netns_net import netns_available
from test_torch_cluster_tools import run_case_twins

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not netns_available(),
                       reason="netns/veth not available on this kernel"),
]

NETNS_FILES = ("testing/netns_net.py",)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", [
    "test_put_get_across_real_kernel_namespaces",
    "test_netem_probe_is_recorded"])
def test_netns_case_twin(name, monkeypatch):
    jax_rec, port_rec = run_case_twins("test_netns_net.py", name,
                                       monkeypatch, files=NETNS_FILES)
    assert jax_rec["calls"], "the case reached no traced function"
    assert port_rec["calls"] == jax_rec["calls"]
