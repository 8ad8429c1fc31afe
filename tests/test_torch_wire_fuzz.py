"""The port's network engine under hostile input against the JAX
package's, on the CPU, tolerance 0.

Every case of tests/test_wire_fuzz.py (truncated, bit-flipped and
type-confused packets, hostile fragment sequences, a malformed flood
against the rate limit, tid collisions, unknown keys, hostile trace
blobs, a garbage corpus) runs on both packages, in the manner of
tests/test_torch_storage.py: the JAX file executed as written, then
with its imports read as the port's.  The cases pack their packets
with the ``msgpack`` wheel in both runs, so both engines take the same
bytes; each run starts from the same ``random`` state and ``os.urandom``
stream.  Both runs must pass the case's assertions and make the same
calls into the engine with the same results: every function of
``net/engine.py`` and ``net/parsed_message.py`` that returns, in order,
and what it returned.
"""

from __future__ import annotations

import os
import random

import pytest

from test_torch_storage import case_names, jax_case_namespace, traced_returns

FNAME = "test_wire_fuzz.py"
WIRE_FILES = ("net/engine.py", "net/parsed_message.py")
CASES = case_names(FNAME)


def _seeded(m, seed: int) -> None:
    """The same ``random`` state and one ``os.urandom`` stream (which
    ``secrets`` draws through ``random._urandom``) for each run."""
    random.seed(seed)
    rng = random.Random(seed ^ 0x5EED)

    def urandom(n):
        return bytes(rng.getrandbits(8) for _ in range(n))
    m.setattr(os, "urandom", urandom)
    m.setattr(random, "_urandom", urandom)


def test_every_case_is_twinned():
    assert len(CASES) == 11


@pytest.mark.parametrize("name", CASES)
def test_wire_fuzz_case_twin(name, monkeypatch):
    recs = {}
    for pkg in ("jax", "port"):
        case = jax_case_namespace(FNAME, pkg)[name]
        with monkeypatch.context() as m:
            _seeded(m, 13)
            recs[pkg] = traced_returns(case, pkg, WIRE_FILES)
    assert recs["jax"], "the case reached no traced function"
    assert len(recs["port"]) == len(recs["jax"])
    assert recs["port"] == recs["jax"]
