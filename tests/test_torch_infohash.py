"""The port's ``InfoHash`` and ``PkId`` against the JAX package's, on the
CPU, tolerance 0.

Every case of tests/test_infohash.py (the reference's infohashtester.cpp
suite and its extras) runs twice in one process, as the JAX file is
written and with its imports read as the port's
(tests/test_torch_storage.py's ``jax_case_namespace``), each run after
the same seeded ``random`` and ``os.urandom`` streams (``get_random``
draws through ``secrets``).  Both runs pass the case's own assertions,
and every call the case makes into ``infohash.py`` returns the same
result, in the same order.
"""

from __future__ import annotations

import pytest

from test_torch_storage import (case_calls, case_names, jax_case_namespace,
                                seed_streams)

FNAME = "test_infohash.py"
CASES = case_names(FNAME)


def test_every_case_is_twinned():
    assert len(CASES) == 8


@pytest.mark.parametrize("name", CASES)
def test_infohash_case_twin(name, monkeypatch):
    recs = []
    for pkg in ("jax", "port"):
        case = jax_case_namespace(FNAME, pkg)[name]
        with monkeypatch.context() as m:
            seed_streams(m, 5)
            recs.append(case_calls(case, {}, pkg, FNAME, ("infohash.py",)))
    assert recs[0], "the case reached no traced function"
    assert recs[1] == recs[0]
