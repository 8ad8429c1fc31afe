"""The port's id functions of ``opendht_tpu_torch.ops`` against the JAX
package's (tests/test_ids_ops.py's cases, twinned): ``lex_cmp``,
``lex_eq``, ``popcount32``, ``ctz32`` and ``xor_cmp`` on the same
numpy-seeded ids through both, at tolerance 0, edge limbs (0, 1,
0x80000000, 0xFFFFFFFF) and equal ids among them; ``xor_cmp`` also
against the JAX package's scalar ``InfoHash.xor_cmp``; ``random_ids``'
properties (its stream is torch's, not ``jax.random``'s); and the 18
names ``opendht_tpu.ops`` exports, all on the port's ``ops``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opendht_tpu.ops as JO
import opendht_tpu_torch.ops as TO
from opendht_tpu.infohash import InfoHash
from opendht_tpu.ops import ids as JK
from opendht_tpu_torch.ops import ids as TK

pytestmark = pytest.mark.quick  # sub-minute smoke tier: -m quick

#: the names ``opendht_tpu/ops/__init__.py`` exports
JAX_OPS_NAMES = ("N_LIMBS", "ID_BITS", "ids_from_bytes", "ids_to_bytes",
                 "ids_from_hashes", "xor_ids", "lex_lt", "lex_eq", "lex_cmp",
                 "xor_cmp", "common_bits", "lowbit", "get_bit", "set_bit",
                 "clz32", "ctz32", "popcount32", "random_ids")
EDGE_LIMBS = np.array([0, 1, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)


def _ids(n, seed):
    """Seeded uint32 ids [n, 5] with edge rows: all-edge-limb ids,
    edge limbs in random ids, and (through :func:`_pairs`) equal ids."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    u[:4] = EDGE_LIMBS[:, None]
    u[4:24] = EDGE_LIMBS[rng.integers(0, 4, size=(20, 5))]
    mask = rng.random((n, 5)) < 0.1
    u[mask] = EDGE_LIMBS[rng.integers(0, 4, size=int(mask.sum()))]
    return u


def _pairs(n, seed):
    a = _ids(n, seed)
    b = np.roll(a, 1, axis=0)
    b[::9] = a[::9]                           # equal ids
    b[1::9, :3] = a[1::9, :3]                 # long shared prefixes
    b[2::9] = a[2::9]
    b[2::9, 4] ^= np.uint32(1)                # one low bit apart
    return a, b


def _k(u):
    return TK.to_keys(u, "cpu")


def test_ops_exports_the_jax_names():
    for name in JAX_OPS_NAMES:
        assert name in vars(JO), name
        assert getattr(TO, name) is getattr(TK, name), name
    assert TO.N_LIMBS == JO.N_LIMBS and TO.ID_BITS == JO.ID_BITS
    for name in ("to_keys", "as_keys", "from_keys"):
        assert getattr(TO, name) is getattr(TK, name)


def test_lex_cmp_and_lex_eq_match_jax():
    """(tests/test_ids_ops.py::test_lex_ordering_matches_bytes)"""
    a, b = _pairs(300, 1)
    ja, jb, ka, kb = jnp.asarray(a), jnp.asarray(b), _k(a), _k(b)
    for x, y, kx, ky in ((ja, jb, ka, kb), (jb, ja, kb, ka)):
        got = TK.lex_cmp(kx, ky)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JK.lex_cmp(x, y)))
        eq = TK.lex_eq(kx, ky)
        assert eq.dtype == torch.bool
        np.testing.assert_array_equal(eq.numpy(), np.asarray(JK.lex_eq(x, y)))
        np.testing.assert_array_equal(TK.lex_lt(kx, ky).numpy(),
                                      np.asarray(JK.lex_lt(x, y)))
    cmp = TK.lex_cmp(ka, kb).numpy()
    assert set(cmp[::9]) == {0} and {-1, 1} <= set(cmp)
    # against the bytes: memcmp order of the ids
    raw_a, raw_b = TK.ids_to_bytes(a), TK.ids_to_bytes(b)
    want = [(x.tobytes() > y.tobytes()) - (x.tobytes() < y.tobytes())
            for x, y in zip(raw_a, raw_b)]
    np.testing.assert_array_equal(cmp, want)
    # broadcasting over batch dims, as the JAX functions do
    np.testing.assert_array_equal(
        TK.lex_cmp(ka[:, None], kb[None, :8]).numpy(),
        np.asarray(JK.lex_cmp(ja[:, None], jb[None, :8])))


def test_bit_kernels_match_jax():
    """(tests/test_ids_ops.py::test_bit_kernels, on more patterns)"""
    x = np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x00010000],
                 dtype=np.uint32)
    tx = torch.from_numpy(x.view(np.int32).copy())
    np.testing.assert_array_equal(TK.popcount32(tx).numpy(),
                                  [0, 1, 1, 2, 1, 32, 1])
    np.testing.assert_array_equal(TK.ctz32(tx).numpy(),
                                  [32, 0, 1, 0, 31, 0, 16])
    a, b = _pairs(200, 2)
    x = np.concatenate([(a ^ b).reshape(-1), a.reshape(-1), EDGE_LIMBS,
                        np.uint32(1) << np.arange(32, dtype=np.uint32),
                        ~(np.uint32(1) << np.arange(32, dtype=np.uint32))])
    tx = torch.from_numpy(x.view(np.int32).copy())
    for name in ("popcount32", "ctz32", "clz32"):
        got = getattr(TK, name)(tx)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(JK, name)(jnp.asarray(x))),
            err_msg=name)


def test_xor_cmp_matches_jax_and_the_scalar_oracle():
    """(tests/test_ids_ops.py::test_xor_cmp_parity_including_cpp_vectors)"""
    null_h = InfoHash()
    min_h = InfoHash("0000000000000000000000000000000000000010")
    max_h = InfoHash("0100000000000000000000000000000000000000")
    triples = [(min_h, null_h, max_h, -1), (min_h, max_h, null_h, 1),
               (min_h, min_h, max_h, -1), (min_h, max_h, min_h, 1),
               (null_h, min_h, max_h, -1), (null_h, max_h, min_h, 1),
               (max_h, null_h, min_h, -1), (max_h, min_h, null_h, 1)]
    s, a, b = (_k(TK.ids_from_hashes([t[i] for t in triples]))
               for i in range(3))
    np.testing.assert_array_equal(TK.xor_cmp(s, a, b).numpy(),
                                  [t[3] for t in triples])

    u = _ids(120, 3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, len(u), size=(500, 3))
    idx[::7, 2] = idx[::7, 1]                 # ties
    su, au, bu = u[idx[:, 0]], u[idx[:, 1]], u[idx[:, 2]]
    got = TK.xor_cmp(_k(su), _k(au), _k(bu))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JK.xor_cmp(jnp.asarray(su), jnp.asarray(au),
                                           jnp.asarray(bu))))
    hashes = [InfoHash(r.tobytes()) for r in TK.ids_to_bytes(u)]
    want = [hashes[i].xor_cmp(hashes[j], hashes[k]) for i, j, k in idx]
    np.testing.assert_array_equal(got.numpy(), want)
    # one self id against a batch, broadcast
    np.testing.assert_array_equal(
        TK.xor_cmp(_k(u[:1]), _k(au), _k(bu)).numpy(),
        np.asarray(JK.xor_cmp(jnp.asarray(u[:1]), jnp.asarray(au),
                              jnp.asarray(bu))))


def test_random_ids_properties():
    """(tests/test_ids_ops.py::test_random_ids_shape_dtype; the stream
    is torch's, so its properties are checked instead of its values)"""
    out = TK.random_ids(torch.Generator().manual_seed(0), 16, device="cpu")
    assert out.shape == (16, 5) and out.dtype == torch.int32
    assert out.device.type == "cpu"
    u = TK.from_keys(out)
    assert u.dtype == np.uint32 and u.shape == (16, 5)
    again = TK.random_ids(torch.Generator().manual_seed(0), 16, device="cpu")
    assert torch.equal(out, again)
    other = TK.random_ids(torch.Generator().manual_seed(1), 16, device="cpu")
    assert not torch.equal(out, other)
    # every bit position of a large draw is set in about half of the ids
    n = 20_000
    u = TK.from_keys(TK.random_ids(torch.Generator().manual_seed(7), n,
                                   device="cpu"))
    bits = (u[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    share = bits.mean(axis=0)                  # [5, 32]
    # 6 sigma of a fair coin's share over n draws
    assert np.abs(share - 0.5).max() < 6 * 0.5 / np.sqrt(n), share
    assert len({r.tobytes() for r in u}) == n


def test_random_ids_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError):
        TK.random_ids(torch.Generator().manual_seed(0), 4)
