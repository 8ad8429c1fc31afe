"""Tensor ops of the port: id math, the exact full-scan top-k, the
sorted-window lookup, and the two CUDA select kernels with their plain
torch versions.  The id functions of :mod:`.ids` are exported here, as
the JAX package's ``ops`` exports its own; they work on int32 key
tensors (``to_keys`` / ``as_keys`` / ``from_keys`` convert)."""

from .ids import (  # noqa: F401
    N_LIMBS,
    ID_BITS,
    ids_from_bytes,
    ids_to_bytes,
    ids_from_hashes,
    xor_ids,
    lex_lt,
    lex_eq,
    lex_cmp,
    xor_cmp,
    common_bits,
    lowbit,
    get_bit,
    set_bit,
    clz32,
    ctz32,
    popcount32,
    random_ids,
    to_keys,
    as_keys,
    from_keys,
)
