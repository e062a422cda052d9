"""256-bit modular field arithmetic, vectorized over batches.

Layout: a field element batch is a uint32 array of shape ``(..., 8)`` —
little-endian 32-bit limbs (limb 0 = least significant). All operations are
batch-uniform and branch-free so they vectorize over the batch and fuse
in XLA.

This re-implements (not a translation) the capability of the
reference's fixed-width bignum layer: secp256k1/Int.h, secp256k1/IntMod.cpp
(ModMulK1/ModSquareK1/ModInv/ModSqrt) and secp256k1/IntGroup.cpp (batched
Montgomery-trick inversion).
"""

from .fe import (  # noqa: F401
    P_INT,
    N_INT,
    LIMBS,
    from_int,
    to_int,
    from_ints,
    to_ints,
    add_mod_p,
    sub_mod_p,
    mul_mod_p,
    sqr_mod_p,
    neg_mod_p,
    inv_mod_p,
    sqrt_mod_p,
    batch_inv_mod_p,
    is_zero,
    eq,
    normalize_mod_p,
)
