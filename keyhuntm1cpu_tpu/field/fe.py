"""Vectorized 256-bit arithmetic mod the secp256k1 field prime p.

Design:

- Canonical storage: ``(..., 8)`` uint32, little-endian limbs, value < p.
- Multiplication runs in a 16-bit "split" domain: each operand becomes 16
  half-limbs of 16 bits held in uint32 lanes, so every partial product
  ``a16[i] * b16[j] < 2^32`` is exact in a uint32 lane — XLA has no
  32x32->64 multiply on uint32 without 64-bit mode. Column sums stay
  far below 2^32 (<= 32 terms of < 2^16 after hi/lo splitting), so a single
  carry-propagation pass at the end is exact.
- Reduction uses 2^256 ≡ 2^32 + 0x3D1 (mod p): two folds plus a
  micro-fold of the final carry, then one conditional subtract — the same
  algebraic identity as the reference's ModMulK1 fold
  (reference secp256k1/IntMod.cpp:855-915) expressed over 16-bit columns.
- Inversion: Fermat powering a^(p-2) as a fixed 256-step branch-free
  square-and-multiply ladder (compile-time exponent bits). Batched callers
  should use :func:`batch_inv_mod_p` — a *chunked Montgomery trick*
  (reference secp256k1/IntGroup.cpp:36-57 re-shaped for SIMD): the batch is
  reshaped to (L, B/L) chains; prefix products run sequentially over L but
  vectorized over B/L lanes; ONE batched powering inverts the B/L chain
  totals; back-substitution recovers every inverse. Amortized cost ≈ 3
  modmuls/element with full lane occupancy.

Everything here is jit-safe: static shapes, no data-dependent control flow.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import device

LIMBS = 8  # 8 x 32-bit limbs
HALF_LIMBS = 16  # 16 x 16-bit half-limbs (multiplication domain)

# Graph-shape strategy: "unroll" emits pure elementwise chains that XLA
# fuses into a single pass over the batch (bigger graphs); "scan" wraps
# serial chains in lax.scan (tiny graphs, fast compiles — right for the
# CPU, where unrolled graphs take minutes to compile). Both compute
# identical results. "auto" unrolls on the GPU (PERF.md, fe unroll vs
# scan); KEYHUNT_FE_UNROLL overrides.
UNROLL = os.environ.get("KEYHUNT_FE_UNROLL", "auto")


def _use_unroll() -> bool:
    if UNROLL == "auto":
        return device.on_gpu()
    return UNROLL not in ("0", "false", "scan")

P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# p = 2^256 - 2^32 - 0x3D1  =>  2^256 ≡ 2^32 + 0x3D1 (mod p)
FOLD_C = 0x3D1

_U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


# ---------------------------------------------------------------------------
# Host-side conversions
# ---------------------------------------------------------------------------


def int_to_limbs(v: int) -> np.ndarray:
    """Python int -> (8,) uint32 little-endian limbs (host)."""
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(LIMBS)], dtype=np.uint32)


def limbs_to_int(a) -> int:
    """(8,) limbs -> python int (host)."""
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(a[i]) << (32 * i) for i in range(LIMBS))


def from_int(v: int) -> jnp.ndarray:
    return jnp.asarray(int_to_limbs(v))


def to_int(a) -> int:
    return limbs_to_int(np.asarray(a))


def from_ints(vs: Sequence[int]) -> jnp.ndarray:
    """List of python ints -> (B, 8) uint32."""
    return jnp.asarray(np.stack([int_to_limbs(v) for v in vs]))


def to_ints(a) -> List[int]:
    """(B, 8) -> list of python ints (host)."""
    arr = np.asarray(a, dtype=np.uint64)
    out = []
    for row in arr.reshape(-1, LIMBS):
        out.append(sum(int(row[i]) << (32 * i) for i in range(LIMBS)))
    return out


_P_LIMBS = int_to_limbs(P_INT)


def p_limbs() -> jnp.ndarray:
    return jnp.asarray(_P_LIMBS)


# ---------------------------------------------------------------------------
# Add / sub with explicit carry chains (8 unrolled vector steps)
# ---------------------------------------------------------------------------


def _add_raw(a: jnp.ndarray, b: jnp.ndarray):
    """(a + b) over 8 limbs -> (sum_limbs, carry_out in {0,1}).

    Serial carry chain: unrolled (pure elementwise, fuses into one batch
    pass) on accelerators; lax.scan (tiny graph) on the CPU test mesh.
    """
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    a = jnp.broadcast_to(a, shape)
    b = jnp.broadcast_to(b, shape)
    if _use_unroll():
        out = []
        carry = jnp.zeros(shape[:-1], dtype=_U32)
        for i in range(LIMBS):
            ai = a[..., i]
            t = ai + carry
            c1 = (t < carry).astype(_U32)
            s = t + b[..., i]
            c2 = (s < t).astype(_U32)
            out.append(s)
            carry = c1 | c2
        return jnp.stack(out, axis=-1), carry
    ab = jnp.stack([jnp.moveaxis(a, -1, 0), jnp.moveaxis(b, -1, 0)], axis=1)

    def body(carry, ab_i):
        ai, bi = ab_i[0], ab_i[1]
        t = ai + carry
        c1 = (t < carry).astype(_U32)
        s = t + bi
        c2 = (s < t).astype(_U32)
        return c1 | c2, s

    carry, out = jax.lax.scan(body, jnp.zeros(shape[:-1], dtype=_U32), ab)
    return jnp.moveaxis(out, 0, -1), carry


def _sub_raw(a: jnp.ndarray, b: jnp.ndarray):
    """(a - b) over 8 limbs -> (diff_limbs, borrow_out in {0,1})."""
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    a = jnp.broadcast_to(a, shape)
    b = jnp.broadcast_to(b, shape)
    if _use_unroll():
        out = []
        borrow = jnp.zeros(shape[:-1], dtype=_U32)
        for i in range(LIMBS):
            ai = a[..., i]
            bi = b[..., i]
            t = ai - bi
            b1 = (ai < bi).astype(_U32)
            s = t - borrow
            b2 = (t < borrow).astype(_U32)
            out.append(s)
            borrow = b1 | b2
        return jnp.stack(out, axis=-1), borrow
    ab = jnp.stack([jnp.moveaxis(a, -1, 0), jnp.moveaxis(b, -1, 0)], axis=1)

    def body(borrow, ab_i):
        ai, bi = ab_i[0], ab_i[1]
        t = ai - bi
        b1 = (ai < bi).astype(_U32)
        s = t - borrow
        b2 = (t < borrow).astype(_U32)
        return b1 | b2, s

    borrow, out = jax.lax.scan(body, jnp.zeros(shape[:-1], dtype=_U32), ab)
    return jnp.moveaxis(out, 0, -1), borrow


def geq_p(a: jnp.ndarray) -> jnp.ndarray:
    """a >= p, elementwise over the batch. Returns bool (...,)."""
    _, borrow = _sub_raw(a, jnp.broadcast_to(p_limbs(), a.shape))
    return borrow == 0


def normalize_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    """Conditionally subtract p once (inputs must be < 2p)."""
    pb = jnp.broadcast_to(p_limbs(), a.shape)
    d, borrow = _sub_raw(a, pb)
    take = (borrow == 0)[..., None]
    return jnp.where(take, d, a)


def add_mod_p(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a + b) mod p for canonical inputs (< p)."""
    s, carry = _add_raw(a, b)
    pb = jnp.broadcast_to(p_limbs(), s.shape)
    d, borrow = _sub_raw(s, pb)
    # subtract p iff the raw sum overflowed 2^256 or is >= p
    take = ((carry == 1) | (borrow == 0))[..., None]
    return jnp.where(take, d, s)


def sub_mod_p(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a - b) mod p for canonical inputs."""
    d, borrow = _sub_raw(a, b)
    pb = jnp.broadcast_to(p_limbs(), d.shape)
    s, _ = _add_raw(d, pb)
    take = (borrow == 1)[..., None]
    return jnp.where(take, s, d)


def neg_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    """(-a) mod p; maps 0 -> 0."""
    pb = jnp.broadcast_to(p_limbs(), a.shape)
    d, _ = _sub_raw(pb, a)
    return jnp.where(is_zero(a)[..., None], a, d)


def is_zero(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == 0, axis=-1)


def eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


# ---------------------------------------------------------------------------
# Multiplication: 16-bit split domain
# ---------------------------------------------------------------------------


def _to16(a: jnp.ndarray) -> jnp.ndarray:
    """(..., 8) u32 -> (..., 16) u32 of 16-bit half-limbs (LE)."""
    lo = a & _MASK16
    hi = a >> jnp.uint32(16)
    return jnp.stack([lo, hi], axis=-1).reshape(*a.shape[:-1], HALF_LIMBS)


def _from16(a16: jnp.ndarray) -> jnp.ndarray:
    """(..., 16) carried 16-bit half-limbs -> (..., 8) u32."""
    pairs = a16.reshape(*a16.shape[:-1], LIMBS, 2)
    return pairs[..., 0] | (pairs[..., 1] << jnp.uint32(16))


def _carry16(cols: jnp.ndarray, n_out: int):
    """Propagate carries over 16-bit columns (last axis). cols < 2^31 each.

    Returns ((..., n_out) carried 16-bit limbs, final carry (...,)).
    lax.scan over the column axis: serial by definition, but each step is
    a full-batch vector op and the traced graph stays one column deep.
    """
    ncols = cols.shape[-1]
    if ncols < n_out:
        cols = _pad_last(cols, 0, n_out - ncols)
    elif ncols > n_out:
        cols = cols[..., :n_out]
    cols_t = jnp.moveaxis(cols, -1, 0)  # (n_out, ...)

    def body(carry, col):
        c = col + carry
        return c >> jnp.uint32(16), c & _MASK16

    carry, out = jax.lax.scan(body, jnp.zeros(cols.shape[:-1], dtype=_U32), cols_t)
    return jnp.moveaxis(out, 0, -1), carry


def _pad_last(a: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    cfg = [(0, 0)] * (a.ndim - 1) + [(left, right)]
    return jnp.pad(a, cfg)


def _mul_columns(a16: jnp.ndarray, b16: jnp.ndarray) -> jnp.ndarray:
    """Schoolbook 16x16 half-limb product as (..., 33) uncarried columns.

    Every partial product is < 2^32 (operands < 2^16) so it is exact in a
    uint32 lane; its hi/lo halves accumulate into neighbouring columns and
    every column sum stays <= 32 * (2^16 - 1) < 2^21 — one carry-free pass.

    Unroll path (accelerators): 256 scalarized lane multiplies — pure
    elementwise over the batch, which XLA fuses into a single pass with NO
    materialized intermediate (the tensorized alternative materializes a
    (B, 16, 16) product tensor = 1 GB at B = 2^20 and goes memory-bound).
    Scan path (CPU tests): broadcast outer product + anti-diagonal sums —
    ~30 ops for fast compiles.
    """
    if _use_unroll():
        shape = jnp.broadcast_shapes(a16.shape[:-1], b16.shape[:-1])
        al = [a16[..., i] for i in range(HALF_LIMBS)]
        bl = [b16[..., j] for j in range(HALF_LIMBS)]
        zero = jnp.zeros(shape, dtype=_U32)
        cols = [zero for _ in range(2 * HALF_LIMBS + 1)]
        for i in range(HALF_LIMBS):
            for j in range(HALF_LIMBS):
                prod = al[i] * bl[j]
                cols[i + j] = cols[i + j] + (prod & _MASK16)
                cols[i + j + 1] = cols[i + j + 1] + (prod >> jnp.uint32(16))
        return jnp.stack(cols, axis=-1)
    prod = a16[..., :, None] * b16[..., None, :]  # (..., 16, 16)
    plo = prod & _MASK16
    phi = prod >> jnp.uint32(16)
    rows = []
    for i in range(HALF_LIMBS):
        # lo of row i lands in columns i..i+15; hi in columns i+1..i+16
        rows.append(
            _pad_last(plo[..., i, :], i, HALF_LIMBS + 1 - i)
            + _pad_last(phi[..., i, :], i + 1, HALF_LIMBS - i)
        )
    return jnp.sum(jnp.stack(rows, axis=-2), axis=-2)  # (..., 33)


def _fold_uncarried(cols: jnp.ndarray, n_out: int) -> jnp.ndarray:
    """cols -> low + high * (2^32 + 0x3D1), entirely on UNCARRIED 16-bit
    columns (no serial carry pass between folds — the column bounds stay
    far below 2^32, see _reduce512's bound comments)."""
    low = cols[..., :HALF_LIMBS]
    high = cols[..., HALF_LIMBS:]
    hp = high * jnp.uint32(FOLD_C)
    hlo = hp & _MASK16
    hhi = hp >> jnp.uint32(16)
    nh = high.shape[-1]
    return (
        _pad_last(low, 0, n_out - HALF_LIMBS)
        + _pad_last(hlo, 0, n_out - nh)
        + _pad_last(hhi, 1, n_out - nh - 1)
        + _pad_last(high, 2, n_out - nh - 2)  # high * 2^32 = shift 2 limbs
    )


def _reduce512(cols: jnp.ndarray) -> jnp.ndarray:
    """Reduce (..., 33) uncarried 16-bit columns (< 2^512) mod p -> (..., 8).

    Fold H*2^256 into L as H*(2^32 + 0x3D1) twice (the reference's ModMulK1
    identity, secp256k1/IntMod.cpp:855-915) — but on uncarried columns, so
    the only serial carry chains are two 8-step 32-bit passes at the end.

    Bounds: _mul_columns emits 33 columns < 2^21. After fold 1 (high = 17
    columns < 2^21; high*0x3D1 < 2^31): 19 columns < 2^22. After fold 2
    (high = 3 columns < 2^22; product < 2^32): 16 columns < 2^23.
    """
    cols = _fold_uncarried(cols, HALF_LIMBS + 3)  # (..., 19) < 2^22
    cols = _fold_uncarried(cols, HALF_LIMBS)  # (..., 16) < 2^23

    # pairwise-combine 16-bit columns into 8 uint32 limbs:
    #   value = sum_j (even_j + odd_j * 2^16) * 2^32j
    #         = sum_j s0_j * 2^32j + sum_j c_j * 2^32(j+1)
    even = cols[..., 0::2]
    odd = cols[..., 1::2]
    odd_lo = (odd & _MASK16) << jnp.uint32(16)
    s0 = even + odd_lo
    c0 = (s0 < even).astype(_U32)
    c = (odd >> jnp.uint32(16)) + c0  # < 2^8, belongs at limb j+1
    c_shift = jnp.concatenate(
        [jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1
    )
    r1, carry1 = _add_raw(s0, c_shift)
    top = c[..., 7] + carry1  # value overflowing 2^256, < 2^9

    # micro-fold: add top * (2^32 + 0x3D1)
    f = jnp.zeros_like(r1)
    f = f.at[..., 0].set(top * jnp.uint32(FOLD_C))
    f = f.at[..., 1].set(top)
    r2, carry2 = _add_raw(r1, f)
    # carry2 requires r1 > 2^256 - 2^42: fold once more (conditionally)
    f1 = jnp.zeros_like(r2).at[..., 0].set(jnp.uint32(FOLD_C)).at[..., 1].set(jnp.uint32(1))
    r3, _ = _add_raw(r2, f1)
    r = select(carry2 == 1, r3, r2)
    # the value is now < 2^256; at most one conditional subtract to canonical
    return normalize_mod_p(r)


def mul_mod_p(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a * b) mod p, vectorized over any batch shape."""
    return _reduce512(_mul_columns(_to16(a), _to16(b)))


def sqr_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    """(a * a) mod p (XLA CSEs the duplicated half-limb loads)."""
    a16 = _to16(a)
    return _reduce512(_mul_columns(a16, a16))


# ---------------------------------------------------------------------------
# Powering / inversion / sqrt
# ---------------------------------------------------------------------------


def pow_mod_p(a: jnp.ndarray, exponent: int) -> jnp.ndarray:
    """a^exponent mod p with a compile-time python-int exponent.

    Branch-free fixed ladder: one square per exponent bit, one multiply per
    set bit. Used for Fermat inversion and Tonelli (p ≡ 3 mod 4) sqrt —
    replaces the reference's data-dependent DRS62 ModInv
    (secp256k1/IntMod.cpp:112-515), which XLA could not pipeline.
    """
    nbits = exponent.bit_length()
    # MSB-first bit vector, baked in as a compile-time constant
    bits = jnp.asarray(
        np.array([(exponent >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=np.uint32)
    )

    def body(result, bit):
        result = sqr_mod_p(result)
        with_mul = mul_mod_p(result, a)
        result = select(jnp.broadcast_to(bit == 1, result.shape[:-1]), with_mul, result)
        return result, None

    # start from 1 and scan all bits: the leading bit multiplies 1*1*a = a
    one = jnp.zeros_like(a).at[..., 0].set(1)
    result, _ = jax.lax.scan(body, one, bits)
    return result


def inv_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    """a^(p-2) mod p (maps 0 -> 0)."""
    return pow_mod_p(a, P_INT - 2)


def sqrt_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    """a^((p+1)/4); valid square root only when a is a QR (caller checks
    by squaring). Reference capability: secp256k1/IntMod.cpp:578 ModSqrt."""
    return pow_mod_p(a, (P_INT + 1) // 4)


@partial(jax.jit, static_argnames=("chain_len",))
def batch_inv_mod_p(a: jnp.ndarray, chain_len: int = 32) -> jnp.ndarray:
    """Batched modular inverse of a (B, 8) array — chunked Montgomery trick.

    Reshapes to (L, B/L) chains: forward prefix products run L sequential
    steps but each step is a full-width vector op; ONE vectorized Fermat
    powering inverts the B/L chain totals; a backward pass peels per-element
    inverses. Amortized ≈ 3 modmuls/element (vs. a full powering's ~380).

    Zero inputs propagate zeros into their whole chain's outputs in
    principle; callers must mask zeros to 1 beforehand (the group-walk does
    this and flags the lanes — see curve/walk.py).
    """
    orig_shape = a.shape
    flat = a.reshape(-1, LIMBS)
    b = flat.shape[0]
    if b % chain_len != 0:
        # pad with ones to a chain multiple (static shapes only)
        pad = chain_len - b % chain_len
        ones = jnp.zeros((pad, LIMBS), dtype=_U32).at[:, 0].set(1)
        flat = jnp.concatenate([flat, ones], axis=0)
    chains = flat.reshape(chain_len, -1, LIMBS)  # (L, C, 8)

    # forward prefix products along the chain axis (scan: L vector steps)
    def fwd(acc, x):
        nxt = mul_mod_p(acc, x)
        return nxt, nxt

    one = jnp.zeros_like(chains[0]).at[..., 0].set(1)
    total, prefixes = jax.lax.scan(fwd, one, chains)  # prefixes[i] = a0..ai

    # one batched inversion of the chain totals (width C)
    running = inv_mod_p(total)  # (C, 8)

    # backward substitution: inv(a_i) = running_i * prefix[i-1]
    prev_prefixes = jnp.concatenate([one[None], prefixes[:-1]], axis=0)

    def bwd(acc, xs):
        chain_el, prev_pref = xs
        inv_el = mul_mod_p(acc, prev_pref)
        acc = mul_mod_p(acc, chain_el)
        return acc, inv_el

    _, invs = jax.lax.scan(bwd, running, (chains, prev_prefixes), reverse=True)

    out = invs.reshape(-1, LIMBS)[:b]
    return out.reshape(orig_shape)


# ---------------------------------------------------------------------------
# Small utilities used by curve / engines
# ---------------------------------------------------------------------------


def select(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """where(mask, a, b) with mask shaped (...,) over (..., 8) operands."""
    return jnp.where(mask[..., None], a, b)


def double_mod_p(a: jnp.ndarray) -> jnp.ndarray:
    return add_mod_p(a, a)
