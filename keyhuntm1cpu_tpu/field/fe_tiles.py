"""Limb-split field arithmetic: the BSGS walk kernels' plain twin.

Representation: a field element batch is a sequence of 8 uint32 arrays
(little-endian limbs) of one common shape — a tuple of limb arrays, or
a stacked ``(8,) + shape`` array (``a[i]`` reads a limb either way).
All functions return tuples, and nothing here slices or stacks arrays,
so XLA fuses each limb's chain over whole arrays without layout copies.

The same functions also take numpy limb arrays: they then run as plain
numpy (loops in Python), which is the fast exact reference the kernels'
CPU tests compare against.

Same algebra as fe.py: 16-bit half-limb schoolbook products (every
partial product is exact in a uint32 lane), two uncarried folds of
2^256 ≡ 2^32 + 0x3D1 (reference ModMulK1 identity,
secp256k1/IntMod.cpp:855-915), one 8-step carry chain, conditional
subtract.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

P_INT = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
MASK16 = 0xFFFF
FOLD = 0x3D1

Limbs = Tuple[jnp.ndarray, ...]


def xp(a):
    """numpy for numpy limbs (the host reference), jax.numpy otherwise."""
    return np if isinstance(a, np.ndarray) else jnp


def fori(n: int, body, x):
    """lax.fori_loop, or a Python loop over numpy limbs."""
    if isinstance(x[0], np.ndarray):
        for i in range(n):
            x = body(i, x)
        return x
    return jax.lax.fori_loop(0, n, body, tuple(x))


def limbs(a) -> Limbs:
    """(8,) + shape array or limb sequence -> tuple of 8 limb arrays."""
    return tuple(a[i] for i in range(8))


def _u32(b):
    return b.astype(np.uint32)


def _zeros(x):
    return xp(x).zeros_like(x)


def _where(mask, a, b):
    return xp(a).where(mask, a, b)


def mul(a: Sequence, b: Sequence) -> Limbs:
    """(a * b) mod p."""
    al, bl = [], []
    for i in range(8):
        al += [a[i] & MASK16, a[i] >> 16]
        bl += [b[i] & MASK16, b[i] >> 16]
    zero = _zeros(al[0])
    cols = [zero] * 33
    for i in range(16):
        for j in range(16):
            prod = al[i] * bl[j]
            cols[i + j] = cols[i + j] + (prod & MASK16)
            cols[i + j + 1] = cols[i + j + 1] + (prod >> 16)
    return _reduce(cols)


def sqr(a: Sequence) -> Limbs:
    """(a * a) mod p — off-diagonal products computed once and doubled
    (~45% fewer lane multiplies than mul)."""
    al = []
    for i in range(8):
        al += [a[i] & MASK16, a[i] >> 16]
    zero = _zeros(al[0])
    cols = [zero] * 33
    for i in range(16):
        sq = al[i] * al[i]
        cols[2 * i] = cols[2 * i] + (sq & MASK16)
        cols[2 * i + 1] = cols[2 * i + 1] + (sq >> 16)
        for j in range(i + 1, 16):
            prod = al[i] * al[j]
            # 2*prod can overflow u32; split first, double the halves
            cols[i + j] = cols[i + j] + ((prod & MASK16) << 1)
            cols[i + j + 1] = cols[i + j + 1] + ((prod >> 16) << 1)
    return _reduce(cols)


def _reduce(cols: List[jnp.ndarray]) -> Limbs:
    """33 uncarried 16-bit columns (< 2^22 each) -> canonical limbs.

    Column bounds: schoolbook sums <= 512*2^16 < 2^22 (sqr's doubled
    halves stay < 2^17, 32 of them < 2^22). After fold 1: < 2^23.
    After fold 2: < 2^24. All fit u32 with room."""
    zero = _zeros(cols[0])
    # fold 1: cols[16..32] * (2^32 + 0x3D1) into cols[0..18]
    low = cols[:16] + [zero, zero, zero]
    for i, h in enumerate(cols[16:]):
        hp = h * FOLD  # < 2^22 * 2^10: no u32 wrap
        low[i] = low[i] + (hp & MASK16)
        low[i + 1] = low[i + 1] + (hp >> 16)
        low[i + 2] = low[i + 2] + h
    # fold 2: cols[16..18]
    high = low[16:]
    low = low[:16]
    for i, h in enumerate(high):
        hp = h * FOLD
        low[i] = low[i] + (hp & MASK16)
        low[i + 1] = low[i + 1] + (hp >> 16)
        low[i + 2] = low[i + 2] + h
    # carry into 8 u32 limbs
    out = []
    carry = zero
    for i in range(8):
        lo = low[2 * i] + carry
        hi = low[2 * i + 1] + (lo >> 16)
        out.append((lo & MASK16) | (hi << 16))
        carry = hi >> 16
    # micro-fold the final carry (< 2^9): + carry * (2^32 + 0x3D1)
    r = []
    t = out[0] + carry * FOLD
    c = _u32(t < out[0])
    r.append(t)
    t1 = out[1] + carry
    c1 = _u32(t1 < carry)
    t = t1 + c
    c2 = _u32(t < c)
    c = c1 | c2
    r.append(t)
    for i in range(2, 8):
        t = out[i] + c
        c = _u32(t < c)
        r.append(t)
    # conditional subtract p via r - p ≡ r + 0x1000003D1 (mod 2^256);
    # carry-out <=> r >= p
    d, cc = _add_neg_p(r)
    take = (c == 1) | (cc == 1)
    return tuple(_where(take, d[i], r[i]) for i in range(8))


def _add_neg_p(r: Sequence) -> Tuple[List[jnp.ndarray], jnp.ndarray]:
    """r + (2^256 - p) = r + 0x1000003D1 over 8 limbs -> (sum, carry_out).
    carry_out == 1 iff r >= p (mod-2^256 wrap = the subtraction r - p)."""
    d = []
    t = r[0] + FOLD
    c = _u32(t < r[0])
    d.append(t)
    t1 = r[1] + 1
    c1 = _u32(t1 == 0)
    t = t1 + c
    c2 = _u32(t < c)
    d.append(t)
    c = c1 | c2
    for i in range(2, 8):
        t = r[i] + c
        c = _u32(t < c)
        d.append(t)
    return d, c


def add(a: Sequence, b: Sequence) -> Limbs:
    """(a + b) mod p for canonical inputs."""
    s, carry = [], _zeros(a[0])
    for i in range(8):
        t = a[i] + carry
        c1 = _u32(t < carry)
        u = t + b[i]
        c2 = _u32(u < t)
        s.append(u)
        carry = c1 | c2
    d, cc = _add_neg_p(s)
    take = (carry == 1) | (cc == 1)
    return tuple(_where(take, d[i], s[i]) for i in range(8))


def sub(a: Sequence, b: Sequence) -> Limbs:
    """(a - b) mod p for canonical inputs."""
    out, borrow = [], _zeros(a[0])
    for i in range(8):
        t = a[i] - b[i]
        b1 = _u32(a[i] < b[i])
        s = t - borrow
        b2 = _u32(t < borrow)
        out.append(s)
        borrow = b1 | b2
    # on borrow the mod-2^256 wrap added 2^256; adding p back equals
    # subtracting (2^256 - p) = 0x1000003D1
    adj = []
    t = out[0] - FOLD
    bw = _u32(out[0] < FOLD)
    adj.append(t)
    t1 = out[1] - 1
    b1 = _u32(out[1] == 0)
    t = t1 - bw
    b2 = _u32(t1 < bw)
    adj.append(t)
    bw = b1 | b2
    for i in range(2, 8):
        t = out[i] - bw
        bw = _u32(out[i] < bw)
        adj.append(t)
    take = borrow == 1
    return tuple(_where(take, adj[i], out[i]) for i in range(8))


def dbl(a: Sequence) -> Limbs:
    return add(a, a)


def neg(a: Sequence) -> Limbs:
    """(-a) mod p; maps 0 -> 0."""
    z = _zeros(a[0])
    return sub((z,) * 8, a)


def is_zero(a: Sequence) -> jnp.ndarray:
    acc = a[0]
    for i in range(1, 8):
        acc = acc | a[i]
    return acc == 0


def eq(a: Sequence, b: Sequence) -> jnp.ndarray:
    acc = a[0] ^ b[0]
    for i in range(1, 8):
        acc = acc | (a[i] ^ b[i])
    return acc == 0


def select(mask: jnp.ndarray, a: Sequence, b: Sequence) -> Limbs:
    """where(mask, a, b) limb by limb."""
    return tuple(_where(mask, a[i], b[i]) for i in range(8))


def one_like(a: Sequence) -> Limbs:
    z = _zeros(a[0])
    return (z + 1,) + (z,) * 7


def inv(a: Sequence) -> Limbs:
    """a^(p-2) via the standard secp256k1 addition chain: 255 squarings +
    15 multiplies. Branch-free; maps 0 -> 0.

    Squaring runs are fori_loops so the traced body stays ~30 mul-sized
    (a fully unrolled ladder is ~250k operations to compile)."""

    def sqr_n(x, n):
        if n <= 2:
            for _ in range(n):
                x = sqr(x)
            return x
        return fori(n, lambda i, v: sqr(v), x)

    x1 = tuple(a[i] for i in range(8))
    x2 = mul(sqr_n(x1, 1), x1)  # 2^2 - 1
    x3 = mul(sqr_n(x2, 1), x1)  # 2^3 - 1
    x6 = mul(sqr_n(x3, 3), x3)
    x9 = mul(sqr_n(x6, 3), x3)
    x11 = mul(sqr_n(x9, 2), x2)
    x22 = mul(sqr_n(x11, 11), x11)
    x44 = mul(sqr_n(x22, 22), x22)
    x88 = mul(sqr_n(x44, 44), x44)
    x176 = mul(sqr_n(x88, 88), x88)
    x220 = mul(sqr_n(x176, 44), x44)
    x223 = mul(sqr_n(x220, 3), x3)
    # tail: p - 2 = (2^223 - 1)*2^33 + 0x1_FFFFFC2D
    t = mul(sqr_n(x223, 23), x22)
    t = mul(sqr_n(t, 5), x1)
    t = mul(sqr_n(t, 3), x2)
    t = mul(sqr_n(t, 2), x1)
    return t


def chain_inverse(dens: Sequence) -> Limbs:
    """Montgomery batch inverse along axis 0 of each limb array.

    Lanes of the trailing axes are independent chains: a forward scan
    keeps the exclusive prefix products, ONE addition-chain inversion
    of each chain's total, and a backward scan peels every inverse
    (~3 multiplies per element). Zero denominators must have been
    masked to 1 by the caller."""
    dens = tuple(dens[i] for i in range(8))
    one = one_like(tuple(d[0] for d in dens))

    def fwd(acc, d):
        return mul(acc, d), acc

    def bwd(run, xs):
        d, pre = xs
        return mul(run, d), mul(run, pre)

    if isinstance(dens[0], np.ndarray):
        n = dens[0].shape[0]
        excl, acc = [], one
        for g in range(n):
            acc, pre = fwd(acc, tuple(d[g] for d in dens))
            excl.append(pre)
        run, invs = inv(acc), [None] * n
        for g in reversed(range(n)):
            run, invs[g] = bwd(run, (tuple(d[g] for d in dens), excl[g]))
        return tuple(np.stack([v[k] for v in invs]) for k in range(8))
    total, excl = jax.lax.scan(fwd, one, dens)
    _, invs = jax.lax.scan(bwd, inv(total), (dens, excl), reverse=True)
    return invs


# -- host-layout conversion helpers (callers/tests) -------------------------


def to_tiles(a_bm: jnp.ndarray, lanes: int = 128) -> jnp.ndarray:
    """(B, 8) batch-major -> (8, B/lanes, lanes) limb-major."""
    b = a_bm.shape[0]
    return jnp.transpose(a_bm, (1, 0)).reshape(8, b // lanes, lanes)


def from_tiles(a_lm) -> jnp.ndarray:
    """(8, S, lanes) limb-major (array or limb tuple) -> (S*lanes, 8)."""
    return jnp.transpose(jnp.asarray(a_lm).reshape(8, -1), (1, 0))
