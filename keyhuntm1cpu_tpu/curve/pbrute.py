"""Fused brute-force chunk: walk + hash + membership in one jitted pass.

Target sets in the wild are small (tens to hundreds of 20-byte entries),
so membership is a broadcast compare of each point's 64-bit query words
against every target interval inside the chunk — no bitmap gathers, and
only a packed per-point hit word is compacted and returned:

- the XLA group walk (curve/walk.py walk_fused) over K steps of U keys,
- hashing (hash/hash160.py, hash/keccak.py) of both compressed parities,
  the uncompressed point or the eth address — none for xpoint,
- interval containment of the big-endian first 8 digest bytes: an exact
  target is a point interval, a vanity prefix a real range, so one
  compare path serves both and composes them (the reference's -v
  alongside address mode, keyhunt.cpp:6270-6272).

Output per point: bits 0..nq-1 = query-set match, bit 30 = degenerate
walk lane (the host re-verifies that key exactly).

Reference capability: thread_process hash160/xpoint hot loop
(keyhunt.cpp:2511-3099) + GetHash160_fromX both-parity hashing
(SECP256K1.cpp:746-790).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ref import ecref

MODES = ("xpoint", "rmd160", "eth", "address_u", "rmd160_both")


def n_qsets(mode: str, n_endo: int) -> int:
    """Query-set pairs emitted per walk point."""
    per = {"rmd160": 2, "rmd160_both": 3}.get(mode, 1)
    return per * n_endo


@functools.partial(
    jax.jit,
    static_argnames=("K", "U", "C", "mode", "n_endo", "chain"),
)
def xla_brute_chunk(px, py, tab_x, tab_y, ax, ay, tgt,
                    *, K, U, C, mode, n_endo, chain=32):
    """One brute chunk from base P (the chunk's start scalar * G): walks
    P + u*stride*G for K steps of U keys and returns (next_x, next_y,
    out) where `out` is ONE packed int32 summary vector (single host
    transfer):
        [cand_pos (C), cand_bits (C), n_deg (K), first_deg (K),
         adv_deg (K), n_candidates (1)]

    tab_x/tab_y: (U, 8) batch-major step table (u*stride*G, u = 1..U);
    tgt: (4, T) pack_intervals bounds; px/py/ax/ay: (8,) limbs."""
    from ..field import fe
    from ..hash.hash160 import hash160_from_x_both_parities, hash160_from_xy
    from ..hash.keccak import keccak256_pubkey64
    from . import points, walk

    needs_y = mode in ("eth", "address_u", "rmd160_both")
    T = tgt.shape[1]

    def bsw(x):
        return (
            ((x & jnp.uint32(0xFF)) << 24)
            | ((x & jnp.uint32(0xFF00)) << 8)
            | ((x >> 8) & jnp.uint32(0xFF00))
            | (x >> 24)
        )

    def member(a, b):
        m = jnp.zeros_like(a, dtype=bool)
        for t in range(T):
            lo_h, lo_l = tgt[0, t], tgt[1, t]
            hi_h, hi_l = tgt[2, t], tgt[3, t]
            ge = (a > lo_h) | ((a == lo_h) & (b >= lo_l))
            le = (a < hi_h) | ((a == hi_h) & (b <= hi_l))
            m = m | (ge & le)
        return m

    if n_endo == 3:
        beta = fe.from_int(ecref.BETA)
        beta2 = fe.from_int(ecref.BETA * ecref.BETA % ecref.P)

    def body(carry, _):
        cx, cy = carry  # (1, 8)
        pb = points.PointBatch(cx, cy, jnp.zeros((1,), dtype=bool))
        res = walk.walk_fused(pb, tab_x, tab_y, ax, ay,
                              chain_len=chain, need_y=needs_y)
        x = res.x_plus[0]  # (U, 8)
        y = res.y_plus[0] if needs_y else None
        hit = jnp.zeros((U,), dtype=jnp.uint32)
        q = 0
        for e in range(n_endo):
            xv = x if e == 0 else fe.mul_mod_p(
                x, beta if e == 1 else beta2
            )
            if mode == "xpoint":
                pairs = [(xv[:, 1], xv[:, 0])]
            elif mode in ("rmd160", "rmd160_both"):
                even, odd = hash160_from_x_both_parities(xv)
                pairs = [(even[0], even[1]), (odd[0], odd[1])]
                if mode == "rmd160_both":
                    u_w = hash160_from_xy(xv, y)
                    pairs.append((u_w[0], u_w[1]))
            elif mode == "eth":
                w = keccak256_pubkey64(xv, y)
                pairs = [(w[0], w[1])]
            else:  # address_u
                u_w = hash160_from_xy(xv, y)
                pairs = [(u_w[0], u_w[1])]
            if mode != "xpoint":
                pairs = [(bsw(lo_w), bsw(hi_w)) for lo_w, hi_w in pairs]
            for a, b in pairs:
                hit = hit | (member(a, b).astype(jnp.uint32) << q)
                q += 1
        deg = res.degenerate[0]  # (U,)
        hit = jnp.where(deg, jnp.uint32(1) << 30, hit)
        out = (hit, deg, res.adv_degenerate[0])
        return (res.adv_x, res.adv_y), out

    c0 = (px[None], py[None])
    (nx, ny), (hits, deg, adeg) = jax.lax.scan(body, c0, None, length=K)

    qbits = hits & jnp.uint32((1 << 30) - 1)  # (K, U)
    flat = qbits.reshape(-1)
    mask = flat != 0
    n = mask.sum().astype(jnp.int32)
    (pos,) = jnp.nonzero(mask, size=C, fill_value=K * U)
    pos = pos.astype(jnp.int32)
    bits = flat[jnp.minimum(pos, K * U - 1)]
    bits = jnp.where(pos < K * U, bits, 0)
    degf = hits >> 30 & 1
    n_deg = degf.sum(axis=1).astype(jnp.int32)
    first_deg = jnp.argmax(degf, axis=1).astype(jnp.int32)
    out = jnp.concatenate(
        [
            pos,
            bits.astype(jnp.int32),
            n_deg,
            first_deg,
            adeg.astype(jnp.int32),
            n[None],
        ]
    )
    return nx[0], ny[0], out


def pack_intervals(lo64, hi64) -> np.ndarray:
    """(4, T_pad) uint32 interval bounds [lo_hi, lo_lo, hi_hi, hi_lo]
    from 64-bit big-endian lo/hi values; padded to the next power of two
    (>= 8) by repeating entry 0 — bounds recompiles per target-set size
    while keeping the unrolled compare loop tight. Exact targets are
    point intervals (lo == hi)."""
    t = len(lo64)
    if t == 0:
        raise ValueError("empty target/interval set")
    tp = 8
    while tp < t:
        tp *= 2
    out = np.empty((4, tp), dtype=np.uint32)
    for i in range(tp):
        lo = int(lo64[i] if i < t else lo64[0])
        hi = int(hi64[i] if i < t else hi64[0])
        out[0, i] = (lo >> 32) & 0xFFFFFFFF
        out[1, i] = lo & 0xFFFFFFFF
        out[2, i] = (hi >> 32) & 0xFFFFFFFF
        out[3, i] = hi & 0xFFFFFFFF
    return out
