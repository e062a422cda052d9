"""Vectorized Keccak-256 of the 64-byte x||y pubkey (ETH addresses).

Without 64-bit mode JAX has no 64-bit integer arrays, so every Keccak lane is an emulated
(hi, lo) uint32 pair; rotations split across the pair. Single absorb
(64 < rate 136), 24 statically-unrolled rounds. Capability of the
reference's sha3/ Keccak + generate_binaddress_eth (keyhunt.cpp:4783-4791).
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

_U32 = jnp.uint32

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

Lane = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo) uint32 pair


def _xor(a: Lane, b: Lane) -> Lane:
    return (a[0] ^ b[0], a[1] ^ b[1])


def _rol64(a: Lane, n: int) -> Lane:
    n %= 64
    hi, lo = a
    if n == 0:
        return a
    if n == 32:
        return (lo, hi)
    if n < 32:
        nhi = (hi << _U32(n)) | (lo >> _U32(32 - n))
        nlo = (lo << _U32(n)) | (hi >> _U32(32 - n))
        return (nhi, nlo)
    m = n - 32
    nhi = (lo << _U32(m)) | (hi >> _U32(32 - m))
    nlo = (hi << _U32(m)) | (lo >> _U32(32 - m))
    return (nhi, nlo)


def _bswap32(x: jnp.ndarray) -> jnp.ndarray:
    return (
        ((x & _U32(0xFF)) << _U32(24))
        | ((x & _U32(0xFF00)) << _U32(8))
        | ((x >> _U32(8)) & _U32(0xFF00))
        | (x >> _U32(24))
    )


def _keccak_round(a: List[List[Lane]], rc_hi, rc_lo) -> List[List[Lane]]:
    """One keccak-f round (pure; lanes are (hi, lo) uint32 pairs)."""
    # theta
    c = [
        _xor(_xor(_xor(_xor(a[x][0], a[x][1]), a[x][2]), a[x][3]), a[x][4])
        for x in range(5)
    ]
    d = [_xor(c[(x - 1) % 5], _rol64(c[(x + 1) % 5], 1)) for x in range(5)]
    a = [[_xor(a[x][y], d[x]) for y in range(5)] for x in range(5)]
    # rho + pi
    b: List[List[Lane]] = [[None] * 5 for _ in range(5)]  # type: ignore
    for x in range(5):
        for y in range(5):
            b[y][(2 * x + 3 * y) % 5] = _rol64(a[x][y], _ROT[x][y])
    # chi
    out: List[List[Lane]] = [[None] * 5 for _ in range(5)]  # type: ignore
    for x in range(5):
        for y in range(5):
            nhi = b[x][y][0] ^ (~b[(x + 1) % 5][y][0] & b[(x + 2) % 5][y][0])
            nlo = b[x][y][1] ^ (~b[(x + 1) % 5][y][1] & b[(x + 2) % 5][y][1])
            out[x][y] = (nhi, nlo)
    # iota
    out[0][0] = (out[0][0][0] ^ rc_hi, out[0][0][1] ^ rc_lo)
    return out


def _keccak_f(a: List[List[Lane]]) -> List[List[Lane]]:
    """keccak-f[1600] as a lax.scan over the 24 rounds (round constants
    are the scanned xs), keeping the traced graph one round deep."""
    import jax
    import numpy as np

    flat = jnp.stack([jnp.stack([a[x][y][h] for h in range(2)]) for x in range(5) for y in range(5)])
    # flat: (25, 2, ...batch)
    rc = jnp.asarray(
        np.array([[(r >> 32) & 0xFFFFFFFF, r & 0xFFFFFFFF] for r in _RC], dtype=np.uint32)
    )  # (24, 2)

    def body(flat, rc_pair):
        state = [
            [
                (flat[5 * x + y, 0], flat[5 * x + y, 1])
                for y in range(5)
            ]
            for x in range(5)
        ]
        state = _keccak_round(state, rc_pair[0], rc_pair[1])
        nxt = jnp.stack(
            [jnp.stack([state[x][y][h] for h in range(2)]) for x in range(5) for y in range(5)]
        )
        return nxt, None

    flat, _ = jax.lax.scan(body, flat, rc)
    return [
        [(flat[5 * x + y, 0], flat[5 * x + y, 1]) for y in range(5)]
        for x in range(5)
    ]


def keccak256_pubkey64(x_limbs: jnp.ndarray, y_limbs: jnp.ndarray) -> List[jnp.ndarray]:
    """ETH address words from keccak256(X_be || Y_be)[12:32].

    Returns 5 uint32 words, word i = digest bytes [12+4i, 16+4i) read
    little-endian (matching filter/targets host packing for ETH targets).
    """
    zero = jnp.zeros(x_limbs.shape[:-1], dtype=_U32)
    xl = [x_limbs[..., i] for i in range(8)]
    yl = [y_limbs[..., i] for i in range(8)]

    state: List[List[Lane]] = [[(zero, zero)] * 5 for _ in range(5)]

    def set_lane(idx: int, lane: Lane):
        x, y = idx % 5, idx // 5
        state[x][y] = lane

    # message lanes 0..7: 64 bytes of X_be || Y_be read as LE uint64s
    for k in range(4):
        set_lane(k, (_bswap32(xl[6 - 2 * k]), _bswap32(xl[7 - 2 * k])))
    for k in range(4):
        set_lane(4 + k, (_bswap32(yl[6 - 2 * k]), _bswap32(yl[7 - 2 * k])))
    # padding: byte 64 = 0x01 (lane 8 lo), byte 135 = 0x80 (lane 16 hi MSB)
    set_lane(8, (zero, jnp.full_like(zero, 1)))
    set_lane(16, (jnp.full_like(zero, 0x80000000), zero))

    state = _keccak_f(state)

    def lane(idx: int) -> Lane:
        return state[idx % 5][idx // 5]

    l1, l2, l3 = lane(1), lane(2), lane(3)
    # digest bytes 12..31 -> LE words: [lane1.hi, lane2.lo, lane2.hi,
    # lane3.lo, lane3.hi]
    return [l1[0], l2[1], l2[0], l3[1], l3[0]]
