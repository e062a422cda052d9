"""Vectorized SHA-512 over (hi, lo) uint32 lane pairs.

Capability parity with the reference's hash/sha512.cpp (brainwallet
lineage — "present for completeness; not in hot path", SURVEY.md §2.1
#10). Without 64-bit mode JAX has no 64-bit integer arrays, so every 64-bit word is a
(hi, lo) pair of uint32 lanes; rotations split across the pair and adds
carry lo -> hi. Compression is a lax.scan over the 80 rounds (same
graph-size discipline as sha256.py).

API: `sha512_msgs` hashes a batch of equal-length byte messages
(host-packed blocks, device compression); verified bit-exact against
hashlib in tests.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32

_H0 = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

_K = (
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
)

W64 = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo) uint32 lane pair


def _rotr64(hi, lo, n: int) -> W64:
    if n == 32:
        return lo, hi
    if n < 32:
        nh = (hi >> _U32(n)) | (lo << _U32(32 - n))
        nl = (lo >> _U32(n)) | (hi << _U32(32 - n))
        return nh, nl
    m = n - 32
    nh = (lo >> _U32(m)) | (hi << _U32(32 - m))
    nl = (hi >> _U32(m)) | (lo << _U32(32 - m))
    return nh, nl


def _shr64(hi, lo, n: int) -> W64:
    if n < 32:
        return hi >> _U32(n), (lo >> _U32(n)) | (hi << _U32(32 - n))
    return jnp.zeros_like(hi), hi >> _U32(n - 32)


def _add64(ah, al, bh, bl) -> W64:
    lo = al + bl
    carry = (lo < al).astype(_U32)
    return ah + bh + carry, lo


def _add64_many(*pairs) -> W64:
    h, l = pairs[0]
    for ph, plo in pairs[1:]:
        h, l = _add64(h, l, ph, plo)
    return h, l


def _xor3(a: W64, b: W64, c: W64) -> W64:
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _compress(state: List[W64], w16: List[W64]) -> List[W64]:
    """One SHA-512 compression, lax.scan over 80 rounds."""
    init = state
    whi = jnp.stack([w[0] for w in w16])  # (16, B)
    wlo = jnp.stack([w[1] for w in w16])
    k_hi = jnp.asarray(np.array([k >> 32 for k in _K], dtype=np.uint32))
    k_lo = jnp.asarray(np.array([k & 0xFFFFFFFF for k in _K], dtype=np.uint32))

    def body(carry, kparts):
        khi, klo = kparts
        (ah, al, bh, bl, ch_, cl, dh, dl,
         eh, el, fh, fl, gh, gl, hh, hl, wbh, wbl) = carry
        wih, wil = wbh[0], wbl[0]
        s1 = _xor3(_rotr64(eh, el, 14), _rotr64(eh, el, 18), _rotr64(eh, el, 41))
        ch = ((eh & fh) ^ (~eh & gh), (el & fl) ^ (~el & gl))
        t1 = _add64_many((hh, hl), s1, ch, (khi, klo), (wih, wil))
        s0 = _xor3(_rotr64(ah, al, 28), _rotr64(ah, al, 34), _rotr64(ah, al, 39))
        maj = ((ah & bh) ^ (ah & ch_) ^ (bh & ch_),
               (al & bl) ^ (al & cl) ^ (bl & cl))
        t2 = _add64_many(s0, maj)
        # schedule extension
        sig0 = _xor3(_rotr64(wbh[1], wbl[1], 1), _rotr64(wbh[1], wbl[1], 8),
                     _shr64(wbh[1], wbl[1], 7))
        sig1 = _xor3(_rotr64(wbh[14], wbl[14], 19), _rotr64(wbh[14], wbl[14], 61),
                     _shr64(wbh[14], wbl[14], 6))
        wn = _add64_many((wbh[0], wbl[0]), sig0, (wbh[9], wbl[9]), sig1)
        wbh = jnp.concatenate([wbh[1:], wn[0][None]], axis=0)
        wbl = jnp.concatenate([wbl[1:], wn[1][None]], axis=0)
        na = _add64_many(t1, t2)
        ne = _add64(dh, dl, *t1)
        out = (na[0], na[1], ah, al, bh, bl, ch_, cl,
               ne[0], ne[1], eh, el, fh, fl, gh, gl, wbh, wbl)
        return out, None

    flat = []
    for h, l in state:
        flat += [h, l]
    carry0 = (*flat, whi, wlo)
    out, _ = jax.lax.scan(body, carry0, (k_hi, k_lo))
    final = [(out[2 * i], out[2 * i + 1]) for i in range(8)]
    return [
        _add64(fh, fl, ih, il) for (fh, fl), (ih, il) in zip(final, init)
    ]


def _pad_msgs(msgs: np.ndarray) -> np.ndarray:
    """(B, L) uint8 -> (B, n_blocks, 16, 2) uint32 BE block words (hi, lo)."""
    b, length = msgs.shape
    n_blocks = (length + 17 + 127) // 128
    buf = np.zeros((b, n_blocks * 128), dtype=np.uint8)
    buf[:, :length] = msgs
    buf[:, length] = 0x80
    bitlen = length * 8
    for i in range(8):
        buf[:, -1 - i] = (bitlen >> (8 * i)) & 0xFF
    words = buf.reshape(b, n_blocks, 16, 8)
    out = np.zeros((b, n_blocks, 16, 2), dtype=np.uint32)
    be = np.array([1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32)
    out[..., 0] = (words[..., :4].astype(np.uint32) * be).sum(-1)
    out[..., 1] = (words[..., 4:].astype(np.uint32) * be).sum(-1)
    return out


def sha512_msgs(msgs: np.ndarray) -> np.ndarray:
    """SHA-512 of a batch of equal-length messages: (B, L) uint8 ->
    (B, 64) uint8 digests. Device-vectorized over the batch."""
    blocks = jnp.asarray(_pad_msgs(np.asarray(msgs, dtype=np.uint8)))
    b, n_blocks = blocks.shape[:2]
    state = [
        (jnp.full((b,), h >> 32, dtype=_U32), jnp.full((b,), h & 0xFFFFFFFF, dtype=_U32))
        for h in _H0
    ]
    for blk in range(n_blocks):
        w16 = [(blocks[:, blk, i, 0], blocks[:, blk, i, 1]) for i in range(16)]
        state = _compress(state, w16)
    out = np.zeros((b, 64), dtype=np.uint8)
    for i, (h, l) in enumerate(state):
        hn = np.asarray(h)
        ln = np.asarray(l)
        for k in range(4):
            out[:, 8 * i + k] = (hn >> (24 - 8 * k)) & 0xFF
            out[:, 8 * i + 4 + k] = (ln >> (24 - 8 * k)) & 0xFF
    return out
