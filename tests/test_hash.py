"""Vectorized hash kernels vs hashlib / the pure-python golden reference.

Key fixture: hash160(compressed pubkey of key 1) == 751e76e8... — the
first entry of the reference's tests/1to32.rmd (SURVEY.md §4).
"""

import hashlib
import random

import numpy as np
import pytest

from keyhuntm1cpu_tpu.field import fe
from keyhuntm1cpu_tpu.hash import (
    hash160_from_x_both_parities,
    hash160_from_xy,
    keccak256_pubkey64,
    sha256_33_from_x,
    sha256_65_from_xy,
)
from keyhuntm1cpu_tpu.ref import ecref, hashref

random.seed(7)

KEYS = list(range(1, 33)) + [0x7CCE5EFDACCF6808, random.randrange(1, ecref.N)]
PTS = [ecref.scalar_mult(k) for k in KEYS]


def _words_to_bytes_le(words) -> bytes:
    """5 uint32 words, each little-endian -> 20 bytes."""
    out = b""
    for w in words:
        out += int(w).to_bytes(4, "little")
    return out


def _sha_words_to_bytes_be(words) -> bytes:
    out = b""
    for w in words:
        out += int(w).to_bytes(4, "big")
    return out


@pytest.fixture(scope="module")
def xy():
    return (
        fe.from_ints([pt[0] for pt in PTS]),
        fe.from_ints([pt[1] for pt in PTS]),
    )


def test_sha256_33(xy):
    x, _ = xy
    import jax.numpy as jnp

    for parity in (2, 3):
        prefix = jnp.full((len(PTS),), parity, dtype=jnp.uint32)
        words = sha256_33_from_x(x, prefix)
        w = np.stack([np.asarray(v) for v in words], axis=-1)
        for i, pt in enumerate(PTS):
            msg = bytes([parity]) + pt[0].to_bytes(32, "big")
            assert _sha_words_to_bytes_be(w[i]) == hashlib.sha256(msg).digest()


def test_sha256_65(xy):
    x, y = xy
    words = sha256_65_from_xy(x, y)
    w = np.stack([np.asarray(v) for v in words], axis=-1)
    for i, pt in enumerate(PTS):
        msg = b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
        assert _sha_words_to_bytes_be(w[i]) == hashlib.sha256(msg).digest()


def test_hash160_both_parities(xy):
    x, _ = xy
    even, odd = hash160_from_x_both_parities(x)
    we = np.stack([np.asarray(v) for v in even], axis=-1)
    wo = np.stack([np.asarray(v) for v in odd], axis=-1)
    for i, pt in enumerate(PTS):
        for words, parity in ((we, 2), (wo, 3)):
            msg = bytes([parity]) + pt[0].to_bytes(32, "big")
            exp = hashref.ripemd160(hashlib.sha256(msg).digest())
            assert _words_to_bytes_le(words[i]) == exp


def test_hash160_key1_fixture(xy):
    """hash160(02||G.x) must equal the canonical 751e76e8... vector."""
    x, _ = xy
    even, _ = hash160_from_x_both_parities(x)
    w = np.stack([np.asarray(v) for v in even], axis=-1)
    assert _words_to_bytes_le(w[0]).hex() == "751e76e8199196d454941c45d1b3a323f1433bd6"


def test_hash160_uncompressed(xy):
    x, y = xy
    words = hash160_from_xy(x, y)
    w = np.stack([np.asarray(v) for v in words], axis=-1)
    for i, pt in enumerate(PTS):
        exp = hashref.pubkey_to_hash160(pt, compressed=False)
        assert _words_to_bytes_le(w[i]) == exp


def test_keccak_eth_address(xy):
    x, y = xy
    words = keccak256_pubkey64(x, y)
    w = np.stack([np.asarray(v) for v in words], axis=-1)
    for i, pt in enumerate(PTS):
        exp = hashref.pubkey_to_eth_address(pt)
        assert _words_to_bytes_le(w[i]) == exp


def test_eth_key1_fixture(xy):
    x, y = xy
    words = keccak256_pubkey64(x, y)
    w = np.stack([np.asarray(v) for v in words], axis=-1)
    assert _words_to_bytes_le(w[0]).hex() == "7e5f4552091a69125d5dfcb7b8c2659029395bdf"


class TestSHA512:
    def test_matches_hashlib_various_lengths(self):
        import hashlib

        import numpy as np

        from keyhuntm1cpu_tpu.hash.sha512 import sha512_msgs

        rng = np.random.default_rng(0)
        for length in (0, 1, 55, 64, 111, 112, 128, 200, 300):
            b = 5
            msgs = rng.integers(0, 256, size=(b, length), dtype=np.uint8)
            got = sha512_msgs(msgs)
            for i in range(b):
                want = hashlib.sha512(msgs[i].tobytes()).digest()
                assert got[i].tobytes() == want, f"len={length} row={i}"
