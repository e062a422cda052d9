"""Limb-split field arithmetic (field/fe_tiles.py) vs python-int golden."""

import numpy as np
import pytest

import jax.numpy as jnp

from keyhuntm1cpu_tpu.field import fe, fe_tiles as ft

P = ft.P_INT
RNG = np.random.default_rng(42)


def _rand_elems(n):
    vals = [int.from_bytes(RNG.bytes(32), "little") % P for _ in range(n)]
    return vals


def _tiles_from_ints(vals, lanes=8):
    arr = np.stack([fe.int_to_limbs(v) for v in vals])  # (B, 8)
    b = arr.shape[0]
    return jnp.asarray(arr.T.reshape(8, b // lanes, lanes))


def _ints_from_tiles(t):
    arr = np.asarray(t).reshape(8, -1).T  # (B, 8)
    return [fe.limbs_to_int(r) for r in arr]


class TestTileOps:
    def test_mul(self):
        a = _rand_elems(32)
        b = _rand_elems(32)
        got = _ints_from_tiles(ft.mul(_tiles_from_ints(a), _tiles_from_ints(b)))
        assert got == [(x * y) % P for x, y in zip(a, b)]

    def test_sqr(self):
        a = _rand_elems(32)
        got = _ints_from_tiles(ft.sqr(_tiles_from_ints(a)))
        assert got == [(x * x) % P for x in a]

    def test_add_sub_edges(self):
        a = _rand_elems(6) + [0, 1, P - 1]
        b = _rand_elems(6) + [0, P - 1, P - 1]
        # pad to lane multiple
        a += [0] * (16 - len(a))
        b += [0] * (16 - len(b))
        ta, tb = _tiles_from_ints(a), _tiles_from_ints(b)
        assert _ints_from_tiles(ft.add(ta, tb)) == [(x + y) % P for x, y in zip(a, b)]
        assert _ints_from_tiles(ft.sub(ta, tb)) == [(x - y) % P for x, y in zip(a, b)]

    def test_neg_and_zero(self):
        a = _rand_elems(7) + [0]
        got = _ints_from_tiles(ft.neg(_tiles_from_ints(a)))
        assert got == [(-x) % P for x in a]

    def test_inv_addition_chain(self):
        """The hand addition chain must equal a^(p-2) mod p exactly."""
        a = _rand_elems(7) + [1]
        got = _ints_from_tiles(ft.inv(_tiles_from_ints(a)))
        assert got == [pow(x, P - 2, P) for x in a]

    def test_montgomery_inv_groups(self):
        """chain_inverse: Montgomery chains along axis 0, one Fermat
        ladder per chain lane (numpy reference path)."""
        a = _rand_elems(64)
        t = np.asarray(_tiles_from_ints(a))  # (8, 8, 8): 8-long chains
        out = ft.chain_inverse(t)
        assert _ints_from_tiles(out) == [pow(x, P - 2, P) for x in a]

    def test_numpy_path_matches_jax(self):
        """The numpy reference path of every op equals the jax path."""
        a, b = _rand_elems(16), _rand_elems(16)
        ta, tb = _tiles_from_ints(a), _tiles_from_ints(b)
        na, nb = np.asarray(ta), np.asarray(tb)
        for op in (ft.mul, ft.sqr, ft.add, ft.sub):
            args = (ta, tb)[: 1 if op is ft.sqr else 2]
            nargs = (na, nb)[: len(args)]
            got = op(*nargs)
            assert all(isinstance(g, np.ndarray) for g in got)
            assert np.array_equal(np.asarray(got), np.asarray(op(*args)))

    def test_select_eq_iszero(self):
        a = _rand_elems(8)
        ta = _tiles_from_ints(a)
        tz = jnp.zeros_like(ta)
        assert bool(ft.is_zero(tz).all())
        assert not bool(ft.is_zero(ta).any())
        assert bool(ft.eq(ta, ta).all())
        sel = ft.select(ft.is_zero(tz), ta, tz)
        assert _ints_from_tiles(sel) == a

    def test_layout_roundtrip(self):
        a = _rand_elems(256)
        bm = jnp.asarray(np.stack([fe.int_to_limbs(v) for v in a]))
        assert _ints_from_tiles(ft.to_tiles(bm)) == a
        back = ft.from_tiles(ft.to_tiles(bm))
        assert np.array_equal(np.asarray(back), np.asarray(bm))
