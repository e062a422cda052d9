"""Curve ops vs the exact golden reference (keys 1..32 and random points).

Mirrors the reference's de-facto acceptance fixtures (tests/1to32.* are
the addresses/hashes of private keys 1..32; SURVEY.md §4) as first-class
automated tests.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from keyhuntm1cpu_tpu.curve import points, tables, walk
from keyhuntm1cpu_tpu.field import fe
from keyhuntm1cpu_tpu.ref import ecref

random.seed(99)


def test_add_general_cases():
    ks = [1, 2, 3, 5, 100, ecref.N - 1]
    pa = [ecref.scalar_mult(k) for k in ks] + [None, ecref.G, None]
    pb = [ecref.scalar_mult(k + 7) for k in ks] + [ecref.G, None, None]
    # doubling and P + (-P)
    pa += [ecref.scalar_mult(9), ecref.scalar_mult(9)]
    pb += [ecref.scalar_mult(9), ecref.point_neg(ecref.scalar_mult(9))]
    A = points.point_batch_from_ints(pa)
    B = points.point_batch_from_ints(pb)
    got = points.point_batch_to_ints(points.add(A, B, chain_len=4))
    exp = [ecref.point_add(x, y) for x, y in zip(pa, pb)]
    assert got == exp


def test_scalar_mult_keys_1_to_32():
    gx, gy = tables.gtable_np()
    scalars = list(range(1, 33))
    got = points.point_batch_to_ints(
        points.scalar_mult_batch(
            fe.from_ints(scalars), jnp.asarray(gx), jnp.asarray(gy), chain_len=8
        )
    )
    exp = [ecref.scalar_mult(k) for k in scalars]
    assert got == exp


def test_scalar_mult_large_keys():
    gx, gy = tables.gtable_np()
    scalars = [
        0x7CCE5EFDACCF6808,  # puzzle 63 solution
        0x1A838B13505B26867,  # puzzle 65 solution
        random.randrange(1, ecref.N),
        ecref.N - 1,
    ]
    got = points.point_batch_to_ints(
        points.scalar_mult_batch(
            fe.from_ints(scalars), jnp.asarray(gx), jnp.asarray(gy), chain_len=4
        )
    )
    assert got == [ecref.scalar_mult(k) for k in scalars]


def test_xonly_walk_symmetric():
    U = 16
    tb_x, tb_y = tables.step_table(ecref.G, U)
    cs = [1000, 5]  # 5 exercises the degenerate (center == u*S) lane
    Cb = points.point_batch_from_ints([ecref.scalar_mult(c) for c in cs])
    res = walk.xonly_walk(
        Cb, jnp.asarray(tb_x), jnp.asarray(tb_y), symmetric=True, chain_len=8
    )
    deg = np.asarray(res.degenerate)
    for t, c in enumerate(cs):
        xp = fe.to_ints(res.x_plus[t])
        xm = fe.to_ints(res.x_minus[t])
        for u in range(1, U + 1):
            if deg[t, u - 1]:
                continue  # flagged lane: host would verify candidate c = +-u
            assert xp[u - 1] == ecref.scalar_mult(c + u)[0], (t, u)
            if c != u:
                assert xm[u - 1] == ecref.scalar_mult(c - u)[0], (t, u)
    assert deg[1, 4], "center==5G vs u=5 must be flagged"
    assert not deg[0].any()


def test_walk_advance():
    Cb = points.point_batch_from_ints([ecref.scalar_mult(77)])
    S = points.point_batch_from_ints([ecref.scalar_mult(100)])
    out = points.point_batch_to_ints(walk.advance(Cb, S, chain_len=1))
    assert out == [ecref.scalar_mult(177)]


def test_walk_nonsymmetric():
    U = 8
    tb_x, tb_y = tables.step_table(ecref.G, U)
    Cb = points.point_batch_from_ints([ecref.scalar_mult(50)])
    res = walk.xonly_walk(Cb, jnp.asarray(tb_x), jnp.asarray(tb_y), symmetric=False)
    assert res.x_minus is None
    xp = fe.to_ints(res.x_plus[0])
    for u in range(1, U + 1):
        assert xp[u - 1] == ecref.scalar_mult(50 + u)[0]
