"""BSGS walk kernels (curve/pwalk.py): the two-stage algorithm run as its
numpy reference against ecref, the doubling / infinity / degenerate lane
rules, the C++ kernel code compiled for the host, the FFI lowering for
CUDA (no card needed), and — on the card only — the CUDA kernels against
the host build of the same code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from keyhuntm1cpu_tpu.curve import pwalk, tables
from keyhuntm1cpu_tpu.field import fe
from keyhuntm1cpu_tpu.ref import ecref

STRIDE = 1000
MASK64 = (1 << 64) - 1


def _chunk_args(keys, K, U, stride=STRIDE):
    """walk_chunk operands for targets k_t*G, S = -stride*G, ADV = U*S."""
    S = ecref.point_neg(ecref.scalar_mult(stride))
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))
    tx, ty = tables.step_table(S, U)
    ax, ay = tables.step_table(adv, K)
    pts = [ecref.scalar_mult(k) for k in keys]
    px = np.stack([fe.int_to_limbs(p[0]) for p in pts])
    py = np.stack([fe.int_to_limbs(p[1]) for p in pts])
    lm = lambda a: np.ascontiguousarray(a.T)
    return px, py, lm(tx), lm(ty), lm(ax), lm(ay)


def _lane_x(res, row, u):
    return int(res.qlo[row, u - 1]) | (int(res.qhi[row, u - 1]) << 32)


def test_walk_chunk_reference_matches_ecref():
    keys, K, U = [12345678, 999], 8, 32
    res = pwalk.walk_chunk(*_chunk_args(keys, K, U), impl="xla")
    assert isinstance(res.qlo, np.ndarray)  # numpy reference path
    assert res.qlo.shape == (len(keys) * K, U)
    for t, k in enumerate(keys):
        for s in range(K):
            for u in range(1, U + 1):
                want = ecref.scalar_mult((k - (s * U + u) * STRIDE) % ecref.N)
                assert _lane_x(res, t * K + s, u) == want[0] & MASK64
        nxt = ecref.scalar_mult((k - K * U * STRIDE) % ecref.N)
        assert fe.limbs_to_int(res.next_x[t]) == nxt[0]
        assert fe.limbs_to_int(res.next_y[t]) == nxt[1]
    assert not res.degenerate.any() and not res.adv_degenerate.any()


def test_bases_take_doubling_slope_and_flag_infinity():
    """Kernel A lane rules: P == Q doubles, P == -Q is flagged."""
    p = ecref.scalar_mult(77)
    q_same, q_neg = p, ecref.point_neg(p)
    q_other = ecref.scalar_mult(5)
    cols = lambda pts, i: np.stack(
        [fe.int_to_limbs(pt[i]) for pt in pts], axis=1)
    P = [p, p, p]
    Q = [q_same, q_neg, q_other]
    x3, y3, inf = pwalk.add_lanes(cols(P, 0), cols(P, 1), cols(Q, 0),
                                  cols(Q, 1), impl="xla")
    dbl = ecref.scalar_mult(154)
    assert fe.limbs_to_int(x3[:, 0]) == dbl[0]
    assert fe.limbs_to_int(y3[:, 0]) == dbl[1]
    assert list(inf) == [False, True, False]
    s = ecref.scalar_mult(82)
    assert (fe.limbs_to_int(x3[:, 2]), fe.limbs_to_int(y3[:, 2])) == s


def test_walk_flags_degenerate_lane_and_base_at_infinity():
    """A target sitting on a walk center makes that lane degenerate
    (dx == 0); a base reaching the point at infinity is an advance
    degeneracy."""
    K, U = 4, 16
    # lane (s, u) is (k - (s*U + u)*stride)*G; it is degenerate when
    # base_s = +-u*S, i.e. k = (s*U +- u)*stride: k = 21*stride hits
    # (s, u) = (1, 5) and (2, 11)
    k = (1 * U + 5) * STRIDE
    res = pwalk.walk_chunk(*_chunk_args([k], K, U), impl="xla")
    assert sorted(zip(*np.nonzero(res.degenerate))) == [(1, 4), (2, 10)]
    # k = U*stride*2 -> base 2 = P - 2*U*stride*G = infinity
    res = pwalk.walk_chunk(*_chunk_args([2 * U * STRIDE], K, U), impl="xla")
    assert res.adv_degenerate[0, 1] and res.adv_degenerate.sum() == 1


def test_host_kernels_match_reference():
    """The C++ per-lane code of both CUDA kernels, compiled for the host,
    equals the numpy reference bit for bit — degenerate lanes and a base
    at infinity (same masked formulas, so even its lanes agree) included."""
    K, U = 8, 32
    for keys in ([12345678, 999], [(1 * U + 5) * STRIDE],
                 [2 * U * STRIDE, 77]):
        args = _chunk_args(keys, K, U)
        ref = pwalk.walk_chunk(*args, impl="xla")
        got = pwalk.walk_chunk(*args, impl="host")
        for name in pwalk.WalkChunk._fields:
            assert np.array_equal(np.asarray(getattr(got, name)),
                                  np.asarray(getattr(ref, name))), (keys, name)


@pytest.mark.parametrize("nb,chain", [(256, 64), (64, 64), (48, 16),
                                      (8, 8), (6, 2), (1, 1)])
def test_walk_chain_length(nb, chain):
    """Kernel B's chain: the largest power of two <= CHAIN dividing nb."""
    assert pwalk._pow2_divisor(nb, pwalk.CHAIN) == chain


def test_kernels_lower_for_cuda():
    """Both kernels lower to CUDA custom calls through the FFI
    (cross-platform export: shapes and operands, no card needed)."""
    args = [jnp.zeros((2, 8), jnp.uint32)] * 2 + \
        [jnp.zeros((8, 32), jnp.uint32)] * 2 + \
        [jnp.zeros((8, 4), jnp.uint32)] * 2
    targets = ("KeyhuntWalkBases", "KeyhuntWalkBlocks")
    exp = jax.export.export(
        jax.jit(lambda *a: pwalk.walk_chunk(*a, impl="cuda")),
        platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(t)
                         for t in targets],
    )(*args)
    text = exp.mlir_module()
    for t in targets:
        assert f"@{t}" in text


@pytest.mark.gpu
def test_walk_kernels_match_reference_on_gpu(gpu_only):
    keys, K, U = [0x7CCE5EFDACCF6808, 12345], 16, 256
    args = _chunk_args(keys, K, U, stride=1 << 29)
    ref = pwalk.walk_chunk(*args, impl="host")
    got = jax.jit(lambda *a: pwalk.walk_chunk(*a, impl="cuda"))(
        *(jnp.asarray(a) for a in args))
    for name in pwalk.WalkChunk._fields:
        assert np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(getattr(ref, name))), name
