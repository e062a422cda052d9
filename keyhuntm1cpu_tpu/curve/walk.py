"""The universal group walk — X-only one-to-many point addition.

This is the batched re-design of the reference's single hot loop (the
"group walk" shared by every search mode, e.g. keyhunt.cpp:3873-3999 for
BSGS giant steps, :2593-2711 for address search, :4437-4492 for baby-table
build): walk many consecutive curve points from a center using ONE batched
modular inversion.

Where the reference walks 1024 points sequentially per thread, we compute
a whole (targets x offsets) tile of additions in parallel:

    X(C_t + u*S)  for all targets t and offsets u = 1..U

with one chunked-Montgomery batched inversion over all T*U denominators.
The symmetric variant also produces X(C_t - u*S) from the *same* inverse
(x(-uS) == x(uS), so the denominators coincide — the reference's +-i*G
trick, keyhunt.cpp:3886-3943, now a lane-level reuse instead of a loop
trick).

Degenerate lanes (C == +-uS, i.e. the true solution sits exactly on the
center) cannot be inverted; they are masked to 1 and *flagged* so the
engine host-verifies those candidate scalars exactly — replacing the
reference's scattered special cases (keyhunt.cpp:4352-4363).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..field import fe
from .points import PointBatch, add


class WalkResult(NamedTuple):
    x_plus: jnp.ndarray  # (T, U, 8) x-coords of C_t + u*S (u = 1..U)
    x_minus: jnp.ndarray | None  # (T, U, 8) x-coords of C_t - u*S (or None)
    degenerate: jnp.ndarray  # (T, U) bool — lane had dx == 0, x invalid


def _one_limbs(shape) -> jnp.ndarray:
    return jnp.zeros(shape + (fe.LIMBS,), dtype=jnp.uint32).at[..., 0].set(1)


def xonly_walk(
    center: PointBatch,
    table_x: jnp.ndarray,
    table_y: jnp.ndarray,
    symmetric: bool = False,
    chain_len: int = 32,
) -> WalkResult:
    """X-coordinates of center_t + u*S (and optionally - u*S).

    center: PointBatch with batch shape (T,). table_x/y: (U, 8) limbs of
    u*S for u = 1..U. Returns (T, U, 8) x-coords. The center itself (u=0)
    is NOT included — engines account for it in their index algebra.
    """
    cx = center.x[:, None, :]  # (T, 1, 8)
    cy = center.y[:, None, :]
    tx = table_x[None, :, :]  # (1, U, 8)
    ty = table_y[None, :, :]

    dx = fe.sub_mod_p(tx, cx)  # (T, U, 8) broadcasts
    degenerate = fe.is_zero(dx)
    dx_safe = fe.select(degenerate, _one_limbs(dx.shape[:-1]), dx)
    inv_dx = fe.batch_inv_mod_p(dx_safe, chain_len=chain_len)

    lam_p = fe.mul_mod_p(fe.sub_mod_p(ty, cy), inv_dx)
    x_base = fe.sub_mod_p(cx, tx)  # note: -(x_c + x_t) staged below
    # x3 = lam^2 - x_c - x_t
    x_plus = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_p), cx), tx)

    x_minus = None
    if symmetric:
        # -uS = (x_t, -y_t): same dx, lambda = (-y_t - y_c) / dx
        lam_m = fe.mul_mod_p(
            fe.neg_mod_p(fe.add_mod_p(ty, cy)), inv_dx
        )
        x_minus = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_m), cx), tx)
    del x_base
    return WalkResult(x_plus, x_minus, degenerate)


class FullWalkResult(NamedTuple):
    x_plus: jnp.ndarray  # (T, U, 8)
    y_plus: jnp.ndarray
    x_minus: jnp.ndarray | None
    y_minus: jnp.ndarray | None
    degenerate: jnp.ndarray  # (T, U) bool


def full_walk(
    center: PointBatch,
    table_x: jnp.ndarray,
    table_y: jnp.ndarray,
    symmetric: bool = False,
    chain_len: int = 32,
) -> FullWalkResult:
    """Group walk producing both coordinates (for keccak/uncompressed
    pipelines that hash x||y). ~2 extra modmuls per point over xonly."""
    cx = center.x[:, None, :]
    cy = center.y[:, None, :]
    tx = table_x[None, :, :]
    ty = table_y[None, :, :]

    dx = fe.sub_mod_p(tx, cx)
    degenerate = fe.is_zero(dx)
    dx_safe = fe.select(degenerate, _one_limbs(dx.shape[:-1]), dx)
    inv_dx = fe.batch_inv_mod_p(dx_safe, chain_len=chain_len)

    lam_p = fe.mul_mod_p(fe.sub_mod_p(ty, cy), inv_dx)
    x_p = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_p), cx), tx)
    y_p = fe.sub_mod_p(fe.mul_mod_p(lam_p, fe.sub_mod_p(cx, x_p)), cy)

    x_m = y_m = None
    if symmetric:
        lam_m = fe.mul_mod_p(fe.neg_mod_p(fe.add_mod_p(ty, cy)), inv_dx)
        x_m = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_m), cx), tx)
        y_m = fe.sub_mod_p(fe.mul_mod_p(lam_m, fe.sub_mod_p(cx, x_m)), cy)
    return FullWalkResult(x_p, y_p, x_m, y_m, degenerate)


def advance(center: PointBatch, step: PointBatch, chain_len: int = 8) -> PointBatch:
    """Full (x and y) add: move every center by the block stride.

    NOTE: prefer walk_fused — a standalone advance pays a full Fermat
    inversion (a 256-step serial ladder) for a tiny batch, which dominates
    the whole device step when T/W is small."""
    return add(center, step, chain_len=chain_len)


class FusedWalkResult(NamedTuple):
    x_plus: jnp.ndarray  # (T, U, 8) x of C_t + u*S, u = 1..U
    x_minus: jnp.ndarray | None  # (T, U, 8) x of C_t - u*S
    y_plus: jnp.ndarray | None  # (T, U, 8) when need_y
    y_minus: jnp.ndarray | None
    degenerate: jnp.ndarray  # (T, U) bool
    adv_x: jnp.ndarray  # (T, 8) x of C_t + ADV
    adv_y: jnp.ndarray  # (T, 8) y of C_t + ADV
    adv_degenerate: jnp.ndarray  # (T,) bool — x(ADV) == x(C_t); adv_* invalid


def walk_fused(
    center: PointBatch,
    table_x: jnp.ndarray,
    table_y: jnp.ndarray,
    adv_x: jnp.ndarray,
    adv_y: jnp.ndarray,
    symmetric: bool = False,
    need_y: bool = False,
    chain_len: int = 32,
) -> FusedWalkResult:
    """Group walk fused with the block advance: ONE batched inversion
    covers all U walk denominators AND the advance denominator.

    This removes the serial Fermat ladder a standalone `advance` pays per
    device step (the reference never hits this because its CPU ModInv is
    cheap relative to its batch; on an accelerator a tiny-batch inversion
    is a long serial ladder that dwarfs the whole walk). adv_x/adv_y: (8,)
    affine coords of the
    advance offset ADV (e.g. U*S for BSGS giant blocks, (2U+1)*stride*G
    for brute windows).

    The advanced point is C_t + ADV with full (x, y) — cost over the walk
    is ~4 extra modmuls per target, not a powering. When C_t == ADV the
    add degenerates into a doubling: the inversion batch carries one more
    denominator (2*y_c) so the doubling formula is applied branch-free
    (lane select). Only C_t == -ADV (result = infinity) remains flagged
    via adv_degenerate — the caller must rebase exactly (it implies the
    target scalar sits on the walk lattice and is found via the walk's own
    degeneracy candidates anyway).
    """
    cx = center.x[:, None, :]  # (T, 1, 8)
    cy = center.y[:, None, :]
    tx = jnp.concatenate([table_x, adv_x[None]], axis=0)[None]  # (1, U+1, 8)
    ty = jnp.concatenate([table_y, adv_y[None]], axis=0)[None]

    dx = fe.sub_mod_p(tx, cx)  # (T, U+1, 8)
    two_cy = fe.double_mod_p(center.y)  # (T, 8); y == 0 impossible (n odd)
    dens = jnp.concatenate([dx, two_cy[:, None, :]], axis=1)  # (T, U+2, 8)
    deg_all = fe.is_zero(dens)
    dens_safe = fe.select(deg_all, _one_limbs(dens.shape[:-1]), dens)
    invs = fe.batch_inv_mod_p(dens_safe, chain_len=chain_len)
    inv_dx = invs[:, :-1]
    inv_2y = invs[:, -1]

    lam_p = fe.mul_mod_p(fe.sub_mod_p(ty, cy), inv_dx)
    x_p = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_p), cx), tx)

    # advance lane: full affine add result
    adv_lam = lam_p[:, -1]
    ax = x_p[:, -1]
    ay = fe.sub_mod_p(
        fe.mul_mod_p(adv_lam, fe.sub_mod_p(center.x, ax)), center.y
    )

    # doubling fallback for C == ADV: lam = 3x^2 / 2y
    adv_dx_zero = deg_all[:, -2]
    cx0, cy0 = center.x, center.y
    sq = fe.sqr_mod_p(cx0)
    lam_d = fe.mul_mod_p(fe.add_mod_p(fe.double_mod_p(sq), sq), inv_2y)
    xd = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_d), cx0), cx0)
    yd = fe.sub_mod_p(fe.mul_mod_p(lam_d, fe.sub_mod_p(cx0, xd)), cy0)
    is_double = adv_dx_zero & fe.eq(cy0, adv_y[None])
    ax = fe.select(is_double, xd, ax)
    ay = fe.select(is_double, yd, ay)

    x_plus = x_p[:, :-1]
    degenerate = deg_all[:, :-2]
    adv_degenerate = adv_dx_zero & ~is_double  # C == -ADV: sum is infinity

    y_plus = y_minus = x_minus = None
    if need_y:
        y_all = fe.sub_mod_p(fe.mul_mod_p(lam_p, fe.sub_mod_p(cx, x_p)), cy)
        y_plus = y_all[:, :-1]
    if symmetric:
        lam_m = fe.mul_mod_p(fe.neg_mod_p(fe.add_mod_p(ty, cy)), inv_dx)
        x_m = fe.sub_mod_p(fe.sub_mod_p(fe.sqr_mod_p(lam_m), cx), tx)
        x_minus = x_m[:, :-1]
        if need_y:
            y_m = fe.sub_mod_p(fe.mul_mod_p(lam_m, fe.sub_mod_p(cx, x_m)), cy)
            y_minus = y_m[:, :-1]

    return FusedWalkResult(
        x_plus, x_minus, y_plus, y_minus, degenerate, ax, ay, adv_degenerate
    )
