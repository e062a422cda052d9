"""BSGS giant-step walk chunk: two CUDA kernels called through the XLA
foreign function interface, and their plain twin.

A chunk walks T targets K steps of U giant steps each: the points
P_t + s*ADV + u*S for s < K, u = 1..U, where ADV = U*S. Only the 64-bit
x truncations (qlo, qhi) and degenerate-lane flags leave the chunk;
membership (bitmap cascade and exact search) stays in XLA.

- **Kernel A — bases.** base(t, s) = P_t + s*ADV for s = 1..K, as K
  independent affine additions against a host table of s*ADV, each lane
  with its own Fermat inversion. There is no serial chain: a chunk's
  K*T bases are parallel lanes, and the last one (s = K) is the next
  chunk's state. A lane where P_t == s*ADV takes the doubling slope
  (the baby-table and filter builds hit it deterministically); a lane
  where P_t == -s*ADV is the point at infinity and is flagged, which
  the engines already treat as an advance degeneracy (exact rescan and
  rebase).
- **Kernel B — walk.** The grid covers all K*T*U additions: one thread
  per table offset u and chain of CHAIN bases runs a Montgomery chain
  over its CHAIN denominators (forward prefix products, ONE addition-
  chain inversion, backward peel fused with the x-only emit), so the
  Fermat ladder costs ~270/CHAIN multiplies per element on top of the
  ~5 the walk needs.

The kernels are CUDA C++ (native/walk_kernels.cu, per-lane math in
native/walk_math.h) with 32-bit limbs and 64-bit products, built with
nvcc on first use. ``impl`` picks the route:
  "cuda"  the GPU kernels;
  "host"  the same C++ per-lane code on the CPU (native library), the
          reference the CPU tests check against ecref;
  "xla"   the same two-stage algorithm as whole-array ops on 16-bit limb
          products (field/fe_tiles.py). It also runs on numpy arrays, as
          a fast exact reference independent of the C++ code.

Reference capability: the giant-step walk of thread_process_bsgs
(keyhunt.cpp:3873-4002).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import device
from ..field import fe_tiles as ft

CHAIN = 64  # bases per Montgomery chain in kernel B (<= 64, the kernel's cap)
IMPLS = ("cuda", "host", "xla")
_BASES, _BLOCKS = "KeyhuntWalkBases", "KeyhuntWalkBlocks"
_registered = False
_register_lock = threading.Lock()


def _register_cuda() -> None:
    """Build native/libkeyhunt_walk.so (first use) and register both
    kernels as XLA FFI targets for the CUDA platform."""
    global _registered
    with _register_lock:
        if _registered:
            return
        from .. import native

        lib = ctypes.cdll.LoadLibrary(native.ensure_built(
            target=native.WALK_LIB, sources=native.WALK_SOURCES,
            make_vars=(f"JAX_INCLUDE={jax.ffi.include_dir()}",),
        ))
        for name in (_BASES, _BLOCKS):
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, name)), platform="CUDA"
            )
        _registered = True


def _cuda_ready() -> None:
    if device.on_gpu():  # off the card only lowering (tests) happens
        _register_cuda()


# ---------------------------------------------------------------------------
# Per-lane math of the twin (native/walk_math.h holds the kernels' copy)
# ---------------------------------------------------------------------------


def add_full(px, py, qx, qy):
    """Affine P + Q with its own inversion -> (x, y, infinity).

    P == Q takes the doubling slope 3x^2 / 2y; P == -Q is the point at
    infinity (flagged; x, y are then meaningless)."""
    dx = ft.sub(qx, px)
    dy = ft.sub(qy, py)
    dx0 = ft.is_zero(dx)
    is_dbl = dx0 & ft.is_zero(dy)
    xx = ft.sqr(px)
    den = ft.select(is_dbl, ft.dbl(py), ft.select(dx0, ft.one_like(dx), dx))
    num = ft.select(is_dbl, ft.add(ft.dbl(xx), xx), dy)
    lam = ft.mul(num, ft.inv(den))
    x3 = ft.sub(ft.sub(ft.sqr(lam), px), qx)
    y3 = ft.sub(ft.mul(lam, ft.sub(px, x3)), py)
    return x3, y3, dx0 & ~is_dbl


def walk_den(tx, bx):
    """Denominator x(uS) - x(base), masked to 1 on degenerate lanes."""
    dx = ft.sub(tx, bx)
    deg = ft.is_zero(dx)
    return ft.select(deg, ft.one_like(dx), dx), deg


def walk_x(tx, ty, bx, by, inv_dx):
    """x of base + uS from the inverted denominator."""
    lam = ft.mul(ft.sub(ty, by), inv_dx)
    return ft.sub(ft.sub(ft.sqr(lam), bx), tx)


# ---------------------------------------------------------------------------
# Kernel A: bases
# ---------------------------------------------------------------------------


def add_lanes(px, py, qx, qy, impl: str):
    """P + Q lane by lane: limb-major (8, n) operands -> (x, y) (8, n) and
    infinity flags (n,)."""
    n = px.shape[1]
    if impl == "xla":
        x3, y3, inf = add_full(ft.limbs(px), ft.limbs(py), ft.limbs(qx),
                               ft.limbs(qy))
        xp = ft.xp(px)
        return xp.stack(x3), xp.stack(y3), inf
    if impl == "host":
        from .. import native

        ox, oy = np.empty((8, n), np.uint32), np.empty((8, n), np.uint32)
        inf = np.empty(n, np.uint8)
        native.require().kh_walk_bases_ref(
            *(_ptr(np.ascontiguousarray(a, np.uint32))
              for a in (px, py, qx, qy)),
            _ptr(ox), _ptr(oy), _ptr(inf), n)
        return ox, oy, inf != 0
    _cuda_ready()
    u32 = jax.ShapeDtypeStruct((8, n), jnp.uint32)
    ox, oy, inf = jax.ffi.ffi_call(
        _BASES, (u32, u32, jax.ShapeDtypeStruct((n,), jnp.uint8))
    )(px, py, qx, qy)
    return ox, oy, inf != 0


# ---------------------------------------------------------------------------
# Kernel B: walk
# ---------------------------------------------------------------------------


def walk_blocks(bx, by, tx, ty, impl: str):
    """bases (8, nb), table (8, u) limb-major -> qlo, qhi, deg (nb, u)."""
    nb, u = bx.shape[1], tx.shape[1]
    chain = _pow2_divisor(nb, CHAIN)
    if impl == "xla":
        return _walk_blocks_xla(bx, by, tx, ty, chain)
    if impl == "host":
        from .. import native

        qlo, qhi = np.empty((nb, u), np.uint32), np.empty((nb, u), np.uint32)
        deg = np.empty((nb, u), np.uint8)
        rc = native.require().kh_walk_blocks_ref(
            *(_ptr(np.ascontiguousarray(a, np.uint32))
              for a in (bx, by, tx, ty)),
            _ptr(qlo), _ptr(qhi), _ptr(deg), nb, u, chain)
        if rc != 0:
            raise ValueError(f"kh_walk_blocks_ref rejected chain={chain}")
        return qlo, qhi, deg != 0
    _cuda_ready()
    u32 = jax.ShapeDtypeStruct((nb, u), jnp.uint32)
    qlo, qhi, deg = jax.ffi.ffi_call(
        _BLOCKS, (u32, u32, jax.ShapeDtypeStruct((nb, u), jnp.uint8))
    )(bx, by, tx, ty, chain=np.int64(chain))
    return qlo, qhi, deg != 0


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _walk_blocks_xla(bx, by, tx, ty, chain: int):
    """Kernel B's algorithm over whole arrays: chains run along the base
    axis in groups of `chain`, exactly as the kernel's threads do."""
    nb, u = bx.shape[1], tx.shape[1]
    shape = (chain, nb // chain, u)
    xp = ft.xp(bx)

    def bases(a):  # (8, nb) -> limbs (chain, nb/chain, u), b = c*chain + g
        a = a.reshape(8, nb // chain, chain).transpose(0, 2, 1)[..., None]
        return tuple(xp.broadcast_to(a[k], shape) for k in range(8))

    def table(a):
        return tuple(xp.broadcast_to(a[k], shape) for k in range(8))

    txl, tyl, bxl, byl = table(tx), table(ty), bases(bx), bases(by)
    dx, deg = walk_den(txl, bxl)
    x3 = walk_x(txl, tyl, bxl, byl, ft.chain_inverse(dx))

    def rows(a):  # (chain, nb/chain, u) -> (nb, u)
        return a.transpose(1, 0, 2).reshape(nb, u)

    return rows(x3[0]), rows(x3[1]), rows(deg)


# ---------------------------------------------------------------------------
# Chunk: both kernels + layout glue
# ---------------------------------------------------------------------------


class WalkChunk(NamedTuple):
    next_x: jnp.ndarray  # (T, 8) uint32 limbs: P_t + K*ADV
    next_y: jnp.ndarray
    qhi: jnp.ndarray  # (T*K, U) uint32, row = t*K + s
    qlo: jnp.ndarray
    degenerate: jnp.ndarray  # (T*K, U) bool
    adv_degenerate: jnp.ndarray  # (T, K) bool: P_t + (s+1)*ADV is infinity


def walk_chunk(px, py, tab_x, tab_y, adv_x, adv_y, *, impl: str
               ) -> WalkChunk:
    """px/py: (T, 8) batch-major walk bases. tab_*: (8, U) limb-major
    offsets u*S, u = 1..U. adv_*: (8, K) limb-major s*ADV, s = 1..K."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    T, K, U = px.shape[0], adv_x.shape[1], tab_x.shape[1]
    xp = ft.xp(px)
    rep = lambda p: xp.broadcast_to(p.T[:, :, None], (8, T, K)).reshape(8, -1)
    til = lambda a: xp.broadcast_to(a[:, None, :], (8, T, K)).reshape(8, -1)
    qx, qy, inf = add_lanes(rep(px), rep(py), til(adv_x), til(adv_y), impl)
    qx, qy = qx.reshape(8, T, K), qy.reshape(8, T, K)
    # base(t, 0) = P_t; base(t, s) = P_t + s*ADV = q(t, s-1)
    bx = xp.concatenate([px.T[:, :, None], qx[:, :, : K - 1]], axis=2)
    by = xp.concatenate([py.T[:, :, None], qy[:, :, : K - 1]], axis=2)
    qlo, qhi, deg = walk_blocks(bx.reshape(8, -1), by.reshape(8, -1),
                                tab_x, tab_y, impl)
    return WalkChunk(qx[:, :, K - 1].T, qy[:, :, K - 1].T, qhi, qlo, deg,
                     inf.reshape(T, K))


def limb_major(tab_bm) -> jnp.ndarray:
    """(n, 8) host batch-major table -> (8, n) device limb-major."""
    return jnp.asarray(np.ascontiguousarray(np.asarray(tab_bm).T))


def _pow2_divisor(n: int, cap: int) -> int:
    """Largest power of two <= cap dividing n."""
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d
