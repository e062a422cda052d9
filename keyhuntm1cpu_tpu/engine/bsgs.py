"""Baby-Step Giant-Step engine.

Index algebra (re-derived from scratch; capability of reference
keyhunt.cpp:962-2093 setup + :3778-4368 search/verification):

- stride = 2m. Centers c_i = a + m + i*stride tile the range [a, b).
- Baby table: 64-bit-truncated x(j*G) for j = 1..m, payload j, in a
  sorted device table (filter/sorted_table.py) — replacing the
  reference's 3-bloom cascade + 6-byte bPtable with one exact structure.
- Giant walk: P(t, i) = Q_t - c_i*G. A device step walks U consecutive
  centers for all T targets at once via the X-only group walk with the
  offset table tab[u] = u * S, S = -(stride)*G:
      P_base(s) = Q_t - (c_{sU} - stride)*G;  P_base + u*S = P(t, sU+u-1)
  then advances P_base by U*S. K steps run inside one jitted lax.scan
  chunk; only (K, T)-shaped hit summaries return to the host.
- Hit at (t, s, u) with baby index j means x(P) == x(j*G), i.e.
  k = c +- j (X-only match covers both signs; the reference handles the
  same +-j duality at keyhunt.cpp:4330-4363). The host verifies both
  candidates exactly (ref/ecref) before reporting.
- Degenerate walk lanes (dx == 0) mean P_base = -+u*S, i.e. the solution
  IS the center: k = c_base +- u*stride; host-verified the same way.

Every giant step covers `stride` keys, so keys/s = steps/s * U * stride.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import device
from ..curve import points, pwalk, tables, walk
from ..field import fe
from ..filter import bitmap as bmp
from ..filter import sorted_table as st
from ..ref import ecref
from .common import Deadline, FoundKey, SearchStats, verify_candidate_scalar


def resolve_m(
    m_babies: "int | None" = None,
    n_value: "int | None" = None,
    k_factor: int = 1,
) -> int:
    """Reference BSGS table sizing (keyhunt.cpp:1052-1161): m = sqrt(N)*k,
    N defaulting to 0x100000000000 (sqrt = 2^22) and required to have an
    exact integer square root (keyhunt.cpp:1069-1076). An explicit
    m_babies overrides -n/-k. Shared by the CLI, bsgsd, and the dist
    entry points so every surface sizes identically."""
    if m_babies is not None:
        return m_babies
    n_val = n_value if n_value is not None else (1 << 44)
    r = math.isqrt(n_val)
    if r * r != n_val:
        raise ValueError(
            f"-n value 0x{n_val:x} must have an exact integer square root"
        )
    return r * max(1, k_factor)


@dataclass(frozen=True)
class BSGSParams:
    m: int = 1 << 20  # baby steps
    block_u: int = 1024  # giant centers per device step (U)
    steps_per_chunk: int = 16  # K: device steps per jit call
    build_block: int = 4096  # baby points per build step
    chain_len: int = 32  # batch-inverse chain length
    cand_max: int = 256  # compacted survivors per device step (bitmap
    # cascade, filter/bitmap.py); overflow falls back to exact host rescan
    bits_log2: Optional[int] = None  # bitmap size (None = log2(m) + 12)
    chunk_cand_max: int = 1024  # chunk-level compacted survivors
    # (the walk-kernel path compacts once per chunk, not per step)
    probe_mode: "str | None" = None  # bitmap-gather strategy (filter/
    # bitmap.py probe: elem | sorted | row128; None = the module default
    # DEFAULT_PROBE_MODE)
    cascade2: str = "auto"  # level-2 hashed bloom between the bitmap
    # and the exact search (filter/bitmap.py DeviceBloom2). "auto" =
    # only when expected level-1 survivors/chunk > 1024 (large m at the
    # capped bitmap size, where the wide exact search dominates chunk
    # time); "on"/"off" force.
    table_comm: str = "all_gather"  # sharded-TABLE membership schedule:
    # "all_gather" = one fused collective, every device probes D*T*U
    # queries; "ring" = D ppermute hops, each device probes T*U per hop
    # with the NEXT block's transfer overlapping the probe and 1/D the
    # peak query memory (reference's 256-way first-byte bloom sharding,
    # keyhunt.cpp:3946, spread over the devices).
    pipeline_depth: int = 8  # chunks dispatched ahead of decode, so the
    # host's summary pull and decode overlap device compute
    resolve: str = "device"  # exact-resolution placement:
    # "device" = sorted table in device memory (12 B/key);
    # "host"   = device keeps ONLY bitmap + bloom2, survivors' 64-bit
    # keys return in the chunk summary and the host resolves baby
    # indices via np.searchsorted over filter/host_table.py (the native
    # C++-built, disk-cached table). Device memory then holds only the
    # two filters, so m can grow: keys/s = probe_rate * 2m, and after
    # the cascade survivors are ~10^2-10^4 per multi-million-query
    # chunk — trivially host work. Reference analog: the 3-level bloom
    # cascade's exact bPtable level (keyhunt.cpp:1215-1304, 3748-3775),
    # moved off-accelerator.
    bloom2_bits: Optional[int] = None  # host-resolve bloom2 size override
    table_cache: Optional[str] = None  # host-table cache dir override


import threading as _threading
from collections import OrderedDict as _OrderedDict

_BLOOM2_CACHE: "_OrderedDict[int, tuple]" = _OrderedDict()
_BLOOM2_LOCK = _threading.Lock()


def _bloom2_for_table(hi, lo):
    """Memoized level-2 bloom per table array: bsgsd constructs one
    engine PER REQUEST over a shared resident table, and the bloom2
    build is a 2m-element device sort — seconds at production m. The
    cache holds a strong ref to the key array, so its id cannot be
    reused while the entry lives (identity check included regardless).
    Locked: bsgsd handler THREADS construct engines concurrently, and
    get/move_to_end/insert/evict are not atomic compounds."""
    from ..filter import bitmap as bmp

    k = id(hi)
    with _BLOOM2_LOCK:
        ent = _BLOOM2_CACHE.get(k)
        if ent is not None and ent[0] is hi:
            _BLOOM2_CACHE.move_to_end(k)  # LRU, not FIFO: the resident
            return ent[1]  # table must never be evicted by stale ones
    b2 = bmp.build_bloom2_device(hi, lo)
    with _BLOOM2_LOCK:
        _BLOOM2_CACHE[k] = (hi, b2)
        while len(_BLOOM2_CACHE) > 2:  # each entry pins hi (~1 GB at
            _BLOOM2_CACHE.popitem(last=False)  # 2^28) + 512 MB bloom
    return b2


def _debug_sync(label: str, arr) -> None:
    """KEYHUNT_BUILD_DEBUG=1: sync on one element and timestamp a build
    phase (attributes boot time between kernels, sort and scatter)."""
    if os.environ.get("KEYHUNT_BUILD_DEBUG"):
        np.asarray(arr[:1])
        print(f"[build] {label} t={time.time():.1f}", flush=True)


# Largest T*K*U (query words) one walk-kernel chunk may hold: its query,
# flag and compaction arrays take tens of bytes per word of device memory.
CHUNK_WORD_CAP = 1 << 27


class BSGSEngine:
    """Single-host BSGS search over one device (sharding in parallel/)."""

    def __init__(
        self,
        pubkeys: Sequence[Tuple[int, int]],
        range_start: int,
        range_end: int,
        params: BSGSParams = BSGSParams(),
        table: Optional[st.SortedXTable] = None,
        bitmap: Optional[bmp.DeviceBitmap] = None,
        host_table=None,
        bloom2: Optional[bmp.DeviceBloom2] = None,
    ):
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        if params.resolve not in ("device", "host"):
            raise ValueError("resolve must be 'device' or 'host'")
        self.targets = list(pubkeys)
        self.a = range_start
        self.b = range_end
        self.p = params
        self.stats = SearchStats()

        m = params.m
        self.stride = 2 * m
        n_centers = max(1, math.ceil((self.b - self.a) / self.stride))
        self.n_steps = math.ceil(n_centers / params.block_u)

        # --- device constants -------------------------------------------
        stride_pt = ecref.scalar_mult(self.stride)
        s_pt = ecref.point_neg(stride_pt)  # S = -(stride)*G
        tab_x, tab_y = tables.step_table(s_pt, params.block_u)
        self.tab_x = jnp.asarray(tab_x)
        self.tab_y = jnp.asarray(tab_y)
        big = ecref.scalar_mult(params.block_u * self.stride)
        big = ecref.point_neg(big)  # U*S — the advance offset
        self.adv_x = fe.from_int(big[0])
        self.adv_y = fe.from_int(big[1])

        self.table: Optional[st.SortedXTable] = None
        self.host_table = None
        self._bloom2: Optional[bmp.DeviceBloom2] = None
        if params.resolve == "host":
            from ..filter import host_table as ht

            cache_kw = ({"cache_dir": params.table_cache}
                        if params.table_cache else {})
            self.host_table = (host_table if host_table is not None
                               else ht.ensure_host_table(m, **cache_kw))
            if self.host_table.m != m:
                raise ValueError(
                    f"host table m={self.host_table.m} != params.m={m}"
                )
            if bitmap is not None and bloom2 is not None:
                self.bitmap, self._bloom2 = bitmap, bloom2
            elif not self._can_stream_build():
                b2bits = (params.bloom2_bits
                          if params.bloom2_bits is not None
                          else bmp.bloom2_bits_log2_host(m))
                # small-m / CPU path: derive the filters from the host
                # planes with numpy (the streaming device build needs the
                # walk kernels)
                keys = np.asarray(self.host_table.keys)
                hi = (keys >> np.uint64(32)).astype(np.uint32)
                lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                self.bitmap = bmp.build_bitmap(
                    hi, lo, params.bits_log2, on_device=device.on_gpu(),
                )
                self._bloom2 = bmp.build_bloom2_host(hi, lo, b2bits)
            else:
                # fixed b2=35 (4 GiB, load 1/8 even at m=2^31 -> fp
                # ~1.4e-2) on the streaming path: the stream impl's
                # compile is keyed on (bits, b2) — see _filters_stream_impl
                self.bitmap, self._bloom2 = self._build_filters_streaming(
                    params.bloom2_bits if params.bloom2_bits is not None
                    else 35
                )
            _debug_sync("filters done", self.bitmap.words)
        else:
            self.table = table if table is not None else self.build_baby_table()
            # the bitmap is shareable across engines over the same table
            # (512 MB at the default sizing — build once, pass around).
            # Derived from the device-resident table planes: no host round
            # trip even when the table came from an npz cache (it was just
            # uploaded).
            self.bitmap = bitmap if bitmap is not None else bmp.build_bitmap_device(
                self.table.hi, self.table.lo, params.bits_log2
            )
            _debug_sync("bitmap done", self.bitmap.words)
        self._host_keys = None  # (sorted packed u64, payload, j_offset)
        self._chunk_fn = self._make_chunk_fn()

    # ------------------------------------------------------------------
    # baby table
    # ------------------------------------------------------------------

    def build_baby_table(self, progress: bool = False) -> st.SortedXTable:
        """Device-built baby table: x(j*G), j = 1..m.

        Block t >= 1 walks (t*Ub)*G + u*G for u = 1..Ub; block 0 is the
        host-precomputed u*G offset table itself (reference analog:
        thread_bPload, keyhunt.cpp:4404-4592, without the mutex farm —
        blocks are disjoint by construction).
        """
        p = self.p
        if device.on_gpu() and p.m > p.build_block:
            return self._build_baby_table_kernel()
        ub = p.build_block
        n_blocks = math.ceil(p.m / ub)
        btab_x, btab_y = tables.step_table(ecref.G, ub)
        jbtab_x, jbtab_y = jnp.asarray(btab_x), jnp.asarray(btab_y)

        @jax.jit
        def build_all(cx, cy):
            """lax.scan over all blocks on-device; ONE host transfer at the
            end. The block advance (+ub*G) is fused into the walk's
            batched inversion — the first block's advance is the doubling
            ub*G + ub*G, handled by walk_fused's branch-free doubling
            lane."""

            def body(carry, _):
                cx, cy = carry
                c = points.PointBatch(cx, cy, jnp.zeros(cx.shape[:-1], dtype=bool))
                res = walk.walk_fused(
                    c, jbtab_x, jbtab_y, jbtab_x[-1], jbtab_y[-1],
                    chain_len=p.chain_len,
                )
                qhi, qlo = st.trunc64_from_limbs(res.x_plus)
                return (res.adv_x, res.adv_y), (qhi[0], qlo[0], res.degenerate[0])

            (_, _), outs = jax.lax.scan(body, (cx, cy), None, length=n_blocks - 1)
            return outs  # (n_blocks-1, ub) x3

        his = np.empty(n_blocks * ub, dtype=np.uint32)
        los = np.empty(n_blocks * ub, dtype=np.uint32)
        idxs = (np.arange(n_blocks * ub, dtype=np.uint64) + 1).astype(np.uint32)

        # block 0 straight from the host table
        his[:ub] = btab_x[:, 1]
        los[:ub] = btab_x[:, 0]

        if n_blocks > 1:
            cur = points.point_batch_from_ints([ecref.scalar_mult(ub)])
            qhi, qlo, deg = build_all(cur.x, cur.y)
            his[ub:] = np.asarray(qhi).reshape(-1)
            los[ub:] = np.asarray(qlo).reshape(-1)
            degn = np.asarray(deg).reshape(-1)
            for flat in np.nonzero(degn)[0]:
                # patch degenerate lanes exactly (e.g. block 1 u=Ub is the
                # doubling case (Ub)*G + (Ub)*G)
                j = ub + int(flat) + 1
                x = ecref.scalar_mult(j)[0]
                his[ub + int(flat)] = (x >> 32) & 0xFFFFFFFF
                los[ub + int(flat)] = x & 0xFFFFFFFF

        return st.build_sorted_table(his[: p.m], los[: p.m], idxs[: p.m])

    def _build_baby_table_kernel(self) -> st.SortedXTable:
        """Baby-table build on the walk kernels: blocks 1..n-1 walk from
        base Ub*G with ADV = Ub*G (kernel A's doubling slope handles the
        block-1 case Ub*G + Ub*G), in chunks of K blocks."""
        p = self.p
        ub = p.build_block
        n_blocks = math.ceil(p.m / ub)
        btab_x, btab_y = tables.step_table(ecref.G, ub)
        tx = pwalk.limb_major(btab_x)
        ty = pwalk.limb_major(btab_y)
        kmax = 128  # blocks per scan iteration
        adv = ecref.scalar_mult(ub)
        ax, ay = (pwalk.limb_major(a) for a in tables.step_table(adv, kmax))

        base = ecref.scalar_mult(ub)
        px = jnp.asarray(fe.int_to_limbs(base[0]))[None]
        py = jnp.asarray(fe.int_to_limbs(base[1]))[None]
        # Device-resident build in ONE dispatch: a lax.scan over chunk
        # iterations (each a K-block walk-kernel call), exactly like the
        # search chunk fn; ONE pull of the per-chunk degeneracy counts
        # after the scan. Block 0 is the host step table (ub * 4 B); the
        # sort is a device lax.sort.
        chunks_hi: List[jnp.ndarray] = [jnp.asarray(btab_x[:, 1])]
        chunks_lo: List[jnp.ndarray] = [jnp.asarray(btab_x[:, 0])]
        metas: List[Tuple[int, int]] = []  # (first block, k) per chunk
        deg_stacks: List[jnp.ndarray] = []  # (n_i, k_i, ub) bool per call
        dcount_parts: List[jnp.ndarray] = []
        adv_parts: List[jnp.ndarray] = []

        n_rem = n_blocks - 1
        n_iter = n_rem // kmax
        if n_iter:
            sc = _build_scan_impl(px, py, tx, ty, ax, ay, n_iter=n_iter)
            px, py = sc.next_x, sc.next_y
            chunks_hi.append(sc.qhi.reshape(-1))
            chunks_lo.append(sc.qlo.reshape(-1))
            deg_stacks.append(sc.degenerate)
            dcount_parts.append(sc.dcount)
            adv_parts.append(sc.adv_any[None])
            metas.extend((1 + i * kmax, kmax) for i in range(n_iter))
        rem = n_rem - n_iter * kmax
        if rem:
            res = _build_chunk_impl(px, py, tx, ty, ax[:, :rem], ay[:, :rem])
            chunks_hi.append(res.qhi[:rem].reshape(-1))
            chunks_lo.append(res.qlo[:rem].reshape(-1))
            deg_stacks.append(res.degenerate[None])
            dcount_parts.append(res.degenerate.sum(dtype=jnp.int32)[None])
            adv_parts.append(res.adv_degenerate.any()[None])
            metas.append((1 + n_iter * kmax, rem))

        patches: List[Tuple[int, int]] = []  # (flat j-1, exact x)
        if metas:
            dcounts = np.asarray(jnp.concatenate(dcount_parts))
            assert not bool(np.asarray(jnp.concatenate(adv_parts).any())), (
                "advance chain hit infinity during table build"
            )
            flat_i = 0
            for stack in deg_stacks:
                for row in range(stack.shape[0]):
                    done_, k_ = metas[flat_i]
                    if int(dcounts[flat_i]) > 0:
                        # walk-lane degeneracies (e.g. the doubling lane
                        # of block 1 at u = Ub) are rare: pull only the
                        # affected chunk's mask and patch exactly
                        deg = np.asarray(stack[row])[:k_].reshape(k_, ub)
                        for s, u0 in zip(*np.nonzero(deg)):
                            j = (done_ + int(s)) * ub + int(u0) + 1
                            patches.append((j - 1, ecref.scalar_mult(j)[0]))
                    flat_i += 1
        del deg_stacks, dcount_parts, adv_parts

        _debug_sync("chunks done", chunks_hi[-1])
        his = jnp.concatenate(chunks_hi)[: p.m]
        los = jnp.concatenate(chunks_lo)[: p.m]
        del chunks_hi, chunks_lo
        _debug_sync("concat done", his)
        if patches:
            pos = np.fromiter((q for q, _ in patches), dtype=np.int32)
            xs = [x for _, x in patches]
            phi = np.array([(x >> 32) & 0xFFFFFFFF for x in xs], dtype=np.uint32)
            plo = np.array([x & 0xFFFFFFFF for x in xs], dtype=np.uint32)
            keep = pos < p.m
            his = his.at[pos[keep]].set(phi[keep])
            los = los.at[pos[keep]].set(plo[keep])
        idxs = (jnp.arange(p.m, dtype=jnp.uint32) + jnp.uint32(1))
        tab = st.build_sorted_table_device(his, los, idxs)
        _debug_sync("sort done", tab.hi)
        return tab

    # ------------------------------------------------------------------
    # streaming filter build (host-resolve mode: NO device table)
    # ------------------------------------------------------------------

    def _can_stream_build(self) -> bool:
        p = self.p
        ub = p.build_block
        return device.on_gpu() and p.m % ub == 0 and p.m // ub >= 4

    def _build_filters_streaming(
        self, b2bits: int
    ) -> Tuple[bmp.DeviceBitmap, bmp.DeviceBloom2]:
        """Bitmap + bloom2 built by a jitted loop that carries the word
        arrays and the walk state — peak device memory = the two filters
        plus per-iteration transients (no m-sized planes, no device sort,
        no idx plane).

        Walk layout: keys j = 1..2*Ub are seeded from the native exact
        walk (host); the device loop walks blocks t = 2.. from base
        (2*Ub)*G, which is degeneracy-free (a walk lane needs
        t*Ub == +-u for u <= Ub, impossible at t >= 2; a base needs
        (2 + s)*Ub == 0 mod n, impossible; base 2*Ub*G + 2*Ub*G takes
        kernel A's doubling slope) — asserted post-hoc."""
        from ..filter import host_table as ht

        p = self.p
        m = p.m
        if m > (1 << 31):
            raise ValueError("streaming filter build supports m <= 2^31")
        ub = p.build_block
        # fixed production filter sizes: the stream impl's compile is
        # shape-keyed, and bits/b2 are its only m-dependent statics —
        # pinning them makes ONE compile serve every m (m itself and the
        # iteration count are runtime values)
        bits_log2 = p.bits_log2 if p.bits_log2 is not None else 35
        n_words1 = 1 << (bits_log2 - 5)
        n_words2 = 1 << (b2bits - 5)

        # host seed: j = 1..2*Ub exact truncations -> initial word arrays
        seed = ht.native_keys_range(1, 2 * ub)
        shi = (seed >> np.uint64(32)).astype(np.uint32)
        slo = (seed & np.uint64(0xFFFFFFFF)).astype(np.uint32)

        def host_or(word: np.ndarray, val: np.ndarray, n_words: int):
            uw, inv = np.unique(word, return_inverse=True)
            vals = np.zeros(len(uw), dtype=np.uint32)
            np.bitwise_or.at(vals, inv, val)
            assert uw.min() >= 0 and uw.max() < n_words
            return jnp.asarray(uw.astype(np.int32)), jnp.asarray(vals)

        idx1 = bmp._bit_indices(shi, slo, bits_log2)
        w1, v1 = host_or(
            (idx1 >> np.uint64(5)).astype(np.int64),
            np.uint32(1) << (idx1 & np.uint64(31)).astype(np.uint32),
            n_words1,
        )
        word2, val2 = bmp.bloom2_word_bit_np(shi, slo, b2bits)
        w2, v2 = host_or(word2, val2, n_words2)
        words1 = _seed_words(w1, v1, n_words=n_words1)
        words2 = _seed_words(w2, v2, n_words=n_words2)

        # walk constants: offset table u*G (u = 1..Ub), advances s*Ub*G
        kmax = 128  # blocks per loop iteration
        btab_x, btab_y = tables.step_table(ecref.G, ub)
        tx = pwalk.limb_major(btab_x)
        ty = pwalk.limb_major(btab_y)
        adv = ecref.scalar_mult(ub)
        ax, ay = (pwalk.limb_major(a) for a in tables.step_table(adv, kmax))
        base = ecref.scalar_mult(2 * ub)
        px = jnp.asarray(fe.int_to_limbs(base[0]))[None]
        py = jnp.asarray(fe.int_to_limbs(base[1]))[None]

        blocks = m // ub - 2
        n_iter = -(-blocks // kmax)
        # Bounded dispatch slices: a host loop re-entering the SAME
        # compiled executable (it0 is a runtime value; words are donated,
        # so buffers are reused in place) keeps each dispatch short, with
        # one sync and one progress line per slice.
        slice_iters = 256
        done = 0
        while done < n_iter:
            step = min(slice_iters, n_iter - done)
            t0 = time.time()
            words1, words2, px, py, dc, adv_any = _filters_stream_impl(
                px, py, tx, ty, ax, ay, words1, words2,
                jnp.int32(step), jnp.int32(done), jnp.uint32(m),
                bits_log2=bits_log2, b2_bits=b2bits,
            )
            assert int(np.asarray(dc)) == 0, (
                "degenerate walk lane in the streaming filter build "
                "(impossible for base >= 2*Ub*G)"
            )
            assert not bool(np.asarray(adv_any))
            done += step
            if os.environ.get("KEYHUNT_BUILD_DEBUG") or n_iter > slice_iters:
                print(
                    f"[build] filter stream {done}/{n_iter} iters "
                    f"({time.time() - t0:.1f}s/slice)",
                    flush=True,
                )
        _debug_sync("filters stream done", words1)
        return (bmp.DeviceBitmap(words1, bits_log2),
                bmp.DeviceBloom2(words2, b2bits))

    # ------------------------------------------------------------------
    # table persistence (reference -S files, keyhunt.cpp:1373-2025)
    # ------------------------------------------------------------------

    def save_table(self, path: str) -> None:
        if self.table is None:
            raise ValueError(
                "host-resolve engines have no device table; the host "
                "table is disk-cached by filter/host_table.py already"
            )
        t = self.table
        arr_hi, arr_lo, arr_idx = (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.idx))
        digest = hashlib.sha256(
            arr_hi.tobytes() + arr_lo.tobytes() + arr_idx.tobytes()
        ).digest()
        np.savez(
            path,
            version=np.int64(1),
            m=np.int64(self.p.m),
            hi=arr_hi,
            lo=arr_lo,
            idx=arr_idx,
            checksum=np.frombuffer(digest, dtype=np.uint8),
        )

    @staticmethod
    def load_table(path: str, verify_checksum: bool = True) -> st.SortedXTable:
        with np.load(path) as z:
            if int(z["version"]) != 1:
                raise ValueError("unsupported table version")
            hi, lo, idx = z["hi"], z["lo"], z["idx"]
            if verify_checksum:
                digest = hashlib.sha256(
                    hi.tobytes() + lo.tobytes() + idx.tobytes()
                ).digest()
                if digest != z["checksum"].tobytes():
                    raise ValueError("baby table checksum mismatch")
            return st.SortedXTable(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx))

    # ------------------------------------------------------------------
    # giant-step search
    # ------------------------------------------------------------------

    def _initial_base(self, step0: int = 0) -> points.PointBatch:
        """P_base(s=step0) per target (host-exact)."""
        c_base = self.a + self.p.m + (step0 * self.p.block_u - 1) * self.stride
        neg = (-c_base) % ecref.N
        offset = ecref.scalar_mult(neg)
        pts = [ecref.point_add(q, offset) for q in self.targets]
        if any(pt is None for pt in pts):
            # Q == c_base*G: the solution is exactly the initial base center
            raise _ImmediateHit(c_base)
        return points.point_batch_from_ints(pts)

    def _use_kernel(self) -> bool:
        """The walk kernels run on the GPU whenever one step's T*U query
        words fit a chunk; the CPU (and larger T*U) take the XLA
        walk_fused scan."""
        if not device.on_gpu():
            return False
        ok = len(self.targets) * self.p.block_u <= CHUNK_WORD_CAP
        if not ok:
            from ..core.log import get_logger

            get_logger().warn(
                f"BSGS walk kernels need T*block_u <= {CHUNK_WORD_CAP}: "
                "running the XLA walk instead"
            )
        return ok

    def _cascade_budgets(self, n_queries: int) -> Tuple[int, int]:
        """(C1, C2) compaction budgets for `n_queries` per cascade pass
        in host-resolve mode. Stage-1 expected survivors = B * m / 2^bits
        (direct-address fp); stage-2 = stage-1 * bloom2_fp. Budgets are
        mean + 8*sqrt(mean) + 512 rounded to 512 (P(overflow) ~ 0 in the
        CLT regime; overflow itself is safe — exact host rescan)."""
        p = self.p
        bits = self.bitmap.bits_log2
        expected = max(1, n_queries * p.m // (1 << bits))

        def budget(mean: int) -> int:
            need = mean + 8 * int(mean ** 0.5) + 512
            return ((need + 511) // 512) * 512

        C1 = max(p.chunk_cand_max, budget(expected))
        fp2 = bmp.bloom2_fp(p.m, self._bloom2.bits_log2)
        C2 = max(p.chunk_cand_max, budget(int(expected * fp2) + 1))
        return C1, C2

    def _make_chunk_fn(self):
        if self.host_table is not None:
            if self._use_kernel():
                return self._make_kernel_chunk_fn_host()
            return self._make_xla_chunk_fn_host()
        if self._use_kernel():
            return self._make_kernel_chunk_fn()
        self._summary_kind = "steps"
        T = len(self.targets)
        U = self.p.block_u
        K = self.p.steps_per_chunk
        C = self.p.cand_max
        chain = self.p.chain_len
        bits_log2 = self.bitmap.bits_log2
        # level-2 cascade (same sizing rationale as the kernel path —
        # per-STEP widths here, so the threshold is per T*U queries)
        expected = T * U * self.p.m // (1 << bits_log2)
        use2 = (self.p.cascade2 == "on"
                or (self.p.cascade2 == "auto" and expected > 1024))
        if use2:
            self._bloom2 = _bloom2_for_table(self.table.hi,
                                             self.table.lo)
            C1 = max(C, ((expected + 8 * int(expected ** 0.5) + 511)
                         // 512) * 512)
        else:
            self._bloom2 = None
            C1 = None
        b2 = self._bloom2

        def chunk(px, py):
            return _xla_chunk_impl(
                px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
                self.bitmap.words, self.table.hi, self.table.lo, self.table.idx,
                b2.words if b2 is not None else None,
                T=T, U=U, K=K, C=C, chain=chain, bits_log2=bits_log2,
                probe_mode=self.p.probe_mode,
                b2_bits=b2.bits_log2 if b2 is not None else 0,
                C1=C1,
            )

        return chunk

    def _kernel_setup(self) -> Tuple[int, int, int]:
        """(T, K, U) for the walk-kernel chunk, shrinking K so a chunk's
        query arrays stay within CHUNK_WORD_CAP words (the search loop
        reads steps_per_chunk from self.p, so it is replaced there), plus
        the kernels' limb-major tables: offsets u*S and advances s*ADV."""
        import dataclasses

        U = self.p.block_u
        K = self.p.steps_per_chunk
        T = len(self.targets)
        if T * K * U > CHUNK_WORD_CAP:
            k_new = max(1, CHUNK_WORD_CAP // (T * U))
            from ..core.log import get_logger

            get_logger().warn(
                f"multi-target chunk would need {T}*{K}*{U} query "
                f"words; shrinking steps_per_chunk {K} -> {k_new} to "
                "bound device memory"
            )
            self.p = dataclasses.replace(self.p, steps_per_chunk=k_new)
            K = k_new
        self._tab_x_lm = jnp.transpose(self.tab_x)
        self._tab_y_lm = jnp.transpose(self.tab_y)
        big = ecref.point_neg(ecref.scalar_mult(U * self.stride))  # U*S
        self._adv_x_lm, self._adv_y_lm = (
            pwalk.limb_major(a) for a in tables.step_table(big, K)
        )
        return T, K, U

    def _make_kernel_chunk_fn(self, impl: str = "cuda"):
        """Walk-kernel chunk (curve/pwalk.py): K*T bases and the K*T*U walk
        in two kernels, bitmap cascade in XLA. T targets share one call —
        the reference's per-pubkey hot loop (keyhunt.cpp:3859-3869) as
        one grid. `impl` names the walk route (pwalk.IMPLS)."""
        T, K, U = self._kernel_setup()
        bits_log2 = self.bitmap.bits_log2
        # Chunk compaction budget vs expected bitmap survivors
        # (fp = m/2^bits). The exact lookup runs C2 lanes of ~29
        # dependent gather rounds regardless of the true survivor count,
        # so C2 slack is wasted chunk time. In the CLT regime
        # mean + 8*sqrt(mean) + 512 has P(overflow) ~ 1e-50 per chunk,
        # and overflow itself is safe anyway (the engine falls back to
        # an exact host rescan of the chunk).
        expected = T * K * U * self.p.m // (1 << bits_log2)
        need = (expected + 8 * int(expected ** 0.5) + 512
                if expected >= 4096 else 4 * expected)
        C1 = max(self.p.chunk_cand_max, ((need + 511) // 512) * 512)
        # level-2 cascade: when level-1 survivors outgrow the exact
        # search's useful width (large m at the capped bitmap), insert
        # the hashed bloom (fp ~1.4e-2 at 2m bytes) so the 29-round
        # search runs at ~C1/70 width instead of C1
        use2 = (self.p.cascade2 == "on"
                or (self.p.cascade2 == "auto" and expected > 1024))
        if use2:
            self._bloom2 = _bloom2_for_table(self.table.hi,
                                             self.table.lo)
            exp2 = max(64, expected // 32)  # fp<=1/64 + slack
            C2 = max(self.p.chunk_cand_max,
                     ((exp2 + 8 * int(exp2 ** 0.5) + 511) // 512) * 512)
        else:
            self._bloom2 = None
            C2 = C1
        self._chunk_cand_eff = C2
        self._summary_kind = "chunk"
        b2 = self._bloom2

        def chunk(px, py):
            return _kernel_chunk_impl(
                px, py, self._tab_x_lm, self._tab_y_lm,
                self._adv_x_lm, self._adv_y_lm,
                self.bitmap.words, self.table.hi, self.table.lo, self.table.idx,
                b2.words if b2 is not None else None,
                C2=C2, bits_log2=bits_log2,
                probe_mode=self.p.probe_mode,
                b2_bits=b2.bits_log2 if b2 is not None else 0,
                C1=C1, impl=impl,
            )

        return chunk

    def _make_kernel_chunk_fn_host(self, impl: str = "cuda"):
        """Walk-kernel chunk, host-resolve: identical walk + cascade,
        but NO device exact search — the C2 survivors' truncated keys
        come back in the summary for np.searchsorted resolution against
        the host table."""
        T, K, U = self._kernel_setup()
        C1, C2 = self._cascade_budgets(T * K * U)
        self._chunk_cand_eff = C2
        self._summary_kind = "chunk_host"
        b2 = self._bloom2

        def chunk(px, py):
            return _kernel_chunk_impl_host(
                px, py, self._tab_x_lm, self._tab_y_lm,
                self._adv_x_lm, self._adv_y_lm,
                self.bitmap.words, b2.words,
                C2=C2, bits_log2=self.bitmap.bits_log2,
                probe_mode=self.p.probe_mode,
                b2_bits=b2.bits_log2, C1=C1, impl=impl,
            )

        return chunk

    def _make_xla_chunk_fn_host(self):
        """XLA-walk chunk, host-resolve (CPU + untileable shapes):
        per-step cascade, survivors' keys in each summary row."""
        self._summary_kind = "steps_host"
        T = len(self.targets)
        U = self.p.block_u
        K = self.p.steps_per_chunk
        chain = self.p.chain_len
        C1, C2 = self._cascade_budgets(T * U)
        self._step_cand_eff = C2
        b2 = self._bloom2

        def chunk(px, py):
            return _xla_chunk_impl_host(
                px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
                self.bitmap.words, b2.words,
                T=T, U=U, K=K, C=C2, chain=chain,
                bits_log2=self.bitmap.bits_log2,
                probe_mode=self.p.probe_mode,
                b2_bits=b2.bits_log2, C1=C1,
            )

        return chunk

    def _consume_summary(self, step0: int, k: int, arr: np.ndarray):
        """Decode one chunk's packed summary -> (found, rebase, interesting).
        Dispatches on the summary layout: per-step rows (XLA path) or one
        chunk-level vector (walk-kernel path), each in device-resolved or
        host-resolve (survivor keys -> searchsorted) form."""
        p = self.p
        if self._summary_kind == "chunk_host":
            C2 = self._chunk_cand_eff
            K = p.steps_per_chunk
            U = p.block_u
            T = len(self.targets)
            B = T * K * U
            cand_pos = arr[:C2]
            qhi = arr[C2 : 2 * C2].view(np.uint32)
            qlo = arr[2 * C2 : 3 * C2].view(np.uint32)
            degsum = arr[3 * C2 : 3 * C2 + 3 * T * K].reshape(3, T, K)
            ncand = int(arr[3 * C2 + 3 * T * K])
            found: List[FoundKey] = []
            interesting = False
            if ncand > C2:
                interesting = True
                for s_ in range(k):  # cascade overflow: exact host rescan
                    found += self._host_rescan_step(step0 + s_)
            adv_any = degsum[2, :, :k].any(axis=0)  # (k,)
            adv_first = int(np.argmax(adv_any)) if adv_any.any() else k
            for s_ in range(adv_first + 1, k):
                interesting = True
                found += self._host_rescan_step(step0 + s_)
            valid = cand_pos < B
            if valid.any():
                rows, js = self.host_table.resolve(qhi[valid], qlo[valid])
                vpos = cand_pos[valid]
                for r, j in zip(rows.tolist(), js.tolist()):
                    pos = int(vpos[r])
                    blk, u0 = divmod(pos, U)
                    t, s_ = divmod(blk, K)
                    if s_ >= k:
                        continue
                    interesting = True
                    found += self._try_candidates(
                        self._candidates_for_hit(step0 + s_, u0 + 1, int(j)),
                        t,
                    )
            for t, s_ in zip(*np.nonzero(degsum[0, :, :k] > 0)):
                interesting = True
                u = int(degsum[1, t, s_]) + 1
                found += self._try_candidates(
                    self._candidates_for_degenerate(step0 + int(s_), u),
                    int(t),
                )
            rebase = bool(adv_any.any())
            return found, rebase, interesting

        if self._summary_kind == "steps_host":
            C = self._step_cand_eff
            T = len(self.targets)
            U = p.block_u
            cand_pos = arr[:, :C]
            qhi = arr[:, C : 2 * C].view(np.uint32)
            qlo = arr[:, 2 * C : 3 * C].view(np.uint32)
            degsum = arr[:, 3 * C : 3 * C + 3 * T].reshape(-1, 3, T)
            ncand = arr[:, 3 * C + 3 * T]
            found = []
            interesting = False
            for s_ in range(k):
                if ncand[s_] > C:
                    interesting = True
                    found += self._host_rescan_step(step0 + s_)
            valid = cand_pos[:k] < T * U
            if valid.any():
                rows, js = self.host_table.resolve(
                    qhi[:k][valid], qlo[:k][valid]
                )
                vpos = cand_pos[:k][valid]
                vstep = np.nonzero(valid)[0]
                for r, j in zip(rows.tolist(), js.tolist()):
                    pos = int(vpos[r])
                    s_ = int(vstep[r])
                    t, u0 = divmod(pos, U)
                    interesting = True
                    found += self._try_candidates(
                        self._candidates_for_hit(step0 + s_, u0 + 1, int(j)),
                        t,
                    )
            for s_, t in zip(*np.nonzero(degsum[:k, 0, :] > 0)):
                interesting = True
                u = int(degsum[s_, 1, t]) + 1
                found += self._try_candidates(
                    self._candidates_for_degenerate(step0 + int(s_), u),
                    int(t),
                )
            rebase = bool(degsum[:k, 2].any())
            if rebase:
                adv_steps = np.nonzero(degsum[:k, 2].any(axis=-1))[0]
                for s_ in range(int(adv_steps[0]) + 1, k):
                    interesting = True
                    found += self._host_rescan_step(step0 + s_)
            return found, rebase, interesting

        if self._summary_kind == "chunk":
            C2 = self._chunk_cand_eff
            K = p.steps_per_chunk
            U = p.block_u
            T = len(self.targets)
            cand_pos = arr[: C2]
            cand_j = arr[C2 : 2 * C2].view(np.uint32)
            cand_j2 = arr[2 * C2 : 3 * C2].view(np.uint32)
            # columns indexed by block = t*K + s
            degsum = arr[3 * C2 : 3 * C2 + 3 * T * K].reshape(3, T, K)
            ncand = int(arr[3 * C2 + 3 * T * K])
            found: List[FoundKey] = []
            interesting = False
            if ncand > C2:
                interesting = True
                for s_ in range(k):  # compaction overflow: exact host rescan
                    found += self._host_rescan_step(step0 + s_)
            # steps after a mid-chunk advance degeneracy hold garbage walk
            # state (the chain was patched to stay invertible): rescan them
            # exactly so a second key in those windows cannot be missed
            adv_any = degsum[2, :, :k].any(axis=0)  # (k,)
            adv_first = int(np.argmax(adv_any)) if adv_any.any() else k
            for s_ in range(adv_first + 1, k):
                interesting = True
                found += self._host_rescan_step(step0 + s_)
            for c in np.nonzero(cand_pos < T * K * U)[0]:
                pos = int(cand_pos[c])
                blk, u0 = divmod(pos, U)
                t, s_ = divmod(blk, K)
                if s_ >= k:
                    continue
                interesting = True
                cands = []
                for j in (int(cand_j[c]), int(cand_j2[c])):
                    if j:
                        cands += self._candidates_for_hit(step0 + s_, u0 + 1, j)
                found += self._try_candidates(cands, t)
            for t in range(T):
                for s_ in range(k):
                    if degsum[0, t, s_] > 0:
                        interesting = True
                        u = int(degsum[1, t, s_]) + 1
                        found += self._try_candidates(
                            self._candidates_for_degenerate(step0 + s_, u), t
                        )
            rebase = bool(adv_any.any())
            return found, rebase, interesting

        parts = self._split_summary(arr)
        cand_pos, degsum, ncand = parts[0], parts[3], parts[4]
        interesting = bool(
            (cand_pos[:k] < len(self.targets) * p.block_u).any()
            or degsum[:k, 0].any()
            or (ncand[:k] > p.cand_max).any()
        )
        found = self._decode_chunk(step0, k, *parts) if interesting else []
        rebase = bool(degsum[:k, 2].any())
        if rebase:
            # steps after the first advance degeneracy hold garbage walk
            # state for that target's lane; rescan them exactly (host)
            adv_steps = np.nonzero(degsum[:k, 2].any(axis=-1))[0]
            for s_ in range(int(adv_steps[0]) + 1, k):
                interesting = True
                found += self._host_rescan_step(step0 + s_)
        return found, rebase, interesting

    def _split_summary(self, arr: np.ndarray):
        """(K, 3C+3T+1) -> (cand_pos, cand_j, cand_j2, degsum, ncand)."""
        C = self.p.cand_max
        T = len(self.targets)
        cand_pos = arr[:, :C]
        cand_j = arr[:, C : 2 * C].view(np.uint32)
        cand_j2 = arr[:, 2 * C : 3 * C].view(np.uint32)
        degsum = arr[:, 3 * C : 3 * C + 3 * T].reshape(-1, 3, T)
        ncand = arr[:, 3 * C + 3 * T]
        return cand_pos, cand_j, cand_j2, degsum, ncand

    def _center(self, step: int, u: int) -> int:
        """Center scalar for device step `step`, offset u in 1..U."""
        return self.a + self.p.m + (step * self.p.block_u + u - 1) * self.stride

    def _candidates_for_hit(self, step: int, u: int, baby: int) -> List[int]:
        c = self._center(step, u)
        return [c - baby, c + baby]

    def _candidates_for_degenerate(self, step: int, u: int) -> List[int]:
        c_base = self._center(step, 0)  # = c_{sU} - stride
        return [c_base - u * self.stride, c_base + u * self.stride]

    def search(
        self,
        max_steps: Optional[int] = None,
        start_step: int = 0,
        stop_on_first: bool = True,
        progress_every: int = 0,
        max_seconds: Optional[float] = None,
    ) -> List[FoundKey]:
        """Run the giant-step scan. Returns verified found keys.

        max_seconds: optional wall-clock bound — dispatch stops at the
        first chunk boundary past the deadline and in-flight chunks are
        drained (stats stay exact)."""
        p = self.p
        dl = Deadline(max_seconds)
        remaining = self.n_steps - start_step
        total = remaining if max_steps is None else min(remaining, max_steps)
        end_step = start_step + total
        K = p.steps_per_chunk

        found: List[FoundKey] = []
        base = None
        while base is None:
            try:
                base = self._initial_base(start_step)
            except _ImmediateHit as hit:
                # the base center itself IS a target key: record it (the
                # range filter may drop it — a base at a-m is outside
                # [a, b]) and NEVER abandon the scan: the chunk anchored
                # at this degenerate base cannot be walked on-device, so
                # rescan its windows exactly on the host and move to the
                # next chunk boundary
                found += self._try_candidates_all([hit.scalar])
                if found and stop_on_first:
                    return self._dedupe_found(found)
                for s_ in range(start_step, min(start_step + K, end_step)):
                    found += self._host_rescan_step(s_)
                self.stats.add(
                    min(K, end_step - start_step) * p.block_u * self.stride
                )
                if found and stop_on_first:
                    return self._dedupe_found(found)
                start_step += K
                if start_step >= end_step:
                    return self._dedupe_found(found)

        px, py = base.x, base.y

        # bounded pipeline: dispatch up to pipeline_depth chunks ahead so
        # the host's summary pull and decode overlap device compute. Walk
        # state chains on-device; only summaries come back.
        pending: deque = deque()
        disp = start_step  # next step to dispatch
        step = start_step  # next step to decode
        n_done = 0
        while pending or disp < end_step:
            while (
                disp < end_step
                and len(pending) < p.pipeline_depth
                and not dl.expired()
            ):
                px, py, outs = self._chunk_fn(px, py)
                outs.copy_to_host_async()  # overlap the pull with compute
                pending.append((disp, outs))
                disp += K
            if not pending:
                break  # deadline cut dispatch with nothing in flight
            step, outs = pending.popleft()
            k = min(K, end_step - step)
            arr = np.asarray(outs)  # one transfer; overlaps device work
            new_found, rebase, interesting = self._consume_summary(step, k, arr)
            if new_found:
                found = self._dedupe_found(found + new_found)
                if stop_on_first:
                    self.stats.add(k * p.block_u * self.stride)
                    return found
            self.stats.add(k * p.block_u * self.stride)
            n_done += 1
            if rebase and step + K < end_step:
                # an advance lane degenerated mid-chunk: the device walk
                # state beyond that step is invalid — drop everything
                # dispatched after it and restart exactly
                pending.clear()
                disp = step + K
                try:
                    base = self._initial_base(disp)
                    px, py = base.x, base.y
                except _ImmediateHit as hit:
                    # the rebase base itself IS a target key; record it and
                    # keep going from the next chunk (never abandon --all).
                    # The chunk anchored at a degenerate base cannot be
                    # walked on-device: rescan its windows exactly on the
                    # host so no key in them can be missed.
                    found += self._try_candidates_all([hit.scalar])
                    if found and stop_on_first:
                        return self._dedupe_found(found)
                    while disp < end_step:
                        for s_ in range(disp, min(disp + K, end_step)):
                            found += self._host_rescan_step(s_)
                        self.stats.add(
                            min(K, end_step - disp) * p.block_u * self.stride
                        )
                        if found and stop_on_first:
                            return self._dedupe_found(found)
                        disp += K
                        try:
                            base = self._initial_base(disp)
                            px, py = base.x, base.y
                            break
                        except _ImmediateHit as hit2:
                            found += self._try_candidates_all([hit2.scalar])
            if progress_every and n_done % progress_every == 0:
                print(f"[bsgs] step {step + K}/{end_step} {self.stats.human()}")
        return self._dedupe_found(found)

    def chunk_order(self, policy: str = "sequential", seed: int = 0) -> List[int]:
        """Deterministic chunk-order permutation for a scheduling policy.

        Being a pure function of (policy, seed, n_chunks), a resumed run
        re-derives the identical order — the checkpoint only stores how
        many chunks were completed (core/checkpoint.py)."""
        import random as _random

        p = self.p
        n_chunks = math.ceil(self.n_steps / p.steps_per_chunk)
        order = list(range(n_chunks))
        if policy == "sequential":
            pass
        elif policy == "backward":
            order.reverse()
        elif policy == "both":
            front, back = 0, n_chunks - 1
            order = []
            rng = _random.Random(seed)
            while front <= back:
                if rng.random() < 0.5:
                    order.append(front)
                    front += 1
                else:
                    order.append(back)
                    back -= 1
        elif policy == "random":
            rng = _random.Random(seed)
            rng.shuffle(order)
        elif policy == "dance":
            # random alternation over front / back / middle thirds
            rng = _random.Random(seed)
            remaining = set(order)
            order = []
            while remaining:
                pool = sorted(remaining)
                pick = rng.choice(("front", "back", "middle"))
                if pick == "front":
                    c = pool[0]
                elif pick == "back":
                    c = pool[-1]
                else:
                    c = pool[len(pool) // 2]
                order.append(c)
                remaining.remove(c)
        else:
            raise ValueError(f"unknown policy {policy}")
        return order

    def search_scheduled(
        self,
        policy: str = "sequential",
        seed: int = 0,
        max_chunks: Optional[int] = None,
        stop_on_first: bool = True,
        progress_every: int = 0,
        checkpoint=None,
        max_seconds: Optional[float] = None,
    ) -> List[FoundKey]:
        """Range scheduling policies (reference's 5 BSGS sub-schedulers,
        keyhunt.cpp:4012-5616: sequential / backward / both / random /
        dance) re-expressed as chunk-order permutations.

        Non-sequential orders pay one exact host rebase (scalar_mult +
        point_add per target) per K-step chunk — amortized to nothing.
        The mutex range-claiming of the reference is replaced by the
        deterministic permutation, so multi-worker schedules stay disjoint
        by construction.

        checkpoint: optional core.CheckpointManager. Progress (count of
        completed chunks in the deterministic order) is persisted
        periodically and the search resumes past already-done chunks —
        the position persistence the reference only had in an ops script
        (vastai_deploy.sh:88-106).
        """
        p = self.p
        dl = Deadline(max_seconds)
        order = self.chunk_order(policy, seed)
        n_chunks = len(order)

        resume_from = 0
        ck = None
        found_seed: List[FoundKey] = []
        if checkpoint is not None:
            from ..core.checkpoint import Checkpoint, fingerprint

            params_fp = fingerprint(p.m, p.block_u, p.steps_per_chunk)
            targets_fp = fingerprint(sorted(self.targets))
            ck = checkpoint.load()
            if ck is not None:
                checkpoint.matches(
                    ck,
                    mode="bsgs",
                    range_start=self.a,
                    range_end=self.b,
                    policy=policy,
                    seed=seed,
                    params_fp=params_fp,
                    targets_fp=targets_fp,
                )
                resume_from = ck.chunks_done
                self.stats.add(ck.keys_covered)
                # re-surface keys the interrupted run persisted: resume
                # skips their chunks, so nothing else re-derives them
                # (round-4 review: the CLI writes KEYFOUNDKEYFOUND.txt
                # from the RETURN value only)
                found_seed = self._try_candidates_all(
                    [int(h, 16) for h in ck.found]
                )
            else:
                ck = Checkpoint(
                    mode="bsgs",
                    range_start=self.a,
                    range_end=self.b,
                    policy=policy,
                    seed=seed,
                    params_fp=params_fp,
                    targets_fp=targets_fp,
                    n_chunks=n_chunks,
                )

        if max_chunks is not None:
            order = order[: resume_from + max_chunks]

        found: List[FoundKey] = found_seed
        # bounded pipeline over the deterministic chunk order: every chunk
        # has an independent host-derived base, so dispatch runs ahead of
        # decode by pipeline_depth chunks and each summary pull overlaps
        # device compute.
        pending: deque = deque()
        disp_i = resume_from

        def dispatch_upto(limit: int):
            nonlocal disp_i
            while (
                disp_i < len(order)
                and len(pending) < limit
                and not dl.expired()
            ):
                idx = disp_i
                step0 = order[idx] * p.steps_per_chunk
                try:
                    base = self._initial_base(step0)
                except _ImmediateHit as hit:
                    pending.append((idx, step0, hit.scalar))
                else:
                    _, _, outs = self._chunk_fn(base.x, base.y)
                    outs.copy_to_host_async()  # overlap the pull with compute
                    pending.append((idx, step0, outs))
                disp_i += 1

        for i, chunk_idx in enumerate(order):
            if i < resume_from:
                continue
            dispatch_upto(p.pipeline_depth)
            if not pending:
                # deadline cut dispatch: persist exactly-completed progress
                # before returning (resume continues at chunk i)
                if ck is not None:
                    checkpoint.save(ck, force=True)
                break
            idx, step0, outs = pending.popleft()
            assert idx == i, (idx, i)
            k = min(p.steps_per_chunk, self.n_steps - step0)
            if isinstance(outs, int):  # _ImmediateHit scalar
                # the chunk anchored at the degenerate base was never
                # walked on-device: record the collision (the range
                # filter may drop an out-of-range base) and rescan the
                # chunk's windows exactly on the host, then fall through
                # to the normal stats/checkpoint accounting
                new_found = self._try_candidates_all([outs])
                for s_ in range(step0, step0 + k):
                    new_found += self._host_rescan_step(s_)
                interesting = True
            else:
                arr = np.asarray(outs)
                new_found, _, interesting = self._consume_summary(step0, k, arr)
            if new_found:
                found = self._dedupe_found(found + new_found)
                if found and stop_on_first:
                    self.stats.add(k * p.block_u * self.stride)
                    if ck is not None:
                        ck.chunks_done = i + 1
                        ck.keys_covered = self.stats.keys_covered
                        ck.found = [f"{f.private_key:x}" for f in found]
                        checkpoint.save(ck, force=True)
                    return found
            self.stats.add(k * p.block_u * self.stride)
            if ck is not None:
                ck.chunks_done = i + 1
                ck.keys_covered = self.stats.keys_covered
                if new_found:
                    # persist keys found with --all immediately: a crash
                    # after this save must not lose them (resume skips
                    # the completed chunk, so they'd never be re-derived)
                    ck.found = sorted(
                        set(ck.found) | {f"{f.private_key:x}" for f in found}
                    )
                checkpoint.save(
                    ck, force=bool(new_found) or (i + 1 == len(order))
                )
            if progress_every and i % progress_every == 0:
                print(f"[bsgs:{policy}] chunk {i}/{len(order)} {self.stats.human()}")
        return self._dedupe_found(found)

    @staticmethod
    def _dedupe_found(found: List[FoundKey]) -> List[FoundKey]:
        seen: Dict[Tuple[int, str], FoundKey] = {}
        for f in found:
            seen[(f.private_key, f.target)] = f
        return list(seen.values())

    def _decode_chunk(
        self, step0, k, cand_pos, cand_j, cand_j2, degsum, ncand
    ) -> List[FoundKey]:
        found = []
        T = len(self.targets)
        U = self.p.block_u
        for s in range(k):
            if ncand[s] > self.p.cand_max:
                # survivor overflow (fp burst): exact host rescan of this step
                found += self._host_rescan_step(step0 + s)
            for c in np.nonzero(cand_pos[s] < T * U)[0]:
                pos = int(cand_pos[s, c])
                t, u0 = divmod(pos, U)
                u = u0 + 1
                cands = []
                for j in (int(cand_j[s, c]), int(cand_j2[s, c])):
                    if j:
                        cands += self._candidates_for_hit(step0 + s, u, j)
                found += self._try_candidates(cands, t)
            for t in range(T):
                if degsum[s, 0, t] > 0:
                    u = int(degsum[s, 1, t]) + 1
                    found += self._try_candidates(
                        self._candidates_for_degenerate(step0 + s, u), t
                    )
        return found

    def _rescan_table(self):
        """(sorted packed u64 keys, payload u32, j_offset) for exact host
        rescans, lazily derived from whichever table this engine holds.
        Host-table payloads store j-1; device-table payloads store j."""
        if self._host_keys is None:
            if self.host_table is not None:
                self._host_keys = (
                    np.asarray(self.host_table.keys),
                    np.asarray(self.host_table.idx),
                    1,
                )
            else:
                hi = np.asarray(self.table.hi).astype(np.uint64)
                lo = np.asarray(self.table.lo).astype(np.uint64)
                self._host_keys = (
                    (hi << np.uint64(32)) | lo,
                    np.asarray(self.table.idx),
                    0,
                )
        return self._host_keys

    def _host_rescan_step(self, step: int) -> List[FoundKey]:
        """Exact host-side membership scan of one device step — the
        fallback when more than cand_max cascade survivors occur (the
        compaction would have dropped some). Incremental python-int walk
        (U point adds per target), then ONE vectorized searchsorted."""
        keys, payload, j_off = self._rescan_table()
        found: List[FoundKey] = []
        U = self.p.block_u
        neg_stride = ecref.point_neg(ecref.scalar_mult(self.stride))
        mask64 = (1 << 64) - 1
        for t, q in enumerate(self.targets):
            c0 = self._center(step, 1)
            c = c0
            neg = ecref.scalar_mult((-c) % ecref.N)
            pt = ecref.point_add(q, neg)
            xs = np.zeros(U, dtype=np.uint64)
            for u in range(U):
                if pt is None:  # Q == c*G exactly
                    found += self._try_candidates([c], t)
                    # xs[u] stays 0 — resolved below only if 0 is a real
                    # key truncation, and candidates are host-verified
                    pt = neg_stride
                else:
                    xs[u] = pt[0] & mask64
                    pt = ecref.point_add(pt, neg_stride)
                c += self.stride
            left = np.searchsorted(keys, xs, side="left")
            right = np.searchsorted(keys, xs, side="right")
            hit = right > left
            for u in np.nonzero(hit)[0]:
                cu = c0 + int(u) * self.stride
                for p_ in range(int(left[u]), int(right[u])):
                    j = int(payload[p_]) + j_off
                    found += self._try_candidates([cu - j, cu + j], t)
        return found

    def _try_candidates_all(self, cands: Sequence[int]) -> List[FoundKey]:
        """Verify candidate scalars against EVERY target (used for
        _ImmediateHit base-center collisions, which carry no target id)."""
        out: List[FoundKey] = []
        for t in range(len(self.targets)):
            out += self._try_candidates(cands, t)
        return out

    def _try_candidates(self, cands: Sequence[int], t: int = 0) -> List[FoundKey]:
        out = []
        for cand in cands:
            k = verify_candidate_scalar(cand, self.targets[t])
            # The final block's giant-step centers tile past range_end, so a
            # verified key can land outside [a, b]; the reference only ever
            # reports keys inside the claimed range (keyhunt.cpp:3824-3841
            # claims exact 2N windows), so filter to the requested range.
            if k is not None and not (self.a <= k <= self.b):
                k = None
            if k is not None:
                out.append(
                    FoundKey(
                        private_key=k,
                        pubkey=self.targets[t],
                        target=f"{self.targets[t][0]:064x}",
                    )
                )
        # dedupe (both +-j candidates can verify when j maps both ways)
        seen: Dict[int, FoundKey] = {}
        for f in out:
            seen[f.private_key] = f
        return list(seen.values())


class _ImmediateHit(Exception):
    def __init__(self, scalar: int):
        self.scalar = scalar


def host_baby_table(m: int) -> st.SortedXTable:
    """Exact host-built baby table for small m (tests / dryruns / entry):
    x(j*G) truncations computed with python ints, no device work."""
    bx, _ = tables.step_table(ecref.G, m)
    idx = (np.arange(m, dtype=np.uint64) + 1).astype(np.uint32)
    return st.build_sorted_table(bx[:, 1].copy(), bx[:, 0].copy(), idx)


# ---------------------------------------------------------------------------
# Module-level jitted chunk implementations. Static config comes in via
# static_argnames and all device arrays are ARGUMENTS: (a) jax.jit caches
# the trace per config (per-engine closures would re-trace these large
# graphs on every engine construction — deadly for bsgsd's
# engine-per-request pattern), (b) closure arrays would embed in the
# serialized HLO, breaking compile-cache reuse.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("T", "U", "K", "C", "chain", "bits_log2",
                                   "probe_mode", "b2_bits", "C1"))
def _xla_chunk_impl(px, py, tab_x, tab_y, adv_x, adv_y, words, thi, tlo, tidx,
                    words2=None, *, T, U, K, C, chain, bits_log2,
                    probe_mode=None, b2_bits=0, C1=None):
    bitmap = bmp.DeviceBitmap(words, bits_log2)
    table = st.SortedXTable(thi, tlo, tidx)
    bloom2 = (bmp.DeviceBloom2(words2, b2_bits)
              if words2 is not None else None)

    def body(carry, _):
        cx, cy = carry
        pb = points.PointBatch(cx, cy, jnp.zeros((T,), dtype=bool))
        res = walk.walk_fused(pb, tab_x, tab_y, adv_x, adv_y, chain_len=chain)
        qhi, qlo = st.trunc64_from_limbs(res.x_plus)  # (T, U)
        # bitmap cascade: 1 gather/query, exact search only on the
        # compacted survivors (C-wide instead of T*U-wide)
        fl = bmp.filtered_lookup(
            bitmap, table, qhi.reshape(-1), qlo.reshape(-1), C,
            mode=probe_mode, bm2=bloom2, stage1_max=C1,
        )
        deg_flat = res.degenerate.reshape(-1)
        pos_safe = jnp.minimum(fl.pos, T * U - 1)
        live = ~deg_flat[pos_safe]
        cand_pos = jnp.where(
            (fl.result.found | fl.result.found2) & live, fl.pos, T * U
        )
        cand_j = jnp.where(fl.result.found & live, fl.result.idx, 0)
        cand_j2 = jnp.where(fl.result.found2 & live, fl.result.idx2, 0)
        # adv degenerate == walk lane U degenerate (ADV = U*S = tab[U-1]),
        # so its candidates are already covered by the deg summary; it
        # additionally flags corrupted walk state (the engine rebases
        # exactly at the next chunk boundary).
        deg = res.degenerate.at[:, U - 1].set(
            res.degenerate[:, U - 1] | res.adv_degenerate
        )
        n_deg = deg.sum(axis=1).astype(jnp.int32)
        first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
        degsum = jnp.stack(
            [n_deg, first_deg, res.adv_degenerate.astype(jnp.int32)]
        )  # (3, T)
        # one packed row per step -> ONE host transfer per chunk
        out = jnp.concatenate(
            [
                cand_pos.astype(jnp.int32),
                cand_j.astype(jnp.int32),
                cand_j2.astype(jnp.int32),
                degsum.reshape(-1),
                fl.n_candidates[None],
            ]
        )  # (3C + 3T + 1,)
        return (res.adv_x, res.adv_y), out

    (px, py), outs = jax.lax.scan(body, (px, py), None, length=K)
    return px, py, outs  # (K, 3C + 3T + 1)


@jax.jit
def _build_chunk_impl(px, py, tx, ty, ax, ay):
    return pwalk.walk_chunk(px, py, tx, ty, ax, ay, impl="cuda")


class _BuildScanResult(NamedTuple):
    next_x: jnp.ndarray  # (1, 8) uint32 limbs
    next_y: jnp.ndarray
    qhi: jnp.ndarray  # (n_iter, K*U) uint32
    qlo: jnp.ndarray
    degenerate: jnp.ndarray  # (n_iter, K, U) bool
    dcount: jnp.ndarray  # (n_iter,) int32 degeneracies per chunk
    adv_any: jnp.ndarray  # () bool — any base at infinity


@partial(jax.jit, static_argnames=("n_iter",))
def _build_scan_impl(px, py, tx, ty, ax, ay, *, n_iter):
    """The whole table-build chunk loop as ONE dispatch: lax.scan over
    n_iter walk-kernel chunks (each K blocks of U baby points)."""

    def body(carry, _):
        cpx, cpy = carry
        res = pwalk.walk_chunk(cpx, cpy, tx, ty, ax, ay, impl="cuda")
        out = (
            res.qhi.reshape(-1),
            res.qlo.reshape(-1),
            res.degenerate,
            res.degenerate.sum(dtype=jnp.int32),
            res.adv_degenerate.any(),
        )
        return (res.next_x, res.next_y), out

    (nx, ny), (qhi, qlo, deg, dcount, adv) = jax.lax.scan(
        body, (px, py), None, length=n_iter
    )
    return _BuildScanResult(nx, ny, qhi, qlo, deg, dcount, adv.any())


@partial(jax.jit, static_argnames=("n_words",))
def _seed_words(word_idx, vals, *, n_words: int):
    """Initial filter words from host-deduplicated (word, value) pairs."""
    return jnp.zeros(n_words, jnp.uint32).at[word_idx].set(vals)


@partial(jax.jit, static_argnames=("bits_log2", "b2_bits"),
         donate_argnums=(6, 7))
def _filters_stream_impl(px, py, tx, ty, ax, ay, words1, words2,
                         n_iter, it0, n_keys, *, bits_log2, b2_bits):
    """One bounded SLICE of the filter build: a fori_loop carries
    (bitmap, bloom2, walk state); each iteration walks K blocks of U
    keys (walk kernels) and ORs their bits into both filters, masking
    lanes whose global key index reaches n_keys (the final iteration's
    tail).

    n_iter, it0 (global iteration offset of this slice) and n_keys are
    RUNTIME values and the filter sizes are fixed by the engine
    (bits=35, b2=35), so ONE compile serves every m and every slice.
    Requires n_keys <= 2^31 (uint32 index math)."""
    K, U = ax.shape[1], tx.shape[1]
    KU = K * U

    def body(it, carry):
        w1, w2, cpx, cpy, dc, adv = carry
        res = pwalk.walk_chunk(cpx, cpy, tx, ty, ax, ay, impl="cuda")
        qhi = res.qhi.reshape(-1)
        qlo = res.qlo.reshape(-1)
        start = (jnp.uint32(2 * U)
                 + (it0.astype(jnp.uint32) + it.astype(jnp.uint32))
                 * jnp.uint32(KU))
        keep = (start + jnp.arange(KU, dtype=jnp.uint32)) < n_keys
        wi, bv = bmp.bitmap_bit_planes(qhi, qlo, bits_log2)
        wi = jnp.where(keep, wi, w1.shape[0])
        wi2, bv2 = bmp.bloom2_bit_planes(qhi, qlo, b2_bits)
        wi2 = jnp.where(jnp.concatenate([keep, keep]), wi2, w2.shape[0])
        w1 = bmp.or_bits_into(w1, wi, bv)
        w2 = bmp.or_bits_into(w2, wi2, bv2)
        dc = dc + (res.degenerate.reshape(-1) & keep).sum(dtype=jnp.int32)
        adv = adv | res.adv_degenerate.any()
        return (w1, w2, res.next_x, res.next_y, dc, adv)

    carry = (words1, words2, px, py, jnp.int32(0),
             jnp.zeros((), dtype=bool))
    w1, w2, nx, ny, dc, adv = jax.lax.fori_loop(0, n_iter, body, carry)
    return w1, w2, nx, ny, dc, adv


def _kernel_summary(res: pwalk.WalkChunk, U: int):
    """(flat qhi, flat qlo, flat degenerate mask, degsum (3, T*K)) of a
    walk-kernel chunk. A base at infinity (adv flag of row t*K + s) is
    also walk lane U-1 of that row (ADV = U*S = tab[U-1]), so it joins the
    degenerate mask and its candidates come from the degeneracy decode."""
    adv_flat = res.adv_degenerate.reshape(-1)  # (T*K,)
    deg = res.degenerate
    deg = deg.at[:, U - 1].set(deg[:, U - 1] | adv_flat)
    n_deg = deg.sum(axis=1).astype(jnp.int32)  # (T*K,)
    first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
    degsum = jnp.stack([n_deg, first_deg, adv_flat.astype(jnp.int32)])
    return res.qhi.reshape(-1), res.qlo.reshape(-1), deg.reshape(-1), degsum


@partial(jax.jit, static_argnames=("C2", "bits_log2", "probe_mode",
                                   "b2_bits", "C1", "impl"))
def _kernel_chunk_impl(px_bm, py_bm, tab_x_lm, tab_y_lm, ax, ay,
                       words, thi, tlo, tidx, words2=None,
                       *, C2, bits_log2, probe_mode=None, b2_bits=0,
                       C1=None, impl="cuda"):
    bitmap = bmp.DeviceBitmap(words, bits_log2)
    table = st.SortedXTable(thi, tlo, tidx)
    bloom2 = (bmp.DeviceBloom2(words2, b2_bits)
              if words2 is not None else None)
    res = pwalk.walk_chunk(px_bm, py_bm, tab_x_lm, tab_y_lm, ax, ay,
                           impl=impl)
    qh, ql, deg_flat, degsum = _kernel_summary(res, tab_x_lm.shape[1])
    B = qh.shape[0]
    # chunk-level cascade: ONE compaction + ONE exact search per chunk
    fl = bmp.filtered_lookup(bitmap, table, qh, ql, C2, mode=probe_mode,
                             bm2=bloom2, stage1_max=C1)
    live = ~deg_flat[jnp.minimum(fl.pos, B - 1)]
    cand_pos = jnp.where((fl.result.found | fl.result.found2) & live,
                         fl.pos, B)
    cand_j = jnp.where(fl.result.found & live, fl.result.idx, 0)
    cand_j2 = jnp.where(fl.result.found2 & live, fl.result.idx2, 0)
    out = jnp.concatenate(
        [
            cand_pos.astype(jnp.int32),
            cand_j.astype(jnp.int32),
            cand_j2.astype(jnp.int32),
            degsum.reshape(-1),
            fl.n_candidates[None],
        ]
    )  # (3*C2 + 3*T*K + 1,)
    return res.next_x, res.next_y, out


@partial(jax.jit, static_argnames=("C2", "bits_log2", "probe_mode",
                                   "b2_bits", "C1", "impl"))
def _kernel_chunk_impl_host(px_bm, py_bm, tab_x_lm, tab_y_lm, ax, ay,
                            words, words2,
                            *, C2, bits_log2, probe_mode=None, b2_bits=0,
                            C1=None, impl="cuda"):
    """Host-resolve chunk: walk kernels + 2-stage cascade, survivors'
    64-bit truncated keys returned for host searchsorted resolution —
    the device holds NO exact table."""
    bitmap = bmp.DeviceBitmap(words, bits_log2)
    bloom2 = bmp.DeviceBloom2(words2, b2_bits)
    res = pwalk.walk_chunk(px_bm, py_bm, tab_x_lm, tab_y_lm, ax, ay,
                           impl=impl)
    qh, ql, deg_flat, degsum = _kernel_summary(res, tab_x_lm.shape[1])
    B = qh.shape[0]
    fs = bmp.filtered_survivors(bitmap, qh, ql, C2, mode=probe_mode,
                                bm2=bloom2, stage1_max=C1)
    live = ~deg_flat[jnp.minimum(fs.pos, B - 1)]
    cand_pos = jnp.where((fs.pos < B) & live, fs.pos, B)
    out = jnp.concatenate(
        [
            cand_pos.astype(jnp.int32),
            jax.lax.bitcast_convert_type(fs.qhi, jnp.int32),
            jax.lax.bitcast_convert_type(fs.qlo, jnp.int32),
            degsum.reshape(-1),
            fs.n_candidates[None],
        ]
    )  # (3*C2 + 3*T*K + 1,)
    return res.next_x, res.next_y, out


@partial(jax.jit, static_argnames=("T", "U", "K", "C", "chain", "bits_log2",
                                   "probe_mode", "b2_bits", "C1"))
def _xla_chunk_impl_host(px, py, tab_x, tab_y, adv_x, adv_y, words, words2,
                         *, T, U, K, C, chain, bits_log2,
                         probe_mode=None, b2_bits=0, C1=None):
    """XLA-walk host-resolve chunk (CPU / untileable shapes):
    per-step summary rows carry survivor keys instead of baby indices."""
    bitmap = bmp.DeviceBitmap(words, bits_log2)
    bloom2 = bmp.DeviceBloom2(words2, b2_bits)

    def body(carry, _):
        cx, cy = carry
        pb = points.PointBatch(cx, cy, jnp.zeros((T,), dtype=bool))
        res = walk.walk_fused(pb, tab_x, tab_y, adv_x, adv_y, chain_len=chain)
        qhi, qlo = st.trunc64_from_limbs(res.x_plus)  # (T, U)
        fs = bmp.filtered_survivors(
            bitmap, qhi.reshape(-1), qlo.reshape(-1), C,
            mode=probe_mode, bm2=bloom2, stage1_max=C1,
        )
        deg_flat = res.degenerate.reshape(-1)
        pos_safe = jnp.minimum(fs.pos, T * U - 1)
        live = ~deg_flat[pos_safe]
        cand_pos = jnp.where((fs.pos < T * U) & live, fs.pos, T * U)
        deg = res.degenerate.at[:, U - 1].set(
            res.degenerate[:, U - 1] | res.adv_degenerate
        )
        n_deg = deg.sum(axis=1).astype(jnp.int32)
        first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
        degsum = jnp.stack(
            [n_deg, first_deg, res.adv_degenerate.astype(jnp.int32)]
        )  # (3, T)
        out = jnp.concatenate(
            [
                cand_pos.astype(jnp.int32),
                jax.lax.bitcast_convert_type(fs.qhi, jnp.int32),
                jax.lax.bitcast_convert_type(fs.qlo, jnp.int32),
                degsum.reshape(-1),
                fs.n_candidates[None],
            ]
        )  # (3C + 3T + 1,)
        return (res.adv_x, res.adv_y), out

    (px, py), outs = jax.lax.scan(body, (px, py), None, length=K)
    return px, py, outs  # (K, 3C + 3T + 1)
