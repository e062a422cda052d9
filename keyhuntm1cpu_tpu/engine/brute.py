"""Brute-force scanning engines: address / rmd160 / xpoint / eth.

Re-design of the reference's thread_process (keyhunt.cpp:2511-3099):
instead of per-thread 1024-point sequential walks with mutex range claims,
W independent walkers each own a disjoint contiguous slice of the range
and every device step advances all walkers by a (2U+1)-key window computed
with ONE batched inversion (symmetric group walk around each walker's
center).

Key window algebra for walker w at device step s:
    k0(w, s)  = a + w * slice_len + s * (2U + 1)
    center    = k0 + U        (point state on device)
    covered   = { k0 .. k0 + 2U }  via  center - u, center, center + u

Hash modes hash BOTH compressed parities of each X (reference
GetHash160_fromX, SECP256K1.cpp:746-790), so a device hit yields candidate
scalars {k, n - k}; the host verifies exactly against the full 20-byte
target (parity/negation correction — reference keyhunt.cpp:2800-2851).

Modes:
- 'xpoint'  : match X coordinates directly (no hashing) — keyhunt -m xpoint
- 'rmd160'  : match hash160(compressed pubkey) — keyhunt -m rmd160
- 'address' : same pipeline, targets parsed from base58 — keyhunt -m address
- 'address_u': uncompressed (04||x||y) hash160 (full walk computes y)
- 'eth'     : keccak256(x||y)[12:] (full walk) — keyhunt -m address ETH mode
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import device
from ..curve import points, tables, walk
from ..field import fe
from ..filter import bitmap as bmp
from ..filter import sorted_table as st
from ..hash import (
    hash160_from_x_both_parities,
    hash160_from_xy,
    keccak256_pubkey64,
)
from ..ref import ecref, hashref
from ..utils.targets import TargetSet
from .common import Deadline, FoundKey, SearchStats

# lambda^e factors for GLV endomorphism key reconstruction (keyhunt.cpp:2800-2851)
_LAM_POW = (1, ecref.LAMBDA, ecref.LAMBDA * ecref.LAMBDA % ecref.N)


@dataclass(frozen=True)
class BruteParams:
    walkers: int = 4  # W independent walkers
    block_u: int = 256  # U: symmetric offsets (window = 2U+1 keys)
    steps_per_chunk: int = 8  # K: device steps per jit call
    chain_len: int = 32
    endo: bool = False  # GLV endomorphism lanes (reference -e):
    # also check beta*x and beta^2*x, covering lambda*k and lambda^2*k
    # for 2 extra modmuls per point (keyhunt.cpp:2646-2677)
    stride: int = 1  # key-space stride (reference -I): scan
    # {a, a+stride, a+2*stride, ...}; the walk table becomes multiples of
    # stride*G so device cost is unchanged (keyhunt.cpp stride handling
    # in thread_process, :2586-2590)
    cand_max: int = 256  # compacted probe survivors per device step
    # (bitmap cascade, filter/bitmap.py); overflow -> exact host rescan
    random_mode: bool = False  # reference -R: walkers re-base to random
    # window-aligned positions every chunk instead of scanning sequentially
    # (keyhunt.cpp:2547-2568 random base claims)
    seed: int = 0
    seq_per_base: Optional[int] = None  # reference -n with -R
    # (N_SEQUENTIAL_MAX, keyhunt.cpp:271,2552-2568): scan this many
    # sequential keys from each random base before re-basing. None =
    # one chunk per base; values are rounded UP to whole chunks
    # (chunk = steps_per_chunk * block_u * stride keys). The reference
    # floors user values at 1024 and defaults to 2^32.
    # fused pipeline (curve/pbrute.py): walk + hash + interval compare in
    # one jitted chunk, no bitmap gathers. "auto" takes it on the GPU when
    # the target set fits compare_max, and on any platform when interval
    # membership (vanity, -l both ranges) needs it; larger exact sets
    # take the bitmap path. "on"/"off" force.
    fused: str = "auto"  # "auto" | "on" | "off"
    chunk_cand: int = 1024  # chunk-level compacted candidates (the compare
    # membership has no false positives beyond 64-bit truncation, so this
    # never overflows in practice; overflow -> exact host rescan)
    compare_max: int = 512  # largest target set (exact targets + vanity/
    # -l ranges) for the unrolled interval compares
    pipeline_depth: int = 8  # chunks dispatched ahead of decode (the host
    # pull and decode overlap device compute)

class BruteEngine:
    def __init__(
        self,
        targets: TargetSet,
        range_start: int,
        range_end: int,
        mode: str = "rmd160",
        params: BruteParams = BruteParams(),
        compressed: bool = True,
        intervals=None,  # [(lo20, hi20)] hash160 bounds (vanity ranges);
        # composes with exact targets in one scan (reference -v alongside
        # address mode, keyhunt.cpp:6270-6272). Fused path only.
        prefixes=None,  # address prefixes for exact host verification of
        # interval hits
    ):
        if mode not in ("xpoint", "rmd160", "address", "address_u", "eth",
                        "rmd160_both"):
            raise ValueError(f"bad mode {mode}")
        if not (1 <= range_start < range_end <= ecref.N):
            raise ValueError("bad range")
        self.mode = "rmd160" if mode == "address" else mode
        self.targets = targets
        # dict lookup for host verification: candidates are rare but
        # target sets can be large — a linear raw.index scan is O(T)
        # each. First occurrence wins on dups.
        self._raw_index = {
            r: i for i, r in reversed(list(enumerate(targets.raw)))
        }
        self.intervals = list(intervals or [])
        self.prefixes = list(prefixes or [])
        if len(targets.raw) > 0:
            self.table = targets.build_table()
            self.bitmap = targets.build_bitmap()
        else:
            if not self.intervals:
                raise ValueError("no targets and no intervals")
            self.table = self.bitmap = None  # interval-only (fused path)
        self.a = range_start
        self.b = range_end
        self.p = params
        self.stats = SearchStats()

        # keys-covered accounting multipliers (reference keyhunt.cpp:2175-2187)
        mult = 1
        if self.mode in ("rmd160",):
            mult = 2  # both parities cover k and n-k
        elif self.mode == "rmd160_both":
            mult = 3  # +-k compressed plus k uncompressed (-l both)
        if params.endo and self.mode in ("rmd160", "xpoint"):
            mult *= 3
        self.stats.multiplier = mult

        self.window = 2 * params.block_u + 1
        # index space: key(j) = a + j*stride, j in [0, total_idx)
        self.stride = params.stride
        if self.stride < 1:
            raise ValueError("stride must be >= 1")
        total_idx = math.ceil((self.b - self.a) / self.stride)
        self.slice_len = math.ceil(total_idx / params.walkers)
        # round the slice up to whole windows so walkers stay aligned
        self.slice_len = math.ceil(self.slice_len / self.window) * self.window
        self.steps_per_walker = self.slice_len // self.window
        self.total_steps = self.steps_per_walker * params.walkers

        step_pt = ecref.scalar_mult(self.stride)
        tab_x, tab_y = tables.step_table(step_pt, params.block_u)
        self.tab_x = jnp.asarray(tab_x)
        self.tab_y = jnp.asarray(tab_y)
        adv = ecref.scalar_mult(self.window * self.stride)
        self.adv_x = fe.from_int(adv[0])
        self.adv_y = fe.from_int(adv[1])
        self._fast = self._use_fused()
        if self._fast:
            self._init_fast()
        else:
            self._chunk_fn = self._make_chunk_fn()

    # ------------------------------------------------------------------

    def _centers_for_bases(self, bases: Sequence[int]) -> points.PointBatch:
        """Walker centers for per-walker window-start indices `bases`
        (flat index units: key = a + idx*stride)."""
        pts = []
        for w, base_idx in enumerate(bases):
            c = self.a + (base_idx + self.p.block_u) * self.stride
            pts.append(ecref.scalar_mult(c))
        return points.point_batch_from_ints(pts)

    def _sequential_bases(self, step0: int = 0) -> List[int]:
        return [
            w * self.slice_len + step0 * self.window
            for w in range(self.p.walkers)
        ]

    def _make_chunk_fn(self):
        W = self.p.walkers
        U = self.p.block_u
        K = self.p.steps_per_chunk
        C = self.p.cand_max
        chain = self.p.chain_len
        mode = self.mode
        needs_y = mode in ("eth", "address_u", "rmd160_both")
        n_endo = 3 if self.p.endo else 1
        # query sets per point: endo variants x (2 parities for rmd160,
        # 3 forms for rmd160_both)
        from ..curve import pbrute as _pb

        self.n_qsets = _pb.n_qsets(mode, n_endo)
        nq = self.n_qsets
        bits_log2 = self.bitmap.bits_log2

        def chunk(cx, cy):
            return _brute_chunk_impl(
                cx, cy, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
                self.bitmap.words, self.table.hi, self.table.lo, self.table.idx,
                W=W, U=U, K=K, C=C, chain=chain, mode=mode,
                needs_y=needs_y, n_endo=n_endo, nq=nq, bits_log2=bits_log2,
            )

        return chunk

    # ------------------------------------------------------------------
    # fused pipeline (curve/pbrute.py): one walk of K steps x U offsets
    # per chunk, hash + interval compare in the same pass.
    # Index algebra: key(j) = a' + j*stride for flat j = s*U + u - 1,
    # u in 1..U; base scalar of step s is a' - stride + s*U*stride.
    # ------------------------------------------------------------------

    def _use_fused(self) -> bool:
        from ..curve import pbrute

        p = self.p
        needs = bool(self.intervals) or not len(self.targets.raw)
        ok = (self.mode in pbrute.MODES
              and len(self.targets.raw) + len(self.intervals) <= p.compare_max)
        if p.fused == "off" or (needs and not ok):
            if needs:
                raise ValueError(
                    "interval membership (vanity composition / -l both "
                    "ranges) needs the fused path: fused != 'off' and at "
                    f"most {p.compare_max} targets + intervals"
                )
            return False
        if p.fused == "on":
            if not ok:
                raise ValueError(
                    f"fused brute path needs mode in {pbrute.MODES} and "
                    f"<= {p.compare_max} targets + intervals"
                )
            return True
        return ok and (needs or device.on_gpu())

    def _init_fast(self) -> None:
        from ..curve import pbrute

        p = self.p
        self._n_endo_fast = 3 if (p.endo and self.mode in ("rmd160", "xpoint")) else 1
        self._parities = {"rmd160": 2, "rmd160_both": 3}.get(self.mode, 1)
        adv = ecref.scalar_mult(p.block_u * self.stride)
        self._adv_x_f = jnp.asarray(fe.int_to_limbs(adv[0]))
        self._adv_y_f = jnp.asarray(fe.int_to_limbs(adv[1]))
        # membership = 64-bit big-endian intervals: exact targets become
        # point intervals, vanity prefixes real ranges (one compare path)
        def cmp64(raw: bytes) -> int:
            if self.mode == "xpoint":
                return int.from_bytes(raw, "big") & ((1 << 64) - 1)
            return int.from_bytes(raw[:8], "big")

        lo64 = [cmp64(raw) for raw in self.targets.raw]
        hi64 = list(lo64)
        for lo20, hi20 in self.intervals:
            lo64.append(int.from_bytes(lo20[:8], "big"))
            hi64.append(int.from_bytes(hi20[:8], "big"))
        self._tgt_words = jnp.asarray(pbrute.pack_intervals(lo64, hi64))
        # lattice-shift edge: base(0) = a - stride would be the point at
        # infinity when a == stride; shift by one stride and host-verify
        # the single skipped key
        self._fast_a = self.a
        self._fast_prefix: List[int] = []
        if (self.a - self.stride) % ecref.N == 0:
            self._fast_prefix.append(self.a)
            self._fast_a = self.a + self.stride
        self._fast_total_idx = max(
            0, math.ceil((self.b - self._fast_a) / self.stride)
        )
        self._fast_total_steps = math.ceil(self._fast_total_idx / p.block_u)

        def chunk(px, py):
            return pbrute.xla_brute_chunk(
                px, py, self.tab_x, self.tab_y,
                self._adv_x_f, self._adv_y_f, self._tgt_words,
                K=p.steps_per_chunk, U=p.block_u, C=p.chunk_cand,
                mode=self.mode, n_endo=self._n_endo_fast, chain=p.chain_len,
            )

        self._fast_chunk = chunk

    def _fast_base(self, step0: int):
        """Device point for the chunk base scalar (None, None) if it is
        the point at infinity — the caller falls back to a host rescan."""
        s = (
            self._fast_a - self.stride
            + step0 * self.p.block_u * self.stride
        ) % ecref.N
        if s == 0:
            return None, None
        pt = ecref.scalar_mult(s)
        return (
            jnp.asarray(fe.int_to_limbs(pt[0])),
            jnp.asarray(fe.int_to_limbs(pt[1])),
        )

    def _fast_key(self, j: int) -> int:
        return self._fast_a + j * self.stride

    def _ckpt_load(self, checkpoint):
        """Load/create a position checkpoint for this run -> (ck, units).

        Units are device steps decoded (sequential scan) or chunks decoded
        (random mode) — both deterministic, so resume re-derives the exact
        continuation (the reference only had ops-script log scraping,
        vastai_deploy.sh:88-106)."""
        from ..core.checkpoint import Checkpoint, fingerprint

        p = self.p
        params_fp = fingerprint(
            self.mode, p.block_u, p.steps_per_chunk, self.stride, p.endo,
            p.walkers, p.random_mode, p.seed, self._fast,
        )
        targets_fp = fingerprint(
            sorted(self.targets.raw), sorted(self.intervals),
            sorted(self.prefixes),
        )
        policy = "random" if p.random_mode else "sequential"
        ck = checkpoint.load()
        if ck is not None:
            checkpoint.matches(
                ck, mode=f"brute:{self.mode}", range_start=self.a,
                range_end=self.b, policy=policy, seed=p.seed,
                params_fp=params_fp, targets_fp=targets_fp,
            )
            self.stats.add(ck.keys_covered)
            return ck, ck.chunks_done
        return Checkpoint(
            mode=f"brute:{self.mode}", range_start=self.a, range_end=self.b,
            policy=policy, seed=p.seed, params_fp=params_fp,
            targets_fp=targets_fp,
        ), 0

    @staticmethod
    def _ckpt_save(mgr, ck, units, stats, found, new_found, force=False):
        if mgr is None:
            return
        ck.chunks_done = units
        ck.keys_covered = stats.keys_covered
        if new_found:
            ck.found = sorted(
                set(ck.found) | {f"{f.private_key:x}" for f in found}
            )
        mgr.save(ck, force=force or bool(new_found))

    def _search_fused(
        self,
        max_steps: Optional[int] = None,
        stop_on_first: bool = False,
        progress_every: int = 0,
        checkpoint=None,
        max_seconds: Optional[float] = None,
    ) -> List[FoundKey]:
        p = self.p
        dl = Deadline(max_seconds)
        U, K = p.block_u, p.steps_per_chunk
        total = (
            self._fast_total_steps
            if max_steps is None
            else min(self._fast_total_steps, max_steps)
        )
        found: List[FoundKey] = []
        seen = set()

        def take(fk: Optional[FoundKey]) -> bool:
            if fk and fk.private_key not in seen:
                seen.add(fk.private_key)
                found.append(fk)
                return True
            return False

        for k0 in self._fast_prefix:
            take(self._verify(k0, 0))
            if found and stop_on_first:
                return found

        rng = np.random.default_rng(p.seed) if p.random_mode else None
        # chunks per random base: reference -n/N_SEQUENTIAL_MAX scans that
        # many sequential keys from each random base before re-choosing
        # (keyhunt.cpp:2552-2568); a chunk covers K*U stride-spaced keys
        cpb = 1
        if rng is not None and p.seq_per_base:
            cpb = max(1, math.ceil(p.seq_per_base / (K * U)))
        group_left = 0  # chunks remaining on the current random base
        s_next = 0  # chained continuation step for the current base
        n_chunks = math.ceil(total / K) if total else 0
        chunks_done = 0
        depth = p.pipeline_depth
        ck = None
        resumed = 0
        if checkpoint is not None:
            ck, resumed = self._ckpt_load(checkpoint)
            found += self._reverify_saved(ck, found)

        # bounded pipeline: dispatch up to `depth` chunks ahead so the
        # per-chunk host pull and decode overlap device compute. Chunk
        # i+1's walk state chains on-device; only summaries come back.
        pending: deque = deque()
        disp_step = 0  # next step to dispatch (sequential mode)
        disp_chunks = 0  # chunks dispatched (random mode)
        if rng is not None:
            # replay consumed draws (one per base group; resume starts a
            # fresh group rather than reconstructing mid-group state)
            for _ in range(math.ceil(resumed / cpb)):
                rng.integers(0, max(1, self._fast_total_steps - K + 1))
            chunks_done = disp_chunks = min(resumed, n_chunks)
        else:
            disp_step = min(resumed, total)
            chunks_done = disp_step // K
        px = py = None
        if rng is None and disp_step < total:
            px, py = self._fast_base(disp_step)

        def can_dispatch() -> bool:
            if dl.expired():
                return False  # time-bounded search: stop at chunk boundary
            if rng is not None:
                return disp_chunks < n_chunks
            return disp_step < total

        while pending or can_dispatch():
            while can_dispatch() and len(pending) < depth:
                if rng is not None:
                    if (group_left <= 0 or px is None
                            or s_next + K > self._fast_total_steps):
                        s0 = int(rng.integers(
                            0, max(1, self._fast_total_steps - K + 1)
                        ))
                        px, py = self._fast_base(s0)
                        group_left = cpb
                    else:
                        # -n continuation: the chained device walk state
                        # (px, py) already sits K steps past the previous
                        # chunk — keep scanning sequentially from it
                        s0 = s_next
                    group_left -= 1
                    s_next = s0 + K
                else:
                    s0 = disp_step
                if px is None:
                    pending.append((s0, None))  # base at infinity: host
                else:
                    px2, py2, out = self._fast_chunk(px, py)
                    # start the summary's device->host copy NOW, so the
                    # later pull finds it done
                    out.copy_to_host_async()
                    pending.append((s0, out))
                    px, py = px2, py2
                disp_step = s0 + K
                disp_chunks += 1
            if not pending:
                break  # deadline hit between outer check and dispatch
            step0, out = pending.popleft()
            if out is None:
                new_found, k_eff = self._host_rescan_fast(step0, K), K
            else:
                arr = np.asarray(out)  # ONE transfer; overlaps device work
                k_eff, new_found = self._decode_fast(step0, arr)
            for fk in new_found:
                take(fk)
            self.stats.add(max(0, min(k_eff, total - step0)) * U)
            chunks_done += 1
            units = chunks_done if rng is not None else step0 + k_eff
            done_all = not pending and not can_dispatch()
            self._ckpt_save(
                checkpoint, ck, units, self.stats, found, new_found,
                force=done_all,
            )
            if found and stop_on_first:
                self._ckpt_save(
                    checkpoint, ck, units, self.stats, found, new_found,
                    force=True,
                )
                return found
            if rng is None and k_eff < K:
                # advance-chain degeneracy: everything dispatched after
                # this chunk walked garbage state — discard and restart
                # the pipeline exactly from the first bad step
                pending.clear()
                disp_step = step0 + k_eff
                if disp_step < total:
                    px, py = self._fast_base(disp_step)
            if progress_every and chunks_done % progress_every == 0:
                print(
                    f"[brute] chunk {chunks_done}/{n_chunks} {self.stats.human()}"
                )
        return found

    def _decode_fast(
        self, step0: int, arr: np.ndarray
    ) -> Tuple[int, List[FoundKey]]:
        """Decode one packed chunk summary -> (valid steps, found keys)."""
        p = self.p
        C, K, U = p.chunk_cand, p.steps_per_chunk, p.block_u
        lam_pow = _LAM_POW
        pos = arr[:C]
        bits = arr[C : 2 * C].view(np.uint32)
        n_deg = arr[2 * C : 2 * C + K]
        first_deg = arr[2 * C + K : 2 * C + 2 * K]
        adv = arr[2 * C + 2 * K : 2 * C + 3 * K]
        ncand = int(arr[2 * C + 3 * K])
        k_eff = int(np.argmax(adv)) + 1 if adv.any() else K
        found: List[FoundKey] = []
        if ncand > C:
            found += self._host_rescan_fast(step0, k_eff)
        for c in np.nonzero(pos < K * U)[0]:
            s_local, u0 = divmod(int(pos[c]), U)
            j = (step0 + s_local) * U + u0
            if j >= self._fast_total_idx:
                continue
            key = self._fast_key(j)
            b = int(bits[c])
            q = 0
            while b:
                if b & 1:
                    e = q // self._parities
                    cand = key * lam_pow[e] % ecref.N
                    fk = self._verify(cand, 0)
                    if fk:
                        found.append(fk)
                b >>= 1
                q += 1
        for s_local in np.nonzero(n_deg > 0)[0]:
            s_local = int(s_local)
            if int(n_deg[s_local]) > 1:
                # more than one degenerate lane (only possible on garbage
                # post-advance-degeneracy steps): exact rescan of the step
                found += self._host_rescan_fast(step0 + s_local, 1)
                continue
            j = (step0 + s_local) * U + int(first_deg[s_local])
            if j < self._fast_total_idx:
                fk = self._verify(self._fast_key(j), 0)
                if fk:
                    found.append(fk)
        return k_eff, found

    def _host_rescan_fast(self, step0: int, k: int) -> List[FoundKey]:
        """Exact host re-scan of k device steps (incremental python-int
        walk + per-key artifact compare). Near-never event: candidate
        compaction overflow or a base point at infinity."""
        p = self.p
        j0 = step0 * p.block_u
        j1 = min((step0 + k) * p.block_u, self._fast_total_idx)
        lam_pow = _LAM_POW
        rawset = set(self.targets.raw)
        step_pt = ecref.scalar_mult(self.stride)
        found: List[FoundKey] = []
        pt = None
        key = self._fast_key(j0)
        for j in range(j0, j1):
            kk = key % ecref.N
            if pt is None:
                pt = ecref.scalar_mult(kk) if kk else None
            if pt is not None:
                x, y = pt
                for e in range(self._n_endo_fast):
                    xv = x * pow(ecref.BETA, e, ecref.P) % ecref.P
                    arts = []
                    if self.mode == "xpoint":
                        arts = [xv.to_bytes(32, "big")]
                    elif self.mode in ("rmd160", "rmd160_both"):
                        arts = [
                            hashref.hash160(bytes([pfx]) + xv.to_bytes(32, "big"))
                            for pfx in (2, 3)
                        ]
                    if self.mode in ("address_u", "rmd160_both"):
                        arts.append(
                            hashref.pubkey_to_hash160((xv, y), compressed=False)
                        )
                    elif self.mode == "eth":
                        arts = [hashref.pubkey_to_eth_address((xv, y))]
                    match = any(a in rawset for a in arts) or any(
                        lo20[:8] <= a[:8] <= hi20[:8]
                        for a in arts
                        for lo20, hi20 in self.intervals
                    )
                    if match:
                        fk = self._verify(kk * lam_pow[e] % ecref.N, 0)
                        if fk:
                            found.append(fk)
            key += self.stride
            nxt = key % ecref.N
            pt = (
                ecref.point_add(pt, step_pt)
                if pt is not None
                else (ecref.scalar_mult(nxt) if nxt else None)
            )
        return found

    # ------------------------------------------------------------------

    def _key_for_lane(self, base_idx: int, s: int, lane: int) -> int:
        """Scalar for point lane of step s from window-start index base_idx:
        lanes 0..U-1 = +u, U..2U-1 = -u, 2U = center."""
        u = self.p.block_u
        center = base_idx + s * self.window + u
        if lane < u:
            idx = center + (lane + 1)
        elif lane < 2 * u:
            idx = center - (lane - u + 1)
        else:
            idx = center
        return self.a + idx * self.stride

    def _artifacts(self, pt):
        """[(artifact bytes, compressed?)] the mode checks per point."""
        if self.mode == "xpoint":
            return [(pt[0].to_bytes(32, "big"), True)]
        if self.mode == "rmd160":
            return [(hashref.pubkey_to_hash160(pt, compressed=True), True)]
        if self.mode == "address_u":
            return [(hashref.pubkey_to_hash160(pt, compressed=False), False)]
        if self.mode == "rmd160_both":
            return [
                (hashref.pubkey_to_hash160(pt, compressed=True), True),
                (hashref.pubkey_to_hash160(pt, compressed=False), False),
            ]
        return [(hashref.pubkey_to_eth_address(pt), True)]  # eth

    def _reverify_saved(self, ck, existing: List[FoundKey]) -> List[FoundKey]:
        """Keys persisted by an interrupted --all run, re-verified: the
        resumed run skips their chunks, so the return value (and thus
        KEYFOUNDKEYFOUND.txt, written by the CLI from it) would
        otherwise silently lose them (round-4 review finding). Keys
        already in `existing` are skipped — the prefix-edge loop can
        have re-found one before the checkpoint loads, and brute has no
        final dedupe pass."""
        have = {f.private_key for f in existing}
        out: List[FoundKey] = []
        for h in (ck.found if ck is not None else []):
            k = int(h, 16)
            if k in have:
                continue
            f = self._verify(k, 0)
            if f is not None and f.private_key not in have:
                have.add(f.private_key)
                out.append(f)
        return out

    def _verify(self, k: int, row: int) -> Optional[FoundKey]:
        """Exact host check of candidate scalar k: exact target match
        first, then vanity-prefix match (interval hits)."""
        for cand in (k, ecref.N - (k % ecref.N)):
            if not (1 <= cand < ecref.N):
                continue
            pt = ecref.scalar_mult(cand)
            for got, compressed in self._artifacts(pt):
                i = self._raw_index.get(got)
                if i is not None:
                    return FoundKey(
                        private_key=cand,
                        pubkey=pt,
                        compressed=compressed,
                        target=self.targets.labels[i],
                    )
                if self.prefixes and self.mode != "xpoint":
                    addr = hashref.b58check_encode(b"\x00" + got)
                    for pref in self.prefixes:
                        if addr.startswith(pref):
                            return FoundKey(
                                private_key=cand,
                                pubkey=pt,
                                compressed=compressed,
                                target=addr,
                            )
        return None

    def search(
        self,
        max_steps: Optional[int] = None,
        stop_on_first: bool = False,
        progress_every: int = 0,
        checkpoint=None,
        max_seconds: Optional[float] = None,
    ) -> List[FoundKey]:
        if self._fast:
            return self._search_fused(
                max_steps, stop_on_first, progress_every, checkpoint,
                max_seconds,
            )
        p = self.p
        dl = Deadline(max_seconds)
        total = self.steps_per_walker if max_steps is None else min(
            self.steps_per_walker, max_steps
        )
        W = p.walkers
        U = p.block_u
        C = p.cand_max
        npts = self.window
        lam_pow = _LAM_POW
        parities = {"rmd160": 2, "rmd160_both": 3}.get(self.mode, 1)
        found: List[FoundKey] = []
        seen = set()
        step = 0
        rng = np.random.default_rng(p.seed) if p.random_mode else None
        # chunks per random base (reference -n/N_SEQUENTIAL_MAX): each
        # walker scans that many sequential keys from its random base
        # before re-choosing; a chunk covers K windows per walker
        cpb = 1
        if rng is not None and p.seq_per_base:
            cpb = max(1, math.ceil(
                p.seq_per_base / (p.steps_per_chunk * self.window)
            ))
        chunks_since_base = 0
        ck = None
        if checkpoint is not None:
            ck, resumed = self._ckpt_load(checkpoint)
            found += self._reverify_saved(ck, found)
            if rng is not None:
                draws = math.ceil((resumed // p.steps_per_chunk) / cpb)
                for _ in range(draws):
                    rng.integers(
                        0, max(1, self.total_steps - p.steps_per_chunk),
                        size=p.walkers,
                    )
                step = min(resumed, total)
            else:
                step = min(resumed, total)
        bases = self._sequential_bases(step)
        base_pts = self._centers_for_bases(bases)
        cx, cy = base_pts.x, base_pts.y
        n_found_saved = 0
        while step < total:
            if dl.expired():
                # time-bounded search: stop at the chunk boundary and
                # persist exactly-covered progress (resume re-enters here)
                self._ckpt_save(
                    checkpoint, ck, step, self.stats, found, False,
                    force=True,
                )
                break
            k = min(p.steps_per_chunk, total - step)
            if rng is not None:
                # random mode: each walker re-bases to a uniform
                # window-aligned position anywhere in the range
                # (reference -R random base claims, keyhunt.cpp:2547-2568)
                # and scans K consecutive windows per chunk; with -n
                # (seq_per_base) it keeps the chained walk for cpb chunks
                # before re-choosing, like the reference's sequential-N
                # scan from each random base.
                max_start = max(1, self.total_steps - p.steps_per_chunk)
                overrun = any(
                    b // self.window + p.steps_per_chunk > self.total_steps
                    for b in bases
                )
                if chunks_since_base % cpb == 0 or overrun:
                    starts = rng.integers(0, max_start, size=p.walkers)
                    bases = [int(s0) * self.window for s0 in starts]
                    base_pts = self._centers_for_bases(bases)
                    cx, cy = base_pts.x, base_pts.y
                    chunks_since_base = 0
                chunks_since_base += 1
            cx, cy, outs = self._chunk_fn(cx, cy)
            arr = np.asarray(outs)  # (K, 2C + 3W + 1) — one transfer
            cand_pos = arr[:, :C]
            cand_row = arr[:, C : 2 * C].view(np.uint32)
            n_deg = arr[:, 2 * C : 2 * C + W]
            first_deg = arr[:, 2 * C + W : 2 * C + 2 * W]
            adv_deg = arr[:, 2 * C + 2 * W : 2 * C + 3 * W]
            ncand = arr[:, 2 * C + 3 * W]
            total_q = self.n_qsets * W * npts
            for s in range(k):
                if ncand[s] > C:
                    found += self._host_rescan_step(bases, s)
                for c in np.nonzero(cand_pos[s] < total_q)[0]:
                    pos = int(cand_pos[s, c])
                    q, rem = divmod(pos, W * npts)
                    w, lane = divmod(rem, npts)
                    e = q // parities  # endomorphism power
                    cand = self._key_for_lane(bases[w], s, lane)
                    if e:
                        cand = cand * lam_pow[e] % ecref.N
                    fk = self._verify(cand, int(cand_row[s, c]))
                    if fk and fk.private_key not in seen:
                        seen.add(fk.private_key)
                        found.append(fk)
                        if stop_on_first:
                            return found
                for w in range(W):
                    offs = []
                    if n_deg[s, w] > 0:
                        offs.append(int(first_deg[s, w]) + 1)
                    if adv_deg[s, w]:
                        offs.append(self.window)
                    for off in offs:
                        # degenerate lane: x(center) == x(off*stride*G),
                        # so the center scalar c is +-off*stride mod n;
                        # also the doubling lane 2c.
                        c0 = self._key_for_lane(bases[w], s, 2 * U)
                        d = off * self.stride % ecref.N
                        for cand in (d, ecref.N - d, (2 * c0) % ecref.N):
                            fk = self._verify(cand, 0)
                            if fk and fk.private_key not in seen:
                                seen.add(fk.private_key)
                                found.append(fk)
            rebase = bool(adv_deg[:k].any())
            self.stats.add(k * p.walkers * self.window)
            step += p.steps_per_chunk
            self._ckpt_save(
                checkpoint, ck, step, self.stats, found,
                len(found) > n_found_saved, force=step >= total,
            )
            n_found_saved = len(found)
            if rng is None or chunks_since_base % cpb != 0:
                # advance bases for the next chunk (sequential scan, or a
                # -n group continuation on the same random base)
                bases = [b + p.steps_per_chunk * self.window for b in bases]
                if rebase and step < total:
                    base_pts = self._centers_for_bases(bases)
                    cx, cy = base_pts.x, base_pts.y
            if progress_every and (step // p.steps_per_chunk) % progress_every == 0:
                print(f"[brute] step {step}/{total} {self.stats.human()}")
        return found

    def _host_rescan_step(self, bases: Sequence[int], s: int) -> List[FoundKey]:
        """Exact host re-scan of one device step (probe-survivor overflow):
        every key in every walker's window is derived and verified against
        the full target set with python-int math."""
        found = []
        for w in range(self.p.walkers):
            for lane in range(self.window):
                cand = self._key_for_lane(bases[w], s, lane)
                fk = self._verify(cand, 0)
                if fk:
                    found.append(fk)
        return found


# ---------------------------------------------------------------------------
# Module-level jitted chunk (same discipline as engine/bsgs.py: static
# config via static_argnames, device arrays as arguments, traced once per
# config per process).
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=(
        "W", "U", "K", "C", "chain", "mode", "needs_y", "n_endo", "nq",
        "bits_log2",
    ),
)
def _brute_chunk_impl(cx, cy, tab_x, tab_y, adv_x, adv_y, words, thi, tlo, tidx,
                      *, W, U, K, C, chain, mode, needs_y, n_endo, nq,
                      bits_log2):
    bitmap = bmp.DeviceBitmap(words, bits_log2)
    table = st.SortedXTable(thi, tlo, tidx)
    npts = 2 * U + 1
    beta = fe.from_int(ecref.BETA)
    beta2 = fe.from_int(ecref.BETA * ecref.BETA % ecref.P)

    def body(carry, _):
        cx, cy = carry
        ctr = points.PointBatch(cx, cy, jnp.zeros((W,), dtype=bool))
        res = walk.walk_fused(
            ctr, tab_x, tab_y, adv_x, adv_y,
            symmetric=True, need_y=needs_y, chain_len=chain,
        )
        x_all = jnp.concatenate(
            [res.x_plus, res.x_minus, cx[:, None, :]], axis=1
        )  # (W, npts, 8)
        variants = [x_all]
        if n_endo == 3:
            variants.append(fe.mul_mod_p(x_all, beta))
            variants.append(fe.mul_mod_p(x_all, beta2))
        qhis, qlos = [], []
        if mode == "xpoint":
            for xv in variants:
                qhi, qlo = st.trunc64_from_limbs(xv)
                qhis.append(qhi.reshape(-1))
                qlos.append(qlo.reshape(-1))
        elif mode == "rmd160":
            for xv in variants:
                even, odd = hash160_from_x_both_parities(xv)
                qhis.append(even[1].reshape(-1))
                qlos.append(even[0].reshape(-1))
                qhis.append(odd[1].reshape(-1))
                qlos.append(odd[0].reshape(-1))
        elif mode == "rmd160_both":  # -l both: compressed pair + uncompressed
            y_all = jnp.concatenate(
                [res.y_plus, res.y_minus, cy[:, None, :]], axis=1
            )
            for xv in variants:
                even, odd = hash160_from_x_both_parities(xv)
                qhis += [even[1].reshape(-1), odd[1].reshape(-1)]
                qlos += [even[0].reshape(-1), odd[0].reshape(-1)]
                wds = hash160_from_xy(xv, y_all)
                qhis.append(wds[1].reshape(-1))
                qlos.append(wds[0].reshape(-1))
        else:  # eth / address_u hash x||y
            y_all = jnp.concatenate(
                [res.y_plus, res.y_minus, cy[:, None, :]], axis=1
            )
            for xv in variants:
                wds = (
                    keccak256_pubkey64(xv, y_all)
                    if mode == "eth"
                    else hash160_from_xy(xv, y_all)
                )
                qhis.append(wds[1].reshape(-1))
                qlos.append(wds[0].reshape(-1))
        qhi = jnp.concatenate(qhis)  # (nq * W * npts,)
        qlo = jnp.concatenate(qlos)
        fl = bmp.filtered_lookup(bitmap, table, qhi, qlo, C)
        # mask hits on degenerate walk lanes (garbage x): lane layout is
        # [0..U-1]=+u, [U..2U-1]=-u (both invalid when deg[u]), [2U]=center
        degm = jnp.concatenate(
            [res.degenerate, res.degenerate, jnp.zeros((W, 1), dtype=bool)],
            axis=1,
        ).reshape(-1)  # (W * npts,)
        total = nq * W * npts
        pos_safe = jnp.minimum(fl.pos, total - 1)
        live = ~degm[pos_safe % (W * npts)]
        hitmask = (fl.result.found | fl.result.found2) & live
        cand_pos = jnp.where(hitmask, fl.pos, total)
        cand_row = jnp.where(hitmask, fl.result.idx, 0)
        n_deg = res.degenerate.sum(axis=1).astype(jnp.int32)  # (W,)
        first_deg = jnp.argmax(res.degenerate, axis=1).astype(jnp.int32)
        out = jnp.concatenate(
            [
                cand_pos.astype(jnp.int32),
                cand_row.astype(jnp.int32),
                n_deg,
                first_deg,
                res.adv_degenerate.astype(jnp.int32),
                fl.n_candidates[None],
            ]
        )  # (2C + 3W + 1,)
        return (res.adv_x, res.adv_y), out

    (cx, cy), outs = jax.lax.scan(body, (cx, cy), None, length=K)
    return cx, cy, outs  # (K, 2C + 3W + 1)
