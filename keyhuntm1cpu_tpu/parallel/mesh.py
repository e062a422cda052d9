"""shard_map'd BSGS search over a device mesh.

Data-parallel range sharding (SURVEY.md §2.4 row 1): the scalar range is
statically partitioned into window-aligned slices, one per device on the
'shard' mesh axis. Baby/stride tables are replicated (they are read-only,
like the reference's shared bloom+bPtable, keyhunt.cpp:1216-1304); every
device walks its own giant-step chain; per-chunk hit counts are psum'd
across the devices so the host driver reads ONE replicated scalar to decide whether
to decode the per-device summaries.

Scales to multi-host the same way: under jax.distributed each process
holds its devices' shards of the same global arrays; nothing here is
host-count-specific.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..curve import points, walk
from ..engine.bsgs import BSGSEngine, BSGSParams, _ImmediateHit
from ..engine.common import Deadline, FoundKey
from ..filter import bitmap as bmp
from ..filter import sorted_table as st
from .partition import RangePartitioner, RangeSlice


class ShardedBSGSEngine(BSGSEngine):
    """BSGS with the range sharded across all devices of a mesh."""

    def __init__(
        self,
        pubkeys: Sequence[Tuple[int, int]],
        range_start: int,
        range_end: int,
        params: BSGSParams = BSGSParams(),
        table: Optional[st.SortedXTable] = None,
        devices: Optional[list] = None,
    ):
        super().__init__(pubkeys, range_start, range_end, params, table=table)
        devs = devices if devices is not None else jax.devices()
        self.mesh = Mesh(np.array(devs), ("shard",))
        self.n_shards = len(devs)
        window = params.block_u * self.stride
        self.slices: List[RangeSlice] = RangePartitioner.split_equal(
            range_start, range_end, self.n_shards, window
        )
        self.local_steps = max(
            1, math.ceil(max(1, math.ceil((range_end - range_start) / window)) / self.n_shards)
        )
        self._sharded_chunk = self._make_sharded_chunk()

    def _initial_bases_sharded(self, step: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(D, T, 8) x2 P_base per shard at local step offset `step`."""
        xs, ys = [], []
        for sl in self.slices:
            base = self._initial_base(sl.step0 + step)
            xs.append(base.x)
            ys.append(base.y)
        px = jnp.stack(xs)  # (D, T, 8)
        py = jnp.stack(ys)
        sharding = jax.sharding.NamedSharding(self.mesh, P("shard"))
        return jax.device_put(px, sharding), jax.device_put(py, sharding)

    def _make_sharded_chunk(self):
        T = len(self.targets)
        U = self.p.block_u
        K = self.p.steps_per_chunk
        chain = self.p.chain_len
        C = self.p.cand_max
        bits_log2 = self.bitmap.bits_log2
        # level-2 hashed bloom between the bitmap and the exact search
        # (filter/bitmap.py DeviceBloom2) — the range-sharded engine
        # replicates the FULL table per device, so large m degrades the
        # capped bitmap's fp exactly like the single-device engine
        expected = T * U * self.p.m // (1 << bits_log2)
        use2 = (self.p.cascade2 == "on"
                or (self.p.cascade2 == "auto" and expected > 1024))
        if use2:
            from ..engine.bsgs import _bloom2_for_table
            self._bloom2 = _bloom2_for_table(self.table.hi, self.table.lo)
            C1 = max(C, ((expected + 8 * int(expected ** 0.5) + 511)
                         // 512) * 512)
        else:
            self._bloom2 = None
            C1 = None
        b2_bits = self._bloom2.bits_log2 if use2 else 0

        def local_chunk(px, py, tab_x, tab_y, adv_x, adv_y, words, thi, tlo,
                        tidx, words2=None):
            """px/py: (1, T, 8) local shard state; tables/bitmap are
            replicated args (P() specs) — closures would embed them in the
            serialized HLO (remote compile rejects a 512 MB payload)."""
            bitmap = bmp.DeviceBitmap(words, bits_log2)
            table = st.SortedXTable(thi, tlo, tidx)
            bloom2 = (bmp.DeviceBloom2(words2, b2_bits)
                      if words2 is not None else None)
            px = px.reshape(T, 8)
            py = py.reshape(T, 8)

            def body(carry, _):
                cx, cy = carry
                pb = points.PointBatch(cx, cy, jnp.zeros((T,), dtype=bool))
                res = walk.walk_fused(pb, tab_x, tab_y, adv_x, adv_y, chain_len=chain)
                qhi, qlo = st.trunc64_from_limbs(res.x_plus)
                fl = bmp.filtered_lookup(
                    bitmap, table, qhi.reshape(-1), qlo.reshape(-1), C,
                    bm2=bloom2, stage1_max=C1,
                )
                deg_flat = res.degenerate.reshape(-1)
                pos_safe = jnp.minimum(fl.pos, T * U - 1)
                live = ~deg_flat[pos_safe]
                cand_pos = jnp.where(
                    (fl.result.found | fl.result.found2) & live, fl.pos, T * U
                )
                cand_j = jnp.where(fl.result.found & live, fl.result.idx, 0)
                cand_j2 = jnp.where(fl.result.found2 & live, fl.result.idx2, 0)
                deg = res.degenerate.at[:, U - 1].set(
                    res.degenerate[:, U - 1] | res.adv_degenerate
                )
                n_deg = deg.sum(axis=1).astype(jnp.int32)
                first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
                degsum = jnp.stack(
                    [n_deg, first_deg, res.adv_degenerate.astype(jnp.int32)]
                )
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
            # outs: (K, 3C+3T+1); replicated interest flag (psum)
            cand_pos = outs[:, :C]
            degsum_n = outs[:, 3 * C : 3 * C + T]
            ncand = outs[:, 3 * C + 3 * T]
            local_interest = (
                (cand_pos < T * U).sum() + degsum_n.sum() + (ncand > C).sum()
            )
            total_interest = jax.lax.psum(local_interest, "shard")
            return px[None], py[None], outs[None], total_interest

        extra = (self._bloom2.words,) if use2 else ()
        smapped = shard_map(
            local_chunk,
            mesh=self.mesh,
            in_specs=(P("shard"), P("shard")) + (P(),) * (8 + len(extra)),
            out_specs=(
                P("shard"),
                P("shard"),
                P("shard"),
                P(),
            ),
            check_vma=False,
        )
        jitted = jax.jit(smapped)

        def chunk(px, py):
            return jitted(
                px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
                self.bitmap.words, self.table.hi, self.table.lo, self.table.idx,
                *extra,
            )

        return chunk

    def _decode_sharded(self, arr, step: int, k: int):
        """(found, rebase) from one (D, K, summary) chunk array."""
        found: List[FoundKey] = []
        rebase = False
        for d, sl in enumerate(self.slices):
            parts = self._split_summary(arr[d])
            found += self._decode_chunk(sl.step0 + step, k, *parts)
            adv = parts[3][:k, 2]
            if adv.any():
                rebase = True
                # steps after this shard's mid-chunk advance degeneracy
                # walked garbage state: rescan them exactly (the single-
                # device engine does the same in _consume_summary)
                s_first = int(np.argmax(adv.any(axis=-1)))
                for s_ in range(s_first + 1, k):
                    found += self._host_rescan_step(sl.step0 + step + s_)
        return found, rebase

    def search_sharded(
        self,
        max_steps: Optional[int] = None,
        stop_on_first: bool = True,
        progress_every: int = 0,
        max_seconds: Optional[float] = None,
        checkpoint=None,
    ) -> List[FoundKey]:
        """Pipelined mesh search: chunks dispatch pipeline_depth ahead
        with async host copies of the summaries and the psum'd interest
        flag, so neither pull serializes the loop on a host round trip;
        only interesting chunks are decoded.

        checkpoint: optional core.CheckpointManager. The local-step
        schedule is deterministic (all shards advance in lock step), so
        progress is just the count of DECODED chunks; a resumed run
        re-bases every shard at the saved local step and continues —
        first-class position persistence for preempted pod-slice runs
        (the reference had this only in an ops script,
        vastai_deploy.sh:88-106; IBSGSEngine::save/load_checkpoint is
        bodiless, include/keyhunt/core/bsgs.h:193-198)."""
        p = self.p
        dl = Deadline(max_seconds)
        K = p.steps_per_chunk
        total = self.local_steps if max_steps is None else min(self.local_steps, max_steps)
        found: List[FoundKey] = []

        resume_step = 0
        ck = None
        if checkpoint is not None:
            from ..core.checkpoint import Checkpoint, fingerprint

            # n_shards is part of the run identity: the step -> key-range
            # mapping goes through the per-shard slices
            params_fp = fingerprint(
                p.m, p.block_u, p.steps_per_chunk, self.n_shards,
                type(self).__name__,
            )
            targets_fp = fingerprint(sorted(self.targets))
            ck = checkpoint.load()
            if ck is not None:
                checkpoint.matches(
                    ck,
                    mode="bsgs-sharded",
                    range_start=self.a,
                    range_end=self.b,
                    policy="sequential",
                    seed=0,
                    params_fp=params_fp,
                    targets_fp=targets_fp,
                )
                resume_step = ck.chunks_done * K
                self.stats.add(ck.keys_covered)
                # re-surface keys the interrupted run persisted: resume
                # skips their chunks, so nothing else re-derives them
                found += self._try_candidates_all(
                    [int(h, 16) for h in ck.found]
                )
            else:
                ck = Checkpoint(
                    mode="bsgs-sharded",
                    range_start=self.a,
                    range_end=self.b,
                    policy="sequential",
                    seed=0,
                    params_fp=params_fp,
                    targets_fp=targets_fp,
                    n_chunks=math.ceil(total / K),
                )
            if resume_step >= total:
                return found

        def _save(force: bool = False) -> None:
            if ck is None:
                return
            ck.keys_covered = self.stats.keys_covered
            if found:
                ck.found = sorted(
                    set(ck.found) | {f"{f.private_key:x}" for f in found}
                )
            checkpoint.save(ck, force=force)

        px = py = None
        while px is None:
            try:
                px, py = self._initial_bases_sharded(resume_step)
            except _ImmediateHit as hit:
                # some shard's base center IS a target key: record it
                # (the range filter may drop it) and never abandon the
                # scan — rescan every shard's chunk at this local step
                # exactly on the host, then advance one chunk boundary
                found += self._try_candidates_all([hit.scalar])
                if found and stop_on_first:
                    return self._dedupe(found)
                k0 = min(K, total - resume_step)
                for sl in self.slices:
                    for s_ in range(resume_step, resume_step + k0):
                        found += self._host_rescan_step(sl.step0 + s_)
                self.stats.add(k0 * self.n_shards * p.block_u * self.stride)
                found = self._dedupe(found)
                if found and stop_on_first:
                    return found
                resume_step += K
                if ck is not None:
                    ck.chunks_done = resume_step // K
                    _save(force=True)
                if resume_step >= total:
                    return found
        pending: deque = deque()
        disp = resume_step
        n_done = 0
        while pending or disp < total:
            while (
                disp < total
                and len(pending) < p.pipeline_depth
                and not dl.expired()
            ):
                px, py, outs, interest = self._sharded_chunk(px, py)
                outs.copy_to_host_async()
                interest.copy_to_host_async()
                pending.append((disp, outs, interest))
                disp += K
            if not pending:
                # deadline cut dispatch with nothing in flight: persist
                # exactly-completed progress before returning
                _save(force=True)
                break
            step, outs, interest = pending.popleft()
            k = min(K, total - step)
            rebase = False
            new_found: List[FoundKey] = []
            if int(np.asarray(interest)) > 0:
                arr = np.asarray(outs)  # (D, K, summary)
                new_found, rebase = self._decode_sharded(arr, step, k)
                if new_found:
                    found = self._dedupe(found + new_found)
                    if stop_on_first:
                        self.stats.add(k * self.n_shards * p.block_u * self.stride)
                        if ck is not None:
                            ck.chunks_done = step // K + 1
                            _save(force=True)
                        return found
            self.stats.add(k * self.n_shards * p.block_u * self.stride)
            n_done += 1
            if ck is not None:
                ck.chunks_done = step // K + 1
                # keys found with --all force a write: a crash after this
                # chunk must not lose them (resume skips the chunk)
                _save(force=bool(rebase) or bool(new_found)
                      or step + K >= total)
            if rebase and step + K < total:
                # some shard's advance degenerated: drop everything
                # dispatched after it and rebase all shards exactly
                pending.clear()
                disp = step + K
                try:
                    px, py = self._initial_bases_sharded(disp)
                except _ImmediateHit as hit:
                    found += self._try_candidates_all([hit.scalar])
                    if found and stop_on_first:
                        return self._dedupe(found)
                    while disp < total:
                        # the chunk anchored at the degenerate base was
                        # never walked: rescan it exactly on the host
                        k0 = min(K, total - disp)
                        for sl in self.slices:
                            for s_ in range(disp, disp + k0):
                                found += self._host_rescan_step(
                                    sl.step0 + s_
                                )
                        self.stats.add(
                            k0 * self.n_shards * p.block_u * self.stride
                        )
                        found = self._dedupe(found)
                        if found and stop_on_first:
                            return found
                        disp += K
                        try:
                            px, py = self._initial_bases_sharded(disp)
                            break
                        except _ImmediateHit as hit2:
                            found += self._try_candidates_all([hit2.scalar])
            if progress_every and n_done % progress_every == 0:
                print(f"[bsgs-sharded] local step {step + K}/{total} {self.stats.human()}")
        return found

    @staticmethod
    def _dedupe(found: List[FoundKey]) -> List[FoundKey]:
        seen = {}
        for f in found:
            seen[(f.private_key, f.target)] = f
        return list(seen.values())


class ShardedTableBSGSEngine(ShardedBSGSEngine):
    """BSGS with the BABY TABLE (and its bitmap) sharded across devices.

    The replicated-table engine caps m at one chip's HBM; here each device
    owns a contiguous slice of the sorted table plus a bitmap sized for
    its slice only (total memory across the mesh = one global structure,
    so m scales with device count — SURVEY.md §2.4's "shard the big
    shared thing", the reference's 256-way first-byte bloom sharding,
    keyhunt.cpp:1216-1304, lifted to the mesh).

    Membership becomes a collective: every device walks its own range
    slice, all-gathers the (qhi, qlo) truncations each step, and
    probes its LOCAL shard for ALL devices' queries — a query's key lives
    on exactly one shard, so per-device hits are disjoint and the union
    (host-side decode over the (prober, ...) summary axis) is exact.
    """

    def __init__(
        self,
        pubkeys: Sequence[Tuple[int, int]],
        range_start: int,
        range_end: int,
        params: BSGSParams = BSGSParams(),
        table: Optional[st.SortedXTable] = None,
        devices: Optional[list] = None,
    ):
        devs = devices if devices is not None else jax.devices()
        d = len(devs)
        # skip the parent's GLOBAL bitmap build (the whole point is that
        # no single device holds the global structure)
        dummy = bmp.DeviceBitmap(jnp.zeros(1, dtype=jnp.uint32), 5)
        BSGSEngine.__init__(
            self, pubkeys, range_start, range_end, params, table=table,
            bitmap=dummy,
        )
        self.mesh = Mesh(np.array(devs), ("shard",))
        self.n_shards = d
        window = params.block_u * self.stride
        self.slices = RangePartitioner.split_equal(
            range_start, range_end, d, window
        )
        self.local_steps = max(
            1,
            math.ceil(
                max(1, math.ceil((range_end - range_start) / window)) / d
            ),
        )
        self._shard_structures()
        self._sharded_chunk = self._make_sharded_table_chunk()

    def _make_chunk_fn(self):
        """The parent's single-device chunk is never used here (search /
        search_scheduled raise): building it against the dummy bitmap
        would eagerly jit dead graphs AND construct a full-table bloom2
        (the dummy's bits_log2=5 makes `expected` enormous, tripping the
        cascade2 auto threshold) — a seconds-long 2m device sort plus
        ~1.5 GB pinned in _BLOOM2_CACHE, defeating this engine's 1/D
        memory scaling (round-4 review finding)."""
        self._bloom2 = None
        return None

    def search(self, *a, **kw):
        raise NotImplementedError(
            "ShardedTableBSGSEngine has no single-device search (the "
            "table lives sharded across the mesh) — use search_sharded()"
        )

    def search_scheduled(self, *a, **kw):
        raise NotImplementedError(
            "ShardedTableBSGSEngine has no single-device search (the "
            "table lives sharded across the mesh) — use search_sharded()"
        )

    def _shard_structures(self) -> None:
        """Slice the sorted table into D contiguous row shards (sorted
        order = contiguous 64-bit key ranges) and build one bitmap per
        shard sized for its slice (bits_global - log2 D)."""
        d = self.n_shards
        hi = np.asarray(self.table.hi)
        lo = np.asarray(self.table.lo)
        idx = np.asarray(self.table.idx)
        m = len(hi)
        rows = -(-m // d)
        pad = rows * d - m
        if pad:
            # sentinel padding: max key with payload 0 (j = 0 is invalid
            # and ignored by the decoder)
            hi = np.concatenate([hi, np.full(pad, 0xFFFFFFFF, np.uint32)])
            lo = np.concatenate([lo, np.full(pad, 0xFFFFFFFF, np.uint32)])
            idx = np.concatenate([idx, np.zeros(pad, np.uint32)])
        self._shard_bits = (
            self.p.bits_log2
            if self.p.bits_log2 is not None
            else bmp.default_bits_log2(rows)
        )
        shard = jax.sharding.NamedSharding(self.mesh, P("shard"))
        self.tbl_hi = jax.device_put(hi.reshape(d, rows), shard)
        self.tbl_lo = jax.device_put(lo.reshape(d, rows), shard)
        self.tbl_idx = jax.device_put(idx.reshape(d, rows), shard)
        words = np.stack([
            np.asarray(
                bmp.build_bitmap(
                    hi[s * rows : (s + 1) * rows],
                    lo[s * rows : (s + 1) * rows],
                    self._shard_bits,
                    on_device=False,
                ).words
            )
            for s in range(d)
        ])
        self.bmp_words = jax.device_put(words, shard)
        # per-shard level-2 bloom: every device probes ALL devices'
        # all-gathered queries against its local shard, so the probe
        # width is D*T*U and large m degrades the capped shard bitmap's
        # fp exactly like the single-device engine (same threshold)
        expected = (d * len(self.targets) * self.p.block_u * rows
                    // (1 << self._shard_bits))
        self._use_bloom2 = (self.p.cascade2 == "on"
                            or (self.p.cascade2 == "auto"
                                and expected > 1024))
        self._shard_expected = expected
        if self._use_bloom2:
            self._shard_b2_bits = bmp.bloom2_bits_log2(rows)
            b2w = np.stack([
                np.asarray(bmp.build_bloom2_host(
                    hi[s * rows : (s + 1) * rows],
                    lo[s * rows : (s + 1) * rows],
                    self._shard_b2_bits,
                ).words)
                for s in range(d)
            ])
            self.b2_words = jax.device_put(b2w, shard)
        else:
            self.b2_words = None
        # keep only a HOST copy of the global table (exact-rescan dict +
        # persistence); holding the full device copy on device 0 would
        # defeat the memory scaling this engine exists for
        self.table = st.SortedXTable(hi[: m], lo[: m], idx[: m])

    def _make_sharded_table_chunk(self):
        T = len(self.targets)
        U = self.p.block_u
        K = self.p.steps_per_chunk
        chain = self.p.chain_len
        C = self.p.cand_max
        D = self.n_shards
        bits = self._shard_bits
        if self.p.table_comm not in ("all_gather", "ring"):
            raise ValueError(
                f"table_comm must be all_gather or ring, "
                f"got {self.p.table_comm!r}"
            )
        ring = self.p.table_comm == "ring"
        use2 = self._use_bloom2
        if use2:
            exp = self._shard_expected
            # ring probes per-hop (T*U) widths: size stage 1 per hop
            exp = max(1, exp // D) if ring else exp
            C1 = max(C, ((exp + 8 * int(exp ** 0.5) + 511) // 512) * 512)
            b2_bits = self._shard_b2_bits
        else:
            C1 = None
            b2_bits = 0

        def local_chunk(px, py, tab_x, tab_y, adv_x, adv_y, words, thi, tlo,
                        tidx, words2=None):
            """px/py: (1, T, 8) local walk state; words/t*: (1, ...) local
            table/bitmap shard; tab/adv: replicated walk constants."""
            bitmap = bmp.DeviceBitmap(words.reshape(-1), bits)
            table = st.SortedXTable(
                thi.reshape(-1), tlo.reshape(-1), tidx.reshape(-1)
            )
            bloom2 = (bmp.DeviceBloom2(words2.reshape(-1), b2_bits)
                      if words2 is not None else None)
            px = px.reshape(T, 8)
            py = py.reshape(T, 8)

            def body(carry, _):
                cx, cy = carry
                pb = points.PointBatch(cx, cy, jnp.zeros((T,), dtype=bool))
                res = walk.walk_fused(
                    pb, tab_x, tab_y, adv_x, adv_y, chain_len=chain
                )
                qhi, qlo = st.trunc64_from_limbs(res.x_plus)  # (T, U)
                deg = res.degenerate.at[:, U - 1].set(
                    res.degenerate[:, U - 1] | res.adv_degenerate
                )
                TU = T * U
                if ring:
                    # ring-rotate schedule (SURVEY §5 long-context
                    # analog): D ppermute hops; in hop r each device
                    # probes the block that ORIGINATED at device
                    # (my - r) mod D against its local shard, then
                    # passes it on. Peak query memory 1/D of the
                    # all_gather path; each hop's transfer overlaps the
                    # current probe. Hits stay disjoint across shards,
                    # so positions in origin-major global space make
                    # the summary IDENTICAL to the all_gather layout.
                    my = jax.lax.axis_index("shard")
                    perm = [(i, (i + 1) % D) for i in range(D)]

                    def probe_round(r, qh, ql, dg, accs):
                        gpos_a, j_a, j2_a, nmax = accs
                        origin = (my - r) % D
                        fl = bmp.filtered_lookup(
                            bitmap, table, qh, ql, C,
                            bm2=bloom2, stage1_max=C1,
                        )
                        live = dg[jnp.minimum(fl.pos, TU - 1)] == 0
                        hit = (fl.result.found | fl.result.found2) & live
                        valid = hit & (fl.pos < TU)
                        gpos = jnp.where(
                            valid, origin * TU + fl.pos, D * TU
                        ).astype(jnp.int32)
                        jv = jnp.where(fl.result.found & live,
                                       fl.result.idx, 0).astype(jnp.int32)
                        j2v = jnp.where(fl.result.found2 & live,
                                        fl.result.idx2, 0).astype(jnp.int32)
                        gpos_a = jax.lax.dynamic_update_slice(
                            gpos_a, gpos[None], (r, 0))
                        j_a = jax.lax.dynamic_update_slice(
                            j_a, jv[None], (r, 0))
                        j2_a = jax.lax.dynamic_update_slice(
                            j2_a, j2v[None], (r, 0))
                        nmax = jnp.maximum(nmax, fl.n_candidates)
                        return (gpos_a, j_a, j2_a, nmax)

                    def ring_round(r, carry):
                        qh, ql, dg, *accs = carry
                        accs = probe_round(r, qh, ql, dg, tuple(accs))
                        qh = jax.lax.ppermute(qh, "shard", perm)
                        ql = jax.lax.ppermute(ql, "shard", perm)
                        dg = jax.lax.ppermute(dg, "shard", perm)
                        return (qh, ql, dg) + accs

                    init = (
                        qhi.reshape(-1), qlo.reshape(-1),
                        deg.reshape(-1).astype(jnp.uint8),
                        jnp.full((D, C), D * TU, jnp.int32),
                        jnp.zeros((D, C), jnp.int32),
                        jnp.zeros((D, C), jnp.int32),
                        jnp.zeros((), jnp.int32),
                    )
                    # D-1 probe+permute hops, then a FINAL probe with no
                    # permute: the last hop's rotation fed only the
                    # discarded loop carry — pure dead interconnect traffic
                    (qh_f, ql_f, dg_f, *accs) = jax.lax.fori_loop(
                        0, D - 1, ring_round, init
                    )
                    (gpos_a, j_a, j2_a, nmax) = probe_round(
                        D - 1, qh_f, ql_f, dg_f, tuple(accs)
                    )
                    flat = gpos_a.reshape(-1)
                    hitmask = flat < D * TU
                    sel = bmp.compact_positions(hitmask, C, D * C)
                    safe = jnp.minimum(sel, D * C - 1)
                    ok = sel < D * C
                    cand_pos = jnp.where(ok, flat[safe], D * TU)
                    cand_j = jnp.where(ok, j_a.reshape(-1)[safe], 0)
                    cand_j2 = jnp.where(ok, j2_a.reshape(-1)[safe], 0)
                    # poison past C if any hop overflowed ITS budget or
                    # the merged total outgrew the summary width
                    n_cand = jnp.maximum(
                        nmax, hitmask.sum().astype(jnp.int32)
                    )
                else:
                    # the collective: everyone sees everyone's queries,
                    # each probes its own shard (hits are disjoint)
                    qh_all = jax.lax.all_gather(qhi.reshape(-1), "shard")
                    ql_all = jax.lax.all_gather(qlo.reshape(-1), "shard")
                    deg_all = jax.lax.all_gather(
                        deg.reshape(-1).astype(jnp.uint8), "shard"
                    )
                    fl = bmp.filtered_lookup(
                        bitmap, table, qh_all.reshape(-1),
                        ql_all.reshape(-1), C,
                        bm2=bloom2, stage1_max=C1,
                    )
                    live = deg_all.reshape(-1)[
                        jnp.minimum(fl.pos, D * T * U - 1)
                    ] == 0
                    cand_pos = jnp.where(
                        (fl.result.found | fl.result.found2) & live,
                        fl.pos,
                        D * T * U,
                    )
                    cand_j = jnp.where(
                        fl.result.found & live, fl.result.idx, 0)
                    cand_j2 = jnp.where(
                        fl.result.found2 & live, fl.result.idx2, 0)
                    n_cand = fl.n_candidates
                n_deg = deg.sum(axis=1).astype(jnp.int32)  # local walker's
                first_deg = jnp.argmax(deg, axis=1).astype(jnp.int32)
                degsum = jnp.stack(
                    [n_deg, first_deg, res.adv_degenerate.astype(jnp.int32)]
                )
                out = jnp.concatenate(
                    [
                        cand_pos.astype(jnp.int32),
                        cand_j.astype(jnp.int32),
                        cand_j2.astype(jnp.int32),
                        degsum.reshape(-1),
                        n_cand[None],
                    ]
                )  # (3C + 3T + 1,)
                return (res.adv_x, res.adv_y), out

            (px, py), outs = jax.lax.scan(body, (px, py), None, length=K)
            cand_pos = outs[:, :C]
            degsum_n = outs[:, 3 * C : 3 * C + T]
            ncand = outs[:, 3 * C + 3 * T]
            local_interest = (
                (cand_pos < D * T * U).sum() + degsum_n.sum() + (ncand > C).sum()
            )
            total_interest = jax.lax.psum(local_interest, "shard")
            return px[None], py[None], outs[None], total_interest

        extra = (self.b2_words,) if use2 else ()
        smapped = shard_map(
            local_chunk,
            mesh=self.mesh,
            in_specs=(P("shard"), P("shard")) + (P(),) * 4
            + (P("shard"),) * (4 + len(extra)),
            out_specs=(P("shard"), P("shard"), P("shard"), P()),
            check_vma=False,
        )
        jitted = jax.jit(smapped)

        def chunk(px, py):
            return jitted(
                px, py, self.tab_x, self.tab_y, self.adv_x, self.adv_y,
                self.bmp_words, self.tbl_hi, self.tbl_lo, self.tbl_idx,
                *extra,
            )

        return chunk

    def _decode_sharded(self, arr, step: int, k: int):
        """(found, rebase) from one (D_prober, K, summary) chunk array.

        Candidate positions are in the GLOBAL gathered-query space
        (source device major); walker degeneracies are local to the
        prober (= source) device."""
        p = self.p
        T = len(self.targets)
        U = p.block_u
        C = p.cand_max
        D = self.n_shards
        found: List[FoundKey] = []
        rebase = False
        adv_first: dict = {}
        for prober in range(D):
            for s in range(k):
                row = arr[prober, s]
                cand_pos = row[:C]
                cand_j = row[C : 2 * C].view(np.uint32)
                cand_j2 = row[2 * C : 3 * C].view(np.uint32)
                degsum = row[3 * C : 3 * C + 3 * T].reshape(3, T)
                ncand = int(row[3 * C + 3 * T])
                if ncand > C:
                    # overflow on this prober's shard: exact host rescan
                    # of every source's step (disjointness lost)
                    for sl in self.slices:
                        found += self._host_rescan_step(sl.step0 + step + s)
                for c in np.nonzero(cand_pos < D * T * U)[0]:
                    pos = int(cand_pos[c])
                    d_src, rem = divmod(pos, T * U)
                    t, u0 = divmod(rem, U)
                    g_step = self.slices[d_src].step0 + step + s
                    cands = []
                    for j in (int(cand_j[c]), int(cand_j2[c])):
                        if j:
                            cands += self._candidates_for_hit(g_step, u0 + 1, j)
                    found += self._try_candidates(cands, t)
                for t in range(T):
                    if degsum[0, t] > 0:
                        u = int(degsum[1, t]) + 1
                        g_step = self.slices[prober].step0 + step + s
                        found += self._try_candidates(
                            self._candidates_for_degenerate(g_step, u), t
                        )
                if degsum[2, :].any():
                    rebase = True
                    adv_first.setdefault(prober, s)
        # steps after a prober's first advance degeneracy walked garbage
        # state: rescan them exactly for that prober's slice
        for prober, s_first in adv_first.items():
            for s_ in range(s_first + 1, k):
                found += self._host_rescan_step(
                    self.slices[prober].step0 + step + s_
                )
        return found, rebase
