"""shard_map'd brute-force search over a device mesh.

Range data-parallelism for the hash/xpoint modes (SURVEY.md §2.4 row 1
applied to thread_process, keyhunt.cpp:2511-3099): the scalar range is
statically partitioned into window-aligned slices, one per device on the
'shard' mesh axis; every device runs the SAME fused walk+hash+membership
chunk (curve/pbrute.py) on its own slice, with the target words and step
tables replicated (read-only, like the reference's shared bloom+table).
A psum'd interest flag lets the host skip decoding all-quiet chunks —
one replicated scalar per chunk instead of D summaries.

Per-device index algebra, summary decoding, and exact host verification
are delegated to D child BruteEngine instances (one per slice, sharing
the memoized target structures) — the mesh layer only orchestrates the
collective chunk and the pipeline.
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..engine.brute import BruteEngine, BruteParams
from ..engine.common import Deadline, FoundKey, SearchStats
from ..utils.targets import TargetSet
from .partition import RangePartitioner


class ShardedBruteEngine:
    """Brute modes with the range sharded across all devices of a mesh.

    Children must take the fused path (params.fused is forced to 'on';
    the bitmap path has its own walker-level parallelism and no mesh
    story — use dist/ workers for CPU fleets instead).
    """

    def __init__(
        self,
        targets: TargetSet,
        range_start: int,
        range_end: int,
        mode: str = "rmd160",
        params: BruteParams = BruteParams(),
        devices: Optional[list] = None,
        intervals=None,
        prefixes=None,
    ):
        devs = devices if devices is not None else jax.devices()
        self.mesh = Mesh(np.array(devs), ("shard",))
        self.n_shards = d = len(devs)
        if params.random_mode:
            raise ValueError(
                "random mode (-R) is not available on the sharded brute "
                "mesh: shards scan their slices sequentially (use "
                "unsharded -R, or dist/ workers for randomized fleets)"
            )
        params = replace(params, fused="on")
        self.p = params
        window = params.block_u * params.stride
        self.slices = RangePartitioner.split_equal(
            range_start, range_end, d, window
        )
        # one child per slice, each an independent walk over its own
        # sub-range (split_equal never yields an empty slice; degenerate
        # shards repeat the last window and dedupe at verification)
        self.children = [
            BruteEngine(targets, sl.start, sl.end, mode=mode, params=params,
                        intervals=intervals, prefixes=prefixes)
            for sl in self.slices
        ]
        for c in self.children:
            assert c._fast
        self.stats = SearchStats()
        self.stats.multiplier = self.children[0].stats.multiplier
        self.local_steps = max(c._fast_total_steps for c in self.children)
        self._base_sharding = jax.sharding.NamedSharding(self.mesh, P("shard"))
        self._sharded_chunk = self._make_sharded_chunk()

    # ------------------------------------------------------------------

    def _bases_at(self, step: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(D, 8) x2 chunk base points at local step offset `step`.

        A base at the point at infinity (child._fast_base -> None) can
        only happen when a slice boundary lands exactly on a multiple of
        the group order — impossible for ranges inside [1, n)."""
        xs, ys = [], []
        for c in self.children:
            px, py = c._fast_base(step)
            if px is None:  # pragma: no cover - see docstring
                raise ValueError("chunk base at infinity (range touches n)")
            xs.append(px)
            ys.append(py)
        return (
            jax.device_put(jnp.stack(xs), self._base_sharding),
            jax.device_put(jnp.stack(ys), self._base_sharding),
        )

    def _make_sharded_chunk(self):
        from ..curve import pbrute

        p = self.p
        c0 = self.children[0]
        K, U, C = p.steps_per_chunk, p.block_u, p.chunk_cand
        mode, ne = c0.mode, c0._n_endo_fast

        def local_chunk(px, py, tabx, taby, ax, ay, tgt):
            """px/py: (1, 8) local shard base; the rest replicated args
            (P() specs) so the serialized HLO stays small."""
            nx, ny, out = pbrute.xla_brute_chunk(
                px.reshape(8), py.reshape(8), tabx, taby, ax, ay,
                tgt, K=K, U=U, C=C, mode=mode, n_endo=ne,
                chain=self.p.chain_len,
            )
            npos = (out[:C] < K * U).sum()
            ndeg = out[2 * C : 2 * C + K].sum()
            adv = out[2 * C + 2 * K : 2 * C + 3 * K].sum()
            over = (out[2 * C + 3 * K] > C).astype(jnp.int32)
            interest = jax.lax.psum(npos + ndeg + adv + over, "shard")
            return nx[None], ny[None], out[None], interest

        smapped = shard_map(
            local_chunk,
            mesh=self.mesh,
            in_specs=(P("shard"), P("shard")) + (P(),) * 5,
            out_specs=(P("shard"), P("shard"), P("shard"), P()),
            check_vma=False,
        )
        jitted = jax.jit(smapped)

        def chunk(px, py):
            return jitted(px, py, c0.tab_x, c0.tab_y, c0._adv_x_f,
                          c0._adv_y_f, c0._tgt_words)

        return chunk

    # ------------------------------------------------------------------

    def _ckpt_load(self, checkpoint):
        """Load/create a position checkpoint -> (ck, resumed local steps).
        Units are local device steps decoded in dispatch order (the
        pipeline decodes in order, so coverage up to `chunks_done` is
        exact across every shard)."""
        from ..core.checkpoint import Checkpoint, fingerprint

        p = self.p
        c0 = self.children[0]
        params_fp = fingerprint(
            c0.mode, p.block_u, p.steps_per_chunk, p.stride, p.endo,
            self.n_shards,
        )
        targets_fp = fingerprint(
            sorted(c0.targets.raw), sorted(c0.intervals), sorted(c0.prefixes),
        )
        a, b = self.slices[0].start, self.slices[-1].end
        ck = checkpoint.load()
        if ck is not None:
            checkpoint.matches(
                ck, mode=f"brute-sharded:{c0.mode}", range_start=a,
                range_end=b, policy="sequential", seed=p.seed,
                params_fp=params_fp, targets_fp=targets_fp,
            )
            self.stats.add(ck.keys_covered)
            return ck, ck.chunks_done
        return Checkpoint(
            mode=f"brute-sharded:{c0.mode}", range_start=a, range_end=b,
            policy="sequential", seed=p.seed, params_fp=params_fp,
            targets_fp=targets_fp,
        ), 0

    def search_sharded(
        self,
        max_steps: Optional[int] = None,
        stop_on_first: bool = False,
        progress_every: int = 0,
        max_seconds: Optional[float] = None,
        checkpoint=None,
    ) -> List[FoundKey]:
        """Pipelined mesh search (same discipline as the BSGS mesh
        engines): dispatch pipeline_depth chunks ahead with async host
        copies; decode only chunks whose psum'd interest is nonzero."""
        p = self.p
        dl = Deadline(max_seconds)
        K = p.steps_per_chunk
        total = (
            self.local_steps if max_steps is None
            else min(self.local_steps, max_steps)
        )
        found: List[FoundKey] = []
        seen = set()
        ck = None
        resumed = 0
        if checkpoint is not None:
            ck, resumed = self._ckpt_load(checkpoint)

        def take(fks) -> bool:
            new = False
            for fk in fks:
                if fk and fk.private_key not in seen:
                    seen.add(fk.private_key)
                    found.append(fk)
                    new = True
            return new

        if resumed == 0:  # prefix keys are covered before local step 0
            for c in self.children:
                for k0 in c._fast_prefix:
                    take([c._verify(k0, 0)])
            if found and stop_on_first:
                return found

        disp = min(resumed, total)
        px, py = self._bases_at(disp)
        pending: deque = deque()
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
                break  # deadline cut dispatch with nothing in flight
            step, outs, interest = pending.popleft()
            k = min(K, total - step)
            rebase = False
            new_any = False
            if int(np.asarray(interest)) > 0:
                arr = np.asarray(outs)  # (D, summary)
                for d, c in enumerate(self.children):
                    k_eff, new_found = c._decode_fast(step, arr[d])
                    new_any |= take(new_found)
                    if k_eff < k:
                        # this shard's advance chain degenerated: the
                        # remaining steps of ITS chunk walked garbage —
                        # cover them exactly on the host, then rebase
                        # every shard at the next chunk boundary
                        new_any |= take(
                            c._host_rescan_fast(step + k_eff, k - k_eff)
                        )
                        rebase = True
            self.stats.add(
                sum(
                    max(0, min(k, c._fast_total_steps - step))
                    for c in self.children
                ) * p.block_u
            )
            n_done += 1
            done_all = not pending and disp >= total
            BruteEngine._ckpt_save(
                checkpoint, ck, step + k, self.stats, found, new_any,
                force=done_all or bool(found and stop_on_first),
            )
            if found and stop_on_first:
                return found
            last_units = step + k
            if rebase and step + K < total:
                pending.clear()
                disp = step + K
                px, py = self._bases_at(disp)
            if progress_every and n_done % progress_every == 0:
                print(
                    f"[brute-sharded] local step {step + K}/{total} "
                    f"{self.stats.human()}"
                )
        if ck is not None and n_done:
            # deadline / stop-flag cut: persist exactly-covered progress
            BruteEngine._ckpt_save(
                checkpoint, ck, last_units, self.stats, found, False,
                force=True,
            )
        return found
