"""Vanity address search engine.

Reference capability: keyhunt -m vanity / -v (keyhunt.cpp:3103-3537,
addvanity :5837-5957, vanityrmdmatch :5775-5801): a base58 prefix maps to
one or more [lo, hi] intervals of 20-byte hash160 values; the scan walks
keys and flags any hash160 falling inside an interval.

Design: the brute-force group walk + both-parity hash160 pipeline,
but membership = interval compare against a handful of (5-word big-endian)
bounds — pure lane compares, no gathers at all. Every device hit is
re-verified on host by actual base58 prefix match.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..curve import points, tables, walk
from ..field import fe
from ..hash import hash160_from_x_both_parities
from ..ref import ecref, hashref
from .brute import BruteParams
from .common import Deadline, FoundKey, SearchStats


def vanity_intervals(prefix: str) -> List[Tuple[bytes, bytes]]:
    """[(lo20, hi20)] hash160 intervals whose P2PKH addresses can start
    with `prefix` (reference addvanity padding strategy: extend with the
    smallest/largest base58 digits at every plausible length)."""
    if not prefix.startswith("1"):
        raise ValueError("P2PKH vanity prefixes start with '1' (version 0x00)")
    out = []
    for total_len in range(max(len(prefix), 26), 36):
        lo_s = prefix + "1" * (total_len - len(prefix))
        hi_s = prefix + "z" * (total_len - len(prefix))
        lo_raw = hashref.b58decode(lo_s)
        hi_raw = hashref.b58decode(hi_s)
        # a valid address payload is exactly 25 bytes with version 0x00
        def pad25(b: bytes) -> Optional[bytes]:
            if len(b) > 25:
                return None
            return b"\x00" * (25 - len(b)) + b

        lo_p, hi_p = pad25(lo_raw), pad25(hi_raw)
        if lo_p is None and hi_p is None:
            continue
        if lo_p is None:
            lo_p = b"\x00" * 25
        if hi_p is None:
            hi_p = b"\xff" * 25
        if lo_p[0] != 0 and hi_p[0] != 0:
            continue
        lo20 = lo_p[1:21] if lo_p[0] == 0 else b"\x00" * 20
        hi20 = hi_p[1:21] if hi_p[0] == 0 else b"\xff" * 20
        if lo20 <= hi20:
            out.append((lo20, hi20))
    if not out:
        raise ValueError(f"prefix {prefix!r} matches no address interval")
    # merge overlapping intervals
    out.sort()
    merged = [out[0]]
    for lo, hi in out[1:]:
        if lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _h160_to_words_be(h: bytes) -> np.ndarray:
    """20 bytes -> 5 big-endian uint32 words (lexicographic order)."""
    return np.frombuffer(h, dtype=">u4").astype(np.uint32)


def _bswap32(x: jnp.ndarray) -> jnp.ndarray:
    u = jnp.uint32
    return (
        ((x & u(0xFF)) << u(24))
        | ((x & u(0xFF00)) << u(8))
        | ((x >> u(8)) & u(0xFF00))
        | (x >> u(24))
    )


def _in_interval(words_le: List[jnp.ndarray], lo: np.ndarray, hi: np.ndarray):
    """words_le: 5 x (B,) LE-packed hash160 words. lo/hi: (5,) BE words.
    Returns (B,) bool: lo <= h <= hi lexicographically."""
    wbe = [_bswap32(w) for w in words_le]

    def cmp_ge(bound):
        # h >= bound
        gt = jnp.zeros(wbe[0].shape, dtype=bool)
        eq = jnp.ones(wbe[0].shape, dtype=bool)
        for i in range(5):
            b = jnp.uint32(int(bound[i]))
            gt = gt | (eq & (wbe[i] > b))
            eq = eq & (wbe[i] == b)
        return gt | eq

    def cmp_le(bound):
        lt = jnp.zeros(wbe[0].shape, dtype=bool)
        eq = jnp.ones(wbe[0].shape, dtype=bool)
        for i in range(5):
            b = jnp.uint32(int(bound[i]))
            lt = lt | (eq & (wbe[i] < b))
            eq = eq & (wbe[i] == b)
        return lt | eq

    return cmp_ge(lo) & cmp_le(hi)


@dataclass(frozen=True)
class VanityParams(BruteParams):
    pass


class VanityEngine:
    def __init__(
        self,
        prefixes: List[str],
        range_start: int,
        range_end: int,
        params: VanityParams = VanityParams(),
    ):
        self.prefixes = prefixes
        self.intervals = []
        for p in prefixes:
            self.intervals += vanity_intervals(p)
        self.a, self.b = range_start, range_end
        self.p = params
        self.stats = SearchStats()
        self.stats.multiplier = 2  # both parities

        self.window = 2 * params.block_u + 1
        total_keys = self.b - self.a
        self.slice_len = math.ceil(total_keys / params.walkers)
        self.slice_len = math.ceil(self.slice_len / self.window) * self.window
        self.steps_per_walker = self.slice_len // self.window

        tab_x, tab_y = tables.step_table(ecref.G, params.block_u)
        self.tab_x = jnp.asarray(tab_x)
        self.tab_y = jnp.asarray(tab_y)
        adv = ecref.scalar_mult(self.window)
        self.adv_x = fe.from_int(adv[0])
        self.adv_y = fe.from_int(adv[1])
        self._chunk_fn = self._make_chunk_fn()

    def _make_chunk_fn(self):
        W, U, K = self.p.walkers, self.p.block_u, self.p.steps_per_chunk
        chain = self.p.chain_len
        tab_x, tab_y = self.tab_x, self.tab_y
        adv_x, adv_y = self.adv_x, self.adv_y
        bounds = [
            (_h160_to_words_be(lo), _h160_to_words_be(hi))
            for lo, hi in self.intervals
        ]

        @jax.jit
        def chunk(cx, cy):
            def body(carry, _):
                cx, cy = carry
                ctr = points.PointBatch(cx, cy, jnp.zeros((W,), dtype=bool))
                res = walk.walk_fused(
                    ctr, tab_x, tab_y, adv_x, adv_y,
                    symmetric=True, chain_len=chain,
                )
                x_all = jnp.concatenate(
                    [res.x_plus, res.x_minus, cx[:, None, :]], axis=1
                )
                even, odd = hash160_from_x_both_parities(x_all)
                hits = []
                for words in (even, odd):
                    m = jnp.zeros(x_all.shape[:-1], dtype=bool)
                    for lo, hi in bounds:
                        m = m | _in_interval(words, lo, hi)
                    hits.append(m)
                hit = jnp.stack(hits, axis=-1)  # (W, npts, 2)
                degm = jnp.concatenate(
                    [res.degenerate, res.degenerate, jnp.zeros((W, 1), dtype=bool)],
                    axis=1,
                )
                hit = hit & ~degm[..., None]
                return (res.adv_x, res.adv_y), (hit, res.adv_degenerate)

            (cx, cy), (hits, advdeg) = jax.lax.scan(body, (cx, cy), None, length=K)
            return cx, cy, hits, advdeg

        return chunk

    def _key_for_lane(self, step: int, w: int, lane: int) -> int:
        u = self.p.block_u
        k0 = self.a + w * self.slice_len + step * self.window
        center = k0 + u
        if lane < u:
            return center + (lane + 1)
        if lane < 2 * u:
            return center - (lane - u + 1)
        return center

    def _verify(self, k: int) -> Optional[FoundKey]:
        for cand in (k, ecref.N - (k % ecref.N)):
            if not (1 <= cand < ecref.N):
                continue
            pt = ecref.scalar_mult(cand)
            addr = hashref.pubkey_to_address(pt, compressed=True)
            for pref in self.prefixes:
                if addr.startswith(pref):
                    return FoundKey(private_key=cand, pubkey=pt, target=addr)
        return None

    def search(
        self,
        max_steps: Optional[int] = None,
        stop_on_first: bool = False,
        max_found: Optional[int] = None,
        progress_every: int = 0,
        checkpoint=None,
        max_seconds: Optional[float] = None,
    ) -> List[FoundKey]:
        p = self.p
        dl = Deadline(max_seconds)

        def centers_at(step0: int) -> points.PointBatch:
            pts = []
            for w in range(p.walkers):
                c = self.a + w * self.slice_len + step0 * self.window + p.block_u
                pts.append(ecref.scalar_mult(c))
            return points.point_batch_from_ints(pts)

        total = self.steps_per_walker if max_steps is None else min(
            self.steps_per_walker, max_steps
        )
        found: List[FoundKey] = []
        seen = set()
        step = 0
        ck = None
        if checkpoint is not None:
            from ..core.checkpoint import Checkpoint, fingerprint

            params_fp = fingerprint(
                p.block_u, p.steps_per_chunk, p.walkers, p.chain_len
            )
            targets_fp = fingerprint(sorted(self.prefixes))
            ck = checkpoint.load()
            if ck is not None:
                checkpoint.matches(
                    ck, mode="vanity", range_start=self.a, range_end=self.b,
                    params_fp=params_fp, targets_fp=targets_fp,
                )
                step = min(ck.chunks_done, total)
                self.stats.add(ck.keys_covered)
            else:
                ck = Checkpoint(
                    mode="vanity", range_start=self.a, range_end=self.b,
                    policy="sequential", seed=0, params_fp=params_fp,
                    targets_fp=targets_fp,
                )
        base = centers_at(step)
        cx, cy = base.x, base.y
        n_saved = 0
        while step < total:
            if dl.expired():
                # time-bounded search: stop at the chunk boundary and
                # persist exactly-covered progress (resume re-enters here)
                if ck is not None:
                    checkpoint.save(ck, force=True)
                break
            k = min(p.steps_per_chunk, total - step)
            cx, cy, hits, advdeg = self._chunk_fn(cx, cy)
            hits_np = np.asarray(hits)
            for s, w, lane, _v in zip(*np.nonzero(hits_np[:k])):
                cand = self._key_for_lane(step + int(s), int(w), int(lane))
                fk = self._verify(cand)
                if fk and fk.private_key not in seen:
                    seen.add(fk.private_key)
                    found.append(fk)
                    if stop_on_first or (max_found and len(found) >= max_found):
                        return found
            self.stats.add(k * p.walkers * self.window)
            step += p.steps_per_chunk
            if ck is not None:
                ck.chunks_done = step
                ck.keys_covered = self.stats.keys_covered
                if len(found) > n_saved:
                    ck.found = sorted(
                        set(ck.found) | {f"{f.private_key:x}" for f in found}
                    )
                checkpoint.save(
                    ck, force=(len(found) > n_saved) or step >= total
                )
                n_saved = len(found)
            if bool(np.asarray(advdeg)[:k].any()) and step < total:
                base = centers_at(step)  # exact rebase after advance fault
                cx, cy = base.x, base.y
            if progress_every and (step // p.steps_per_chunk) % progress_every == 0:
                print(f"[vanity] step {step}/{total} {self.stats.human()}")
        return found
