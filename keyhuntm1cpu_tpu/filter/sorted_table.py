"""Sorted 64-bit-truncated key table with vectorized binary search.

The device-native membership structure (SURVEY.md §7.2 step 4b): keys are the
low 64 bits of an X coordinate (or a hash160 prefix), stored as two sorted
uint32 planes plus a uint32 payload (baby index / target row). Lookup is a
lock-step lower-bound binary search — ceil(log2 m) iterations, each one a
full-batch gather + compare, identical control flow for every lane (no
divergence, unlike the reference's per-element searchbinary,
keyhunt.cpp:2311-2337 / bsgs_searchbinary :3748-3775).

Truncation collisions: two table entries may share a 64-bit key (birthday
≈ m^2/2^64). The lower-bound position and its successor are both checked,
so a duplicated key still surfaces both payload candidates; the engines
host-verify every candidate exactly anyway.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class SortedXTable(NamedTuple):
    hi: jnp.ndarray  # (m,) uint32, sorted by (hi, lo)
    lo: jnp.ndarray  # (m,) uint32
    idx: jnp.ndarray  # (m,) uint32 payload


class LookupResult(NamedTuple):
    found: jnp.ndarray  # (B,) bool — entry at pos matches
    idx: jnp.ndarray  # (B,) uint32 payload at pos (valid iff found)
    found2: jnp.ndarray  # (B,) bool — successor also matches (trunc dup)
    idx2: jnp.ndarray  # (B,) uint32 payload at pos+1


def build_sorted_table(
    hi: np.ndarray, lo: np.ndarray, idx: np.ndarray
) -> SortedXTable:
    """Host: sort (hi, lo, idx) by the packed 64-bit key and upload."""
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    return SortedXTable(
        jnp.asarray(hi[order].astype(np.uint32)),
        jnp.asarray(lo[order].astype(np.uint32)),
        jnp.asarray(idx[order].astype(np.uint32)),
    )


@jax.jit
def _sort3(hi, lo, idx):
    return jax.lax.sort((hi, lo, idx), num_keys=2, is_stable=True)


def build_sorted_table_device(
    hi: jnp.ndarray, lo: jnp.ndarray, idx: jnp.ndarray
) -> SortedXTable:
    """Device: lexicographic lax.sort keyed on (hi, lo) — no host round
    trip (the host-sort-then-upload path moves the whole table)."""
    shi, slo, sidx = _sort3(hi, lo, idx)
    return SortedXTable(shi, slo, sidx)


def lookup(table: SortedXTable, qhi: jnp.ndarray, qlo: jnp.ndarray) -> LookupResult:
    """Vectorized lower-bound search for (B,) query keys. jit-safe."""
    m = table.hi.shape[0]
    iters = max(1, math.ceil(math.log2(m))) + 1
    lo_b = jnp.zeros(qhi.shape, dtype=jnp.int32)
    hi_b = jnp.full(qhi.shape, m, dtype=jnp.int32)
    for _ in range(iters):
        mid = (lo_b + hi_b) >> 1
        midc = jnp.minimum(mid, m - 1)
        thi = table.hi[midc]
        tlo = table.lo[midc]
        less = (thi < qhi) | ((thi == qhi) & (tlo < qlo))
        lo_b = jnp.where(less, mid + 1, lo_b)
        hi_b = jnp.where(less, hi_b, mid)
    pos = jnp.minimum(lo_b, m - 1)
    in_range = lo_b < m
    found = in_range & (table.hi[pos] == qhi) & (table.lo[pos] == qlo)
    pos2 = jnp.minimum(lo_b + 1, m - 1)
    in_range2 = (lo_b + 1) < m
    found2 = in_range2 & (table.hi[pos2] == qhi) & (table.lo[pos2] == qlo)
    return LookupResult(found, table.idx[pos], found2, table.idx[pos2])


def trunc64_from_limbs(x_limbs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(hi, lo) 64-bit truncation of (..., 8) field elements = low 64 bits."""
    return x_limbs[..., 1], x_limbs[..., 0]
