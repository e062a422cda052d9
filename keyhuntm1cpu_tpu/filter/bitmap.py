"""Device-resident bitmap pre-filter + compacted exact lookup.

Device re-design of the reference's 3-level bloom cascade
(keyhunt.cpp:1215-1304, bloom/bloom.cpp:60-85). The cascade exists for one
reason: make the per-point membership test almost free and pay the exact
check only on survivors. On the device the cost model is gathers, not RAM:

- level 1: ONE device-memory gather per query into a 2^b-bit direct-address bitmap
  (the key's low b bits index the bitmap; keys are x-coordinate
  truncations, already uniform — no hash needed). fp = m / 2^b.
- level 2: survivors are compacted with a static-size nonzero and only
  they run the 20-gather-round binary search (filter/sorted_table.py).

At the default sizing (b = log2(m) + 12) a U = 8192 step has ~2 expected
survivors, so the exact search runs at 1/64th width and the ~20 dependent
gather rounds of the binary search leave the hot loop.

The reference-compatible XXH64 bloom (filter/bloom.py) remains the
memory-frugal host-side option; this is the device-native cascade.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..core import device
from .sorted_table import LookupResult, SortedXTable, lookup


class DeviceBitmap(NamedTuple):
    words: jnp.ndarray  # (2^(bits_log2-5),) uint32
    bits_log2: int


def default_bits_log2(m: int) -> int:
    """fp = m/2^b = 2^-12, capped at 2^34 bits (2 GiB). The cap must
    keep expected survivors comfortably under the compaction budgets:
    the walk-kernel path compacts once per chunk (chunk_cand_max 1024),
    so fp must satisfy K * U * fp << 1024 — at m = 2^24 that needs 2^34
    (fp 2^-10 -> ~512/chunk)."""
    return min(34, max(16, int(np.ceil(np.log2(max(m, 2)))) + 12))


MAX_BITS_LOG2 = 35  # 4 GB of words; 2^30 word indices fit int32
# (bits=36 would need 2^31 word indices -> int32 overflow in jnp take)


def scaled_bits_log2(m: int, mult: int) -> "int | None":
    """Probe-bitmap size for a filter-size multiplier (reference -z
    FLAGBLOOMMULTIPLIER, keyhunt.cpp:766-772): mult-fold more bits than
    the default fp target, clamped to MAX_BITS_LOG2. Returns None for
    mult <= 1 (use the engine default). Shared by every entry point that
    exposes -z."""
    import math

    if mult <= 1:
        return None
    return min(MAX_BITS_LOG2,
               default_bits_log2(m) + math.ceil(math.log2(mult)))


def _bit_indices(hi: np.ndarray, lo: np.ndarray, bits_log2: int) -> np.ndarray:
    idx = lo.astype(np.uint64)
    if bits_log2 > 32:
        idx |= (hi.astype(np.uint64) & np.uint64((1 << (bits_log2 - 32)) - 1)) << np.uint64(32)
    else:
        idx &= np.uint64((1 << bits_log2) - 1)
    return idx


def build_bitmap(
    hi: np.ndarray,
    lo: np.ndarray,
    bits_log2: int | None = None,
    on_device: bool | None = None,
) -> DeviceBitmap:
    """Bitmap over the low bits of the 64-bit truncated keys.

    on_device (default: on the GPU) builds the word array ON the device
    from deduplicated bit indices — the host uploads 5 bytes per KEY
    instead of the whole bitmap (2-8 GB at production sizes).
    Deduplicating
    first makes scatter-add equal scatter-or: every (word, bit) pair
    appears exactly once.
    """
    if bits_log2 is None:
        bits_log2 = default_bits_log2(len(lo))
    if bits_log2 < 5 or bits_log2 > MAX_BITS_LOG2:
        raise ValueError(f"bits_log2 out of range (5..{MAX_BITS_LOG2})")
    idx = _bit_indices(hi, lo, bits_log2)
    if on_device is None:
        on_device = device.on_gpu()
    n_words = 1 << (bits_log2 - 5)
    if on_device:
        uniq = np.unique(idx)
        # 5 B/key over the host link (int32 word + uint8 bit)
        word_idx = jnp.asarray((uniq >> np.uint64(5)).astype(np.int32))
        bit = jnp.asarray((uniq & np.uint64(31)).astype(np.uint8))
        words = _scatter_bits(word_idx, bit, n_words)
        return DeviceBitmap(words, bits_log2)
    words = np.zeros(n_words, dtype=np.uint32)
    np.bitwise_or.at(
        words,
        (idx >> np.uint64(5)).astype(np.int64),
        (np.uint32(1) << (idx & np.uint64(31)).astype(np.uint32)),
    )
    return DeviceBitmap(jnp.asarray(words), bits_log2)


from functools import partial as _partial

import jax as _jax


@_partial(_jax.jit, static_argnames=("n_words",))
def _scatter_bits(word_idx, bit, n_words: int):
    words = jnp.zeros(n_words, dtype=jnp.uint32)
    return words.at[word_idx].add(jnp.uint32(1) << bit.astype(jnp.uint32))


@_partial(_jax.jit, static_argnames=("bits_log2", "n_words"))
def _build_words_device(hi, lo, bits_log2: int, n_words: int):
    """Word array from (hi, lo) key planes entirely on device.

    jnp has no scatter-OR, so duplicates are removed first: sort the bit
    indices (two u32 sort keys), keep the first of each run, zero the
    rest's contribution — then scatter-add IS scatter-or. Index math
    mirrors probe() exactly (low bits_log2 bits of the 64-bit key).
    """
    if bits_log2 > 32:
        ihi = hi & jnp.uint32((1 << (bits_log2 - 32)) - 1)
        ilo = lo
    else:
        mask = (
            jnp.uint32((1 << bits_log2) - 1)
            if bits_log2 < 32
            else jnp.uint32(0xFFFFFFFF)
        )
        ihi = jnp.zeros_like(hi)
        ilo = lo & mask
    shi, slo = _jax.lax.sort((ihi, ilo), num_keys=2)
    first = jnp.concatenate(
        [
            jnp.ones((1,), dtype=bool),
            (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1]),
        ]
    )
    word = (slo >> jnp.uint32(5)).astype(jnp.int32) | (
        shi.astype(jnp.int32) << 27
    )
    val = jnp.where(first, jnp.uint32(1) << (slo & jnp.uint32(31)), jnp.uint32(0))
    words = jnp.zeros(n_words, dtype=jnp.uint32)
    return words.at[word].add(val)


def build_bitmap_device(
    hi: jnp.ndarray, lo: jnp.ndarray, bits_log2: int | None = None
) -> DeviceBitmap:
    """Bitmap derived from device-resident key planes (e.g. a freshly
    built or freshly uploaded baby table) with ZERO bulk host transfers
    (the host-array build_bitmap() uploads 5 B/key)."""
    if bits_log2 is None:
        bits_log2 = default_bits_log2(lo.shape[0])
    if bits_log2 < 5 or bits_log2 > MAX_BITS_LOG2:
        raise ValueError(f"bits_log2 out of range (5..{MAX_BITS_LOG2})")
    n_words = 1 << (bits_log2 - 5)
    return DeviceBitmap(_build_words_device(hi, lo, bits_log2, n_words), bits_log2)


# ---------------------------------------------------------------------------
# Streaming scatter-OR (filter builds without materialized key planes).
#
# jnp has no scatter-OR; the exact construction sorts the segment's word
# indices, OR-combines equal-index runs with a segmented associative
# scan, then gathers the current word and scatters the merged value at
# each run-last position. Duplicate (word, bit) pairs across SEGMENTS
# are exact too (the gather reads the live value), which is what lets
# the BSGS filter build stream m keys through a lax.scan carry instead
# of materializing 8-12 bytes/key of planes + sort transients.
# ---------------------------------------------------------------------------


def bitmap_bit_planes(qhi, qlo, bits_log2: int):
    """(word_idx int32, bitval u32) for the direct-address bitmap —
    index math identical to probe()."""
    if bits_log2 > 32:
        extra = bits_log2 - 32
        word_idx = (
            (qlo >> jnp.uint32(5)).astype(jnp.int32)
            | ((qhi & jnp.uint32((1 << extra) - 1)).astype(jnp.int32) << 27)
        )
        bit = qlo & jnp.uint32(31)
    else:
        mask = (jnp.uint32((1 << bits_log2) - 1) if bits_log2 < 32
                else jnp.uint32(0xFFFFFFFF))
        idx = qlo & mask
        word_idx = (idx >> jnp.uint32(5)).astype(jnp.int32)
        bit = idx & jnp.uint32(31)
    return word_idx, jnp.uint32(1) << bit


def bloom2_bit_planes(qhi, qlo, bits_log2: int):
    """(word_idx int32, bitval u32), both hashes concatenated — index
    math identical to probe_bloom2(). For bits_log2 > 32 the word index
    gains (bits_log2-32) key-derived extension bits (bloom2_ext_hashes;
    the extension must mix the KEY, not the 32-bit hash — a function of
    the hash cannot split hash collisions into distinct buckets)."""
    h1, h2 = bloom2_hashes(qhi, qlo)
    if bits_log2 > 32:
        e1, e2 = bloom2_ext_hashes(qhi, qlo)
        emask = jnp.uint32((1 << (bits_log2 - 32)) - 1)
        word_idx = jnp.concatenate([
            (h1 >> jnp.uint32(5)).astype(jnp.int32)
            | ((e1 & emask).astype(jnp.int32) << 27),
            (h2 >> jnp.uint32(5)).astype(jnp.int32)
            | ((e2 & emask).astype(jnp.int32) << 27),
        ])
        bit = jnp.concatenate([h1, h2]) & jnp.uint32(31)
        return word_idx, jnp.uint32(1) << bit
    mask = (jnp.uint32((1 << bits_log2) - 1) if bits_log2 < 32
            else jnp.uint32(0xFFFFFFFF))
    idx = jnp.concatenate([h1 & mask, h2 & mask])
    word_idx = (idx >> jnp.uint32(5)).astype(jnp.int32)
    return word_idx, jnp.uint32(1) << (idx & jnp.uint32(31))


def _segmented_or(si, sv):
    """Inclusive segmented OR-scan over sorted segment ids `si`:
    out[i] = OR of sv[j] for all j <= i with si[j] == si[i]. Hand-rolled
    Hillis-Steele doubling (log2 n shifted elementwise passes) — the
    equivalent lax.associative_scan lowers to a slice-heavy HLO that
    compiles slowly inside a scan body. Runs are
    contiguous (si sorted), so si[i-s] == si[i] implies the whole
    window shares the id — each pass is exact."""
    n = si.shape[0]
    shift = 1
    while shift < n:
        prev_i = jnp.concatenate([si[:shift], si[:-shift]])
        prev_v = jnp.concatenate(
            [jnp.zeros((shift,), sv.dtype), sv[:-shift]]
        )
        sv = sv | jnp.where(prev_i == si, prev_v, jnp.zeros((), sv.dtype))
        shift *= 2
    return sv


def or_bits_into(words, word_idx, bitval):
    """words[word_idx] |= bitval, exact under duplicate word_idx; OOB
    indices (callers use n_words for masked lanes) are dropped. Plain
    traceable function — meant to run INSIDE a jitted scan body where
    XLA aliases the loop-carried words buffer (no per-call copy)."""
    n = words.shape[0]
    si, sv = _jax.lax.sort((word_idx, bitval), num_keys=1)
    rv = _segmented_or(si, sv)
    last = jnp.concatenate(
        [si[:-1] != si[1:], jnp.ones((1,), dtype=bool)]
    )
    safe = jnp.minimum(si, n - 1)
    merged = words[safe] | rv
    tgt = jnp.where(last & (si < n), si, n)  # n = dropped
    return words.at[tgt].set(merged)


PROBE_MODES = ("elem", "sorted", "row128")

# Module default, used by every engine that does not plumb an explicit
# probe_mode (XLA brute fallback, sharded mesh engines).
DEFAULT_PROBE_MODE = "elem"


def probe(bm: DeviceBitmap, qhi: jnp.ndarray, qlo: jnp.ndarray,
          mode: "str | None" = None) -> jnp.ndarray:
    """(B,) bool possibly-present mask — exactly one gather round.

    mode picks the gather strategy (bit-identical results, exposed as
    BSGSParams.probe_mode):
      elem    words[idx] — one 4 B random gather per query
      sorted  argsort + gather + unsort: address-bucketed probes hit HBM
              with page/row locality; wins iff the sort is cheaper than
              the locality gain
      row128  gather 128-word rows + lane select: one 512 B transaction
              per query — wins if XLA's row gather is bandwidth-efficient
              where its element gather is issue-rate-bound
    """
    if bm.bits_log2 > 32:
        extra = bm.bits_log2 - 32  # word count < 2^30: int32 indices are safe
        word_idx = (
            (qlo >> jnp.uint32(5)).astype(jnp.int32)
            | ((qhi & jnp.uint32((1 << extra) - 1)).astype(jnp.int32) << 27)
        )
        bit = qlo & jnp.uint32(31)
    else:
        mask = jnp.uint32((1 << bm.bits_log2) - 1) if bm.bits_log2 < 32 else jnp.uint32(0xFFFFFFFF)
        idx = qlo & mask
        word_idx = (idx >> jnp.uint32(5)).astype(jnp.int32)
        bit = idx & jnp.uint32(31)
    if mode is None:
        mode = DEFAULT_PROBE_MODE
    if mode == "sorted":
        order = jnp.argsort(word_idx)
        got = bm.words[word_idx[order]]
        words = jnp.zeros_like(got).at[order].set(got)
    elif mode == "row128":
        # bits_log2 >= 12 always holds at engine sizes, so the word
        # count is a multiple of 128 and the reshape is exact
        rows = bm.words.reshape(-1, 128)
        got = rows[word_idx >> 7]
        words = jnp.take_along_axis(
            got, (word_idx & 127)[:, None], axis=1
        )[:, 0]
    elif mode == "elem":
        words = bm.words[word_idx]
    else:
        raise ValueError(f"probe mode must be one of {PROBE_MODES}")
    return ((words >> bit) & jnp.uint32(1)) == 1


# ---------------------------------------------------------------------------
# Level-2 hashed bloom (k=2) — probed only on level-1 survivors.
#
# Level 1 is direct-addressed, so its fp is pinned at m/2^bits and
# DEGRADES with m once bits hits the memory cap (m=2^28 at bits=35 ->
# fp=2^-7 -> ~8k survivors/chunk, and the 29-round exact search at that
# width dominates the chunk). Level 2 is a classic 2-hash bloom: at load
# 2m/2^bits2 = 1/8 its fp is (1-e^-0.125)^2 ~ 1.4e-2 INDEPENDENT of m,
# for 2m bytes of device memory.
# Probing it costs 2 gathers per SURVIVOR (not per query), so the
# cascade is probe1 (B) -> compact -> probe2 (C2) -> compact -> exact
# search at ~C2/70 width. Reference analog: the 3-level bloom cascade,
# keyhunt.cpp:1215-1304 — same idea, device cost model.
# ---------------------------------------------------------------------------


class DeviceBloom2(NamedTuple):
    words: jnp.ndarray  # (2^(bits_log2-5),) uint32
    bits_log2: int


def bloom2_bits_log2(m: int) -> int:
    """Size for load 2m/2^bits = 1/8 (fp ~ 1.4e-2), capped at 2^32 bits
    (512 MB)."""
    return min(32, max(16, int(np.ceil(np.log2(max(m, 2)))) + 4))


def bloom2_bits_log2_host(m: int) -> int:
    """Bloom2 sizing for HOST-resolve engines (no device exact table):
    the freed device memory buys load 2m/2^bits = 1/16 (fp ~ 3.7e-3), capped at
    2^35 bits (4 GB) — the same int32-word-index ceiling as the bitmap.
    At the cap the load degrades gracefully (1/8 at m=2^31, 1/4 at
    m=2^32); budget sizing must use bloom2_fp(), not a constant."""
    return min(35, max(16, int(np.ceil(np.log2(max(m, 2)))) + 5))


def bloom2_fp(m: int, bits_log2: int) -> float:
    """False-positive rate of the k=2 bloom at 2m insertions into
    2^bits_log2 bits: (1 - e^-load)^2."""
    load = 2.0 * m / float(1 << bits_log2)
    return float((1.0 - np.exp(-load)) ** 2)


def _fmix32(h):
    h ^= h >> jnp.uint32(16)
    h *= jnp.uint32(0x85EBCA6B)
    h ^= h >> jnp.uint32(13)
    h *= jnp.uint32(0xC2B2AE35)
    h ^= h >> jnp.uint32(16)
    return h


def bloom2_hashes(qhi, qlo):
    """Two independent 32-bit mixes of the 64-bit truncated key.
    murmur3-fmix32 over seed-distinguished combinations — NOT the
    identity bits level 1 keys on, so the two levels' false positives
    are independent."""
    h1 = _fmix32(qlo ^ (qhi * jnp.uint32(0x9E3779B1)) ^ jnp.uint32(0x2545F491))
    h2 = _fmix32(qhi ^ (qlo * jnp.uint32(0x85EBCA77)) ^ jnp.uint32(0x633D9ABD))
    return h1, h2


def bloom2_ext_hashes(qhi, qlo):
    """Index-extension mixes for bloom sizes past 2^32 bits: two MORE
    independent key mixes whose low bits extend each probe's bucket
    address (host-resolve blooms run at 2^33-2^35 bits)."""
    e1 = _fmix32(qhi ^ (qlo * jnp.uint32(0xC2B2AE3D)) ^ jnp.uint32(0x27D4EB2F))
    e2 = _fmix32(qlo ^ (qhi * jnp.uint32(0x165667B1)) ^ jnp.uint32(0x9E3779B9))
    return e1, e2


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """numpy mirror of _fmix32 — MUST stay bit-identical (tested)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def bloom2_hashes_np(qhi: np.ndarray, qlo: np.ndarray):
    qhi = qhi.astype(np.uint32)
    qlo = qlo.astype(np.uint32)
    h1 = _fmix32_np(
        qlo ^ (qhi * np.uint32(0x9E3779B1)).astype(np.uint32)
        ^ np.uint32(0x2545F491)
    )
    h2 = _fmix32_np(
        qhi ^ (qlo * np.uint32(0x85EBCA77)).astype(np.uint32)
        ^ np.uint32(0x633D9ABD)
    )
    return h1, h2


def bloom2_ext_hashes_np(qhi: np.ndarray, qlo: np.ndarray):
    """numpy mirror of bloom2_ext_hashes — MUST stay bit-identical."""
    qhi = qhi.astype(np.uint32)
    qlo = qlo.astype(np.uint32)
    e1 = _fmix32_np(
        qhi ^ (qlo * np.uint32(0xC2B2AE3D)).astype(np.uint32)
        ^ np.uint32(0x27D4EB2F)
    )
    e2 = _fmix32_np(
        qlo ^ (qhi * np.uint32(0x165667B1)).astype(np.uint32)
        ^ np.uint32(0x9E3779B9)
    )
    return e1, e2


def bloom2_word_bit_np(qhi: np.ndarray, qlo: np.ndarray, bits_log2: int):
    """(word int64, bitmask u32) per probe, both probes concatenated —
    numpy mirror of bloom2_bit_planes (incl. >32-bit extension)."""
    h1, h2 = bloom2_hashes_np(np.asarray(qhi), np.asarray(qlo))
    if bits_log2 > 32:
        e1, e2 = bloom2_ext_hashes_np(np.asarray(qhi), np.asarray(qlo))
        emask = np.uint32((1 << (bits_log2 - 32)) - 1)
        word = np.concatenate([
            (h1 >> np.uint32(5)).astype(np.int64)
            | ((e1 & emask).astype(np.int64) << 27),
            (h2 >> np.uint32(5)).astype(np.int64)
            | ((e2 & emask).astype(np.int64) << 27),
        ])
        bits = np.concatenate([h1, h2]) & np.uint32(31)
        return word, np.uint32(1) << bits
    mask = (np.uint32((1 << bits_log2) - 1) if bits_log2 < 32
            else np.uint32(0xFFFFFFFF))
    idx = np.concatenate([h1 & mask, h2 & mask])
    return ((idx >> np.uint32(5)).astype(np.int64),
            np.uint32(1) << (idx & np.uint32(31)))


def build_bloom2_host(hi: np.ndarray, lo: np.ndarray,
                      bits_log2: "int | None" = None) -> DeviceBloom2:
    """Host-built k=2 bloom (numpy scatter-or) — used by the sharded-
    table engine, which builds per-shard structures host-side."""
    if bits_log2 is None:
        bits_log2 = bloom2_bits_log2(len(lo))
    word, val = bloom2_word_bit_np(hi, lo, bits_log2)
    words = np.zeros(1 << (bits_log2 - 5), dtype=np.uint32)
    np.bitwise_or.at(words, word, val)
    return DeviceBloom2(jnp.asarray(words), bits_log2)


@_partial(_jax.jit, static_argnames=("bits2", "n_words"))
def _build_bloom2_words(hi, lo, bits2: int, n_words: int):
    h1, h2 = bloom2_hashes(hi, lo)
    mask = (jnp.uint32((1 << bits2) - 1) if bits2 < 32
            else jnp.uint32(0xFFFFFFFF))
    idx = jnp.concatenate([h1 & mask, h2 & mask])
    # dedup via sort-and-first so scatter-add equals scatter-or (jnp has
    # no scatter-or; duplicate (word,bit) pairs would carry otherwise)
    (s,) = _jax.lax.sort((idx,), num_keys=1)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]]
    )
    word = (s >> jnp.uint32(5)).astype(jnp.int32)
    val = jnp.where(first, jnp.uint32(1) << (s & jnp.uint32(31)),
                    jnp.uint32(0))
    return jnp.zeros(n_words, jnp.uint32).at[word].add(val)


def build_bloom2_device(hi: jnp.ndarray, lo: jnp.ndarray,
                        bits_log2: int | None = None,
                        slice_elems: int = 1 << 26) -> DeviceBloom2:
    """k=2 bloom over device-resident (hi, lo) key planes (e.g. the
    sorted table's), zero bulk host transfers.

    Built in slices: the in-slice sort (dedup for scatter-or) would
    need GBs of temp at m=2^28 next to the 4 GB bitmap + 3 GB table;
    OR-ing per-slice bitmasks is exact (each slice scatter is a valid
    0/1 mask and OR is idempotent across slices)."""
    if bits_log2 is None:
        bits_log2 = bloom2_bits_log2(lo.shape[0])
    n_words = 1 << (bits_log2 - 5)
    n = lo.shape[0]
    words = None
    for s in range(0, n, slice_elems):
        w = _build_bloom2_words(
            hi[s : s + slice_elems], lo[s : s + slice_elems],
            bits_log2, n_words,
        )
        words = w if words is None else words | w
    return DeviceBloom2(words, bits_log2)


def probe_bloom2(b2: DeviceBloom2, qhi: jnp.ndarray,
                 qlo: jnp.ndarray) -> jnp.ndarray:
    """(B,) bool mask — 2 gathers per query; no false negatives."""
    h1, h2 = bloom2_hashes(qhi, qlo)
    if b2.bits_log2 > 32:
        e1, e2 = bloom2_ext_hashes(qhi, qlo)
        emask = jnp.uint32((1 << (b2.bits_log2 - 32)) - 1)
        w1 = b2.words[(h1 >> jnp.uint32(5)).astype(jnp.int32)
                      | ((e1 & emask).astype(jnp.int32) << 27)]
        w2 = b2.words[(h2 >> jnp.uint32(5)).astype(jnp.int32)
                      | ((e2 & emask).astype(jnp.int32) << 27)]
        hit1 = ((w1 >> (h1 & jnp.uint32(31))) & jnp.uint32(1)) == 1
        hit2 = ((w2 >> (h2 & jnp.uint32(31))) & jnp.uint32(1)) == 1
        return hit1 & hit2
    mask = (jnp.uint32((1 << b2.bits_log2) - 1) if b2.bits_log2 < 32
            else jnp.uint32(0xFFFFFFFF))
    h1 &= mask
    h2 &= mask
    w1 = b2.words[(h1 >> jnp.uint32(5)).astype(jnp.int32)]
    w2 = b2.words[(h2 >> jnp.uint32(5)).astype(jnp.int32)]
    hit1 = ((w1 >> (h1 & jnp.uint32(31))) & jnp.uint32(1)) == 1
    hit2 = ((w2 >> (h2 & jnp.uint32(31))) & jnp.uint32(1)) == 1
    return hit1 & hit2


def compact_positions_sort(mask: jnp.ndarray, size: int,
                           fill: int) -> jnp.ndarray:
    """Dense-regime compaction: one ascending lax.sort of the masked
    iota. Hits sort to the front in order; the first `size` are kept —
    identical semantics to flat nonzero (FIRST size positions on
    overflow). A single-key u32 sort is survivor-count-independent —
    the choice once survivors are too dense for the hierarchical path
    (large m at the capped bitmap, where expected hits exceed B/128)."""
    B = mask.shape[0]
    iota = jnp.arange(B, dtype=jnp.int32)
    key = jnp.where(mask, iota, jnp.int32(B))
    (skey,) = _jax.lax.sort((key,), num_keys=1)
    if size > B:  # budget wider than the mask: pad with non-hits
        skey = jnp.concatenate(
            [skey, jnp.full((size - B,), B, dtype=jnp.int32)]
        )
    pos = skey[:size]
    return jnp.where(pos < B, pos, fill).astype(jnp.int32)


def compact_positions_dense(mask: jnp.ndarray, size: int, fill: int,
                            kmax: int = 8) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mid-density compaction via iterated per-row argmax.

    For masks with ~1 hit per 128-lane row (minikey validity is
    Bernoulli(2^-8): ~0.4 hits/row at B=2^22) the hierarchical path
    degenerates — nearly every row is hit, so its final flat nonzero
    runs over ~size*128 elements — and the B-wide sort path pays a full
    sort regardless. Here: extract up to
    `kmax` hits per row with pure vector ops (argmax for the first set
    lane, one-hot clear, repeat — no gathers, no B-wide sort), then
    sort only the (B/128)*kmax candidate slab.

    Returns (pos, lost). pos as compact_positions (ascending, padded
    with fill). lost is a () bool — True when some row held > kmax
    hits, whose positions are then MISSING from pos: callers must treat
    the chunk as overflowed (the engines' exact-rescan fallback).
    P(Binom(128, 2^-8) > 8) ~ 1e-9 per row, ~3e-5 per 2^22 chunk.
    """
    B = mask.shape[0]
    R = B // 128
    rows = mask.reshape(R, 128)
    lost = (rows.sum(axis=1, dtype=jnp.int32) > kmax).any()
    lane = jnp.arange(128, dtype=jnp.int32)[None, :]
    cols = []
    cur = rows
    for _ in range(kmax):
        idx = jnp.argmax(cur, axis=1).astype(jnp.int32)  # first set lane
        hit = cur.any(axis=1)
        cols.append(jnp.where(hit, idx, jnp.int32(-1)))
        cur = cur & (lane != idx[:, None])
    cand = jnp.stack(cols, axis=1)  # (R, kmax), -1 = none
    pos = jnp.arange(R, dtype=jnp.int32)[:, None] * 128 + cand
    flat = jnp.where(cand >= 0, pos, jnp.int32(B)).reshape(-1)
    (sflat,) = _jax.lax.sort((flat,), num_keys=1)
    if size > sflat.shape[0]:
        sflat = jnp.concatenate(
            [sflat, jnp.full((size - sflat.shape[0],), B, dtype=jnp.int32)]
        )
    out = sflat[:size]
    return jnp.where(out < B, out, fill).astype(jnp.int32), lost


def compact_positions(mask: jnp.ndarray, size: int, fill: int) -> jnp.ndarray:
    """Positions of set bits in (B,) mask, padded with `fill` to `size`
    — jnp.nonzero(mask, size, fill) semantics (ascending, int32).

    Hierarchical: row-reduce to a (B/128,) any-mask, nonzero over ROWS,
    gather only the hit rows, then a narrow nonzero — the wide pass
    shrinks from B to B/128 + size*128 elements. Exact because
    every hit row holds >= 1 survivor, so #hit rows <= #survivors; when
    survivors > size the output (like flat nonzero's) keeps the FIRST
    `size` positions — callers detect overflow via mask.sum() as before.
    Dense budgets (size*128 >= B, where the row hierarchy cannot shrink
    anything) use the sort path; tiny/untileable masks use flat nonzero.
    """
    B = mask.shape[0]
    if B % 128 != 0 or B // 128 < 2:
        (pos,) = jnp.nonzero(mask, size=size, fill_value=fill)
        return pos.astype(jnp.int32)
    if size * 128 >= B:
        return compact_positions_sort(mask, size, fill)
    R = B // 128
    rows = mask.reshape(R, 128)
    rowhit = rows.any(axis=1)
    (rpos,) = jnp.nonzero(rowhit, size=size, fill_value=R)
    sub = rows[jnp.minimum(rpos, R - 1)] & (rpos < R)[:, None]
    (spos,) = jnp.nonzero(sub.reshape(-1), size=size, fill_value=size * 128)
    srow = jnp.minimum(spos // 128, size - 1)
    pos = rpos[srow] * 128 + (spos % 128)
    return jnp.where(spos < size * 128, pos, fill).astype(jnp.int32)


class FilteredLookup(NamedTuple):
    pos: jnp.ndarray  # (C,) int32 flat query positions of survivors (B = none)
    result: LookupResult  # exact lookup over the C compacted survivors
    n_candidates: jnp.ndarray  # () int32 — true survivor count (overflow check)


def filtered_lookup(
    bm: DeviceBitmap,
    table: SortedXTable,
    qhi: jnp.ndarray,
    qlo: jnp.ndarray,
    cand_max: int,
    mode: "str | None" = None,
    bm2: "DeviceBloom2 | None" = None,
    stage1_max: "int | None" = None,
) -> FilteredLookup:
    """Bitmap probe -> compact survivors -> exact binary search (C-wide).

    qhi/qlo: (B,) flat queries. Survivors beyond cand_max are dropped —
    callers must check n_candidates > cand_max and fall back to an exact
    re-scan of the step (engines do this on the host; it is a
    ~P(Binom(B, 2^-12) > cand_max) event).

    With bm2 (level-2 hashed bloom), the cascade runs two stages:
    probe1 -> compact to stage1_max -> probe2 on those survivors
    (2 gathers each) -> compact to cand_max -> exact search. The
    returned pos/result are cand_max-wide; n_candidates is poisoned
    past cand_max when EITHER stage overflows, so the caller's single
    overflow check covers both.
    """
    b = qhi.shape[0]
    mask = probe(bm, qhi, qlo, mode=mode)
    n = mask.sum().astype(jnp.int32)
    if bm2 is None:
        pos = compact_positions(mask, cand_max, b)
        safe = jnp.minimum(pos, b - 1)
        lr = lookup(table, qhi[safe], qlo[safe])
        valid = pos < b
        lr = LookupResult(lr.found & valid, lr.idx,
                          lr.found2 & valid, lr.idx2)
        return FilteredLookup(pos, lr, n)

    C1 = stage1_max if stage1_max is not None else 4 * cand_max
    pos1 = compact_positions(mask, C1, b)
    safe1 = jnp.minimum(pos1, b - 1)
    qh1, ql1 = qhi[safe1], qlo[safe1]
    mask2 = probe_bloom2(bm2, qh1, ql1) & (pos1 < b)
    n2 = mask2.sum().astype(jnp.int32)
    (pos2,) = jnp.nonzero(mask2, size=cand_max, fill_value=C1)
    pos2 = pos2.astype(jnp.int32)
    safe2 = jnp.minimum(pos2, C1 - 1)
    lr = lookup(table, qh1[safe2], ql1[safe2])
    valid = pos2 < C1
    lr = LookupResult(lr.found & valid, lr.idx, lr.found2 & valid, lr.idx2)
    # flat positions in the ORIGINAL (B,) query space, fill = b
    pos = jnp.where(valid, pos1[safe2], b)
    # poison: stage-1 overflow must trip the caller's n > cand_max check
    n_out = jnp.where(n > C1, n + cand_max, n2)
    return FilteredLookup(pos, lr, n_out)


class FilteredSurvivors(NamedTuple):
    """Cascade survivors WITHOUT device exact resolution (host-resolve
    mode): flat positions + the survivors' 64-bit truncated keys, which
    the host resolves against filter/host_table.py via searchsorted."""

    pos: jnp.ndarray  # (C,) int32 flat query positions, fill = B
    qhi: jnp.ndarray  # (C,) uint32 survivor key planes (garbage at fill)
    qlo: jnp.ndarray
    n_candidates: jnp.ndarray  # () int32 — poisoned past cand_max on
    # overflow of EITHER cascade stage


def filtered_survivors(
    bm: DeviceBitmap,
    qhi: jnp.ndarray,
    qlo: jnp.ndarray,
    cand_max: int,
    mode: "str | None" = None,
    bm2: "DeviceBloom2 | None" = None,
    stage1_max: "int | None" = None,
) -> FilteredSurvivors:
    """Bitmap probe -> compact -> (optional bloom2 -> compact), NO exact
    search: the exact level runs on the host (dropping the device table
    leaves only the filters in device memory). Overflow
    semantics match filtered_lookup: callers check
    n_candidates > cand_max and fall back to an exact host rescan."""
    b = qhi.shape[0]
    mask = probe(bm, qhi, qlo, mode=mode)
    n = mask.sum().astype(jnp.int32)
    if bm2 is None:
        pos = compact_positions(mask, cand_max, b)
        safe = jnp.minimum(pos, b - 1)
        return FilteredSurvivors(pos, qhi[safe], qlo[safe], n)
    C1 = stage1_max if stage1_max is not None else 4 * cand_max
    pos1 = compact_positions(mask, C1, b)
    safe1 = jnp.minimum(pos1, b - 1)
    qh1, ql1 = qhi[safe1], qlo[safe1]
    mask2 = probe_bloom2(bm2, qh1, ql1) & (pos1 < b)
    n2 = mask2.sum().astype(jnp.int32)
    (pos2,) = jnp.nonzero(mask2, size=cand_max, fill_value=C1)
    pos2 = pos2.astype(jnp.int32)
    safe2 = jnp.minimum(pos2, C1 - 1)
    valid = pos2 < C1
    pos = jnp.where(valid, pos1[safe2], b)
    n_out = jnp.where(n > C1, n + cand_max, n2)
    return FilteredSurvivors(pos, qh1[safe2], ql1[safe2], n_out)
