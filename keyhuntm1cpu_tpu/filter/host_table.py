"""Host-resident exact baby table for BSGS host-resolution mode.

The device keeps only the probabilistic filters (direct-address bitmap +
hashed bloom, filter/bitmap.py); exact membership + baby-index payload
resolution happens HERE, on the host, against a sorted uint64 key plane
via np.searchsorted. Rationale: the device-resident sorted table costs
12 bytes/key of device memory (12 GiB at m = 2^30), while cascade
survivors are ~dozens-to-thousands per multi-million-query chunk — a
workload numpy resolves in microseconds. Capability analog: the
reference's bPtable + bsgs_thirdcheck binary search
(keyhunt.cpp:1366-1371, :3748-3775), with the final exact level moved
off-accelerator.

The table is built by the native C++ builder (native/keyhunt_host.cpp
kh_baby_build: batched group walk, one modular inversion per 1024-lane
block, on one host core) and cached on disk as two raw planes plus a
JSON meta sidecar, so production boots mmap it in O(1):

    baby_{m}.keys  (m,) uint64 LE  sorted trunc64(x(j*G))
    baby_{m}.idx   (m,) uint32 LE  payload j-1
    baby_{m}.json  meta (written LAST -> marks a complete build)
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

DEFAULT_CACHE_DIR = os.environ.get(
    "KEYHUNT_TABLE_CACHE", os.path.join(os.path.dirname(__file__), "..", "..",
                                        ".table_cache")
)

def _native():
    from .. import native

    return native.require()


def native_keys_range(from_j: int, count: int) -> np.ndarray:
    """trunc64(x(j*G)) for j in [from_j, from_j+count) via the native
    exact incremental walk (cross-check path)."""
    buf = (ctypes.c_uint64 * count)()
    rc = _native().kh_baby_keys_range(from_j, count, buf)
    if rc != 0:
        raise RuntimeError(f"kh_baby_keys_range failed rc={rc}")
    return np.array(buf[:count], dtype=np.uint64)


@dataclass(frozen=True)
class HostTable:
    """Sorted key plane + payload plane (j-1), host-resident."""

    keys: np.ndarray  # (m,) uint64, sorted
    idx: np.ndarray  # (m,) uint32, payload j-1

    @property
    def m(self) -> int:
        return int(self.keys.shape[0])

    def resolve(self, qhi: np.ndarray, qlo: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """All (query_row, j) matches for (B,) uint32 query planes.

        Returns (rows, js): rows indexes into the query arrays (repeated
        per duplicate-key match), js are 1-based baby indices. Unlike the
        device lookup's pos/pos+1 pair, the left/right searchsorted range
        surfaces EVERY truncation-collision duplicate."""
        q = (qhi.astype(np.uint64) << np.uint64(32)) | qlo.astype(np.uint64)
        left = np.searchsorted(self.keys, q, side="left")
        right = np.searchsorted(self.keys, q, side="right")
        counts = right - left
        hit = counts > 0
        if not hit.any():
            return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
        rows = np.repeat(np.nonzero(hit)[0], counts[hit])
        # flat positions of every duplicate: left[i] .. right[i]-1
        offs = np.concatenate(
            [np.arange(c) + l for l, c in zip(left[hit], counts[hit])]
        )
        js = self.idx[offs].astype(np.uint64) + np.uint64(1)
        return rows, js

    def prefault(self) -> None:
        """Pull every page of mmapped planes into the OS cache with one
        sequential pass (random searchsorted faults would otherwise leak
        into the first chunks' decode time)."""
        for arr in (self.keys, self.idx):
            if isinstance(arr, np.memmap):
                step = (1 << 24) // arr.itemsize
                s = np.uint64(0)
                with np.errstate(over="ignore"):  # the sum only forces
                    for off in range(0, arr.shape[0], step):  # page-ins;
                        s += arr[off : off + step : 4096 // arr.itemsize
                                 ].sum(dtype=np.uint64)  # wrap is fine

    def contains_all(self, q: np.ndarray) -> np.ndarray:
        """(B,) bool membership for packed uint64 queries (tests)."""
        pos = np.searchsorted(self.keys, q, side="left")
        pos = np.minimum(pos, self.m - 1)
        return self.keys[pos] == q


def _paths(m: int, cache_dir: str) -> Tuple[str, str, str]:
    base = os.path.join(cache_dir, f"baby_{m}")
    return base + ".keys", base + ".idx", base + ".json"


def _sample_digest(path: str, size: int) -> str:
    """sha256 over first/last MB + a strided middle sample — full-file
    hashing at 8+ GB costs ~20 s/GB on this host; the sample catches
    truncation/corruption without it. Cache files are locally generated,
    not adversarial."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if size > (2 << 20):
            f.seek(size // 2)
            h.update(f.read(1 << 20))
        if size > (1 << 20):
            f.seek(max(0, size - (1 << 20)))
            h.update(f.read(1 << 20))
    return h.hexdigest()


def build_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR,
                     progress: bool = False) -> None:
    """Native build -> tmp files -> validate sample -> meta -> rename.
    The .json meta is written last, so its presence marks completeness."""
    os.makedirs(cache_dir, exist_ok=True)
    kp, ip, mp = _paths(m, cache_dir)
    tkp, tip = kp + ".tmp", ip + ".tmp"
    rc = _native().kh_baby_build(m, tkp.encode(), tip.encode(),
                                 1 if progress else 0)
    if rc != 0:
        raise RuntimeError(f"kh_baby_build failed rc={rc}")
    keys = np.memmap(tkp, dtype="<u8", mode="r")
    idx = np.memmap(tip, dtype="<u4", mode="r")
    if keys.shape[0] != m or idx.shape[0] != m:
        raise RuntimeError("built table has wrong size")
    # validation: sorted keys; sampled j -> key round trips vs the exact
    # native incremental walk (independent code path from the builder)
    rng = np.random.default_rng(1234)
    sample = rng.integers(0, m, size=min(256, m))
    for s in sample.tolist():
        j = int(idx[s]) + 1
        expect = native_keys_range(j, 1)[0]
        if np.uint64(keys[s]) != expect:
            raise RuntimeError(f"table validation failed at row {s} (j={j})")
    step = max(1, m // 4096)
    if not bool(np.all(keys[::step][:-1] <= keys[::step][1:])):
        raise RuntimeError("table keys not sorted")
    meta = {
        "version": 1,
        "m": m,
        "keys_bytes": m * 8,
        "idx_bytes": m * 4,
        "keys_sample_sha256": _sample_digest(tkp, m * 8),
        "idx_sample_sha256": _sample_digest(tip, m * 4),
    }
    del keys, idx
    os.replace(tkp, kp)
    os.replace(tip, ip)
    with open(mp + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mp + ".tmp", mp)


def load_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR,
                    mmap: bool = True,
                    verify: bool = True) -> Optional[HostTable]:
    """Load a cached table, or None when absent/incomplete/mismatched."""
    kp, ip, mp = _paths(m, cache_dir)
    if not (os.path.exists(kp) and os.path.exists(ip) and os.path.exists(mp)):
        return None
    with open(mp) as f:
        meta = json.load(f)
    if meta.get("version") != 1 or meta.get("m") != m:
        return None
    if (os.path.getsize(kp) != m * 8 or os.path.getsize(ip) != m * 4):
        return None
    if verify:
        if (_sample_digest(kp, m * 8) != meta["keys_sample_sha256"]
                or _sample_digest(ip, m * 4) != meta["idx_sample_sha256"]):
            return None
    if mmap:
        keys = np.memmap(kp, dtype="<u8", mode="r")
        idx = np.memmap(ip, dtype="<u4", mode="r")
    else:
        keys = np.fromfile(kp, dtype="<u8")
        idx = np.fromfile(ip, dtype="<u4")
    return HostTable(keys, idx)


def ensure_host_table(m: int, cache_dir: str = DEFAULT_CACHE_DIR,
                      mmap: bool = True,
                      progress: bool = False) -> HostTable:
    """Cached load or native build (one core: minutes at
    m = 2^30 — run scripts/build_host_table.py ahead of time for big m)."""
    t = load_host_table(m, cache_dir, mmap=mmap)
    if t is not None:
        return t
    build_host_table(m, cache_dir, progress=progress)
    t = load_host_table(m, cache_dir, mmap=mmap)
    if t is None:
        raise RuntimeError("host table build did not produce a loadable table")
    return t
