"""ctypes bindings for the native host library (native/keyhunt_host.cpp).

The native library provides the host-side runtime the reference implements
in C++ (exact secp256k1 verification, hash160, base58check target
parsing, the host baby-table builder, the host reference of the GPU walk
kernels). It is built from native/Makefile on first use (ensure_built)
into native/libkeyhunt_host.so, which git does not track; a fresh
checkout therefore pays one compile (a few seconds) as set-up time. The
GPU walk kernels build the same way (pwalk, nvcc). Where no compiler exists the verification helpers fall back
to the pure-python golden reference; the host baby table needs the
library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
LIB_NAME = "libkeyhunt_host.so"
SOURCE_NAME = "keyhunt_host.cpp"
LIB_SOURCES = (SOURCE_NAME, "walk_math.h")
# GPU walk kernels (curve/pwalk.py), built by nvcc on the first GPU run
WALK_LIB = "libkeyhunt_walk.so"
WALK_SOURCES = ("walk_kernels.cu", "walk_math.h")

_lib = None


def ensure_built(native_dir: str = NATIVE_DIR, target: str = LIB_NAME,
                 sources=LIB_SOURCES, make_vars=()) -> str:
    """Path of `target`, built with `make` when it is missing or older
    than one of its sources. A file lock serializes concurrent first
    uses (test workers, fleet processes sharing one checkout)."""
    lib = os.path.join(native_dir, target)

    def stale() -> bool:
        if not os.path.exists(lib):
            return True
        built = os.path.getmtime(lib)
        return any(os.path.getmtime(os.path.join(native_dir, src)) > built
                   for src in sources)

    if stale():
        with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if stale():
                res = subprocess.run(
                    ["make", "-C", native_dir, target, *make_vars],
                    capture_output=True, text=True,
                )
                if res.returncode != 0:
                    raise RuntimeError(
                        f"building {lib} failed:\n{res.stdout}{res.stderr}"
                    )
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first use), or None when it cannot
    be built here."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = ensure_built()
    except (OSError, RuntimeError):
        return None
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kh_sha256.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.kh_hash160.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.kh_hash160_batch.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.kh_b58check_decode.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.kh_b58check_decode.restype = ctypes.c_int
    lib.kh_parse_addresses.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.kh_parse_addresses.restype = ctypes.c_uint64
    lib.kh_scalar_mult.argtypes = [u8p, u8p, u8p]
    lib.kh_scalar_mult.restype = ctypes.c_int
    lib.kh_verify_h160.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int, u8p, u8p]
    lib.kh_baby_build.argtypes = [
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.kh_baby_build.restype = ctypes.c_int
    lib.kh_baby_keys_range.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.kh_baby_keys_range.restype = ctypes.c_int
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.kh_walk_bases_ref.argtypes = [vp] * 7 + [u64]
    lib.kh_walk_bases_ref.restype = None
    lib.kh_walk_blocks_ref.argtypes = [vp] * 7 + [u64, u64, ctypes.c_int]
    lib.kh_walk_blocks_ref.restype = ctypes.c_int
    _lib = lib
    return lib


def require() -> ctypes.CDLL:
    """The native library, or an error saying why it is missing."""
    lib = load()
    if lib is None:
        ensure_built()  # raises with the build's output
    return lib


def available() -> bool:
    return load() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sha256(msg: bytes) -> bytes:
    lib = load()
    if lib is None:
        import hashlib

        return hashlib.sha256(msg).digest()
    buf = np.frombuffer(msg, dtype=np.uint8).copy()
    out = np.zeros(32, dtype=np.uint8)
    lib.kh_sha256(_u8(buf), len(msg), _u8(out))
    return out.tobytes()


def hash160(msg: bytes) -> bytes:
    lib = load()
    if lib is None:
        from .ref import hashref

        return hashref.hash160(msg)
    buf = np.frombuffer(msg, dtype=np.uint8).copy()
    out = np.zeros(20, dtype=np.uint8)
    lib.kh_hash160(_u8(buf), len(msg), _u8(out))
    return out.tobytes()


def scalar_mult(k: int) -> Optional[Tuple[int, int]]:
    lib = load()
    if lib is None:
        from .ref import ecref

        return ecref.scalar_mult(k)
    kb = np.frombuffer(k.to_bytes(32, "big"), dtype=np.uint8).copy()
    x = np.zeros(32, dtype=np.uint8)
    y = np.zeros(32, dtype=np.uint8)
    if lib.kh_scalar_mult(_u8(kb), _u8(x), _u8(y)) != 0:
        return None
    return int.from_bytes(x.tobytes(), "big"), int.from_bytes(y.tobytes(), "big")


def parse_addresses(text: bytes, max_count: int) -> np.ndarray:
    """Bulk base58check -> (N, 20) uint8 hash160s (zeros for bad lines)."""
    lib = load()
    if lib is None:
        from .ref import hashref

        rows = []
        for ln in text.decode().splitlines():
            tok = ln.split()[0] if ln.split() else ""
            if not tok:
                continue
            try:
                rows.append(np.frombuffer(hashref.b58check_decode(tok)[1:], dtype=np.uint8))
            except Exception:
                rows.append(np.zeros(20, dtype=np.uint8))
        return np.stack(rows) if rows else np.zeros((0, 20), dtype=np.uint8)
    out = np.zeros((max_count, 20), dtype=np.uint8)
    n = lib.kh_parse_addresses(text, len(text), _u8(out), max_count)
    return out[:n]


def verify_h160(keys: List[int], target: bytes, compressed: bool = True) -> List[bool]:
    """Batch exact verification: hash160(pubkey(k)) == target?"""
    lib = load()
    if lib is None:
        from .ref import ecref, hashref

        out = []
        for k in keys:
            pt = ecref.scalar_mult(k)
            out.append(
                pt is not None
                and hashref.pubkey_to_hash160(pt, compressed) == target
            )
        return out
    kb = np.zeros((len(keys), 32), dtype=np.uint8)
    for i, k in enumerate(keys):
        kb[i] = np.frombuffer((k % (1 << 256)).to_bytes(32, "big"), dtype=np.uint8)
    tgt = np.frombuffer(target, dtype=np.uint8).copy()
    res = np.zeros(len(keys), dtype=np.uint8)
    lib.kh_verify_h160(_u8(kb), len(keys), 0 if compressed else 1, _u8(tgt), _u8(res))
    return [bool(v) for v in res]
