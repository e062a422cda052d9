"""Native host library (C++) vs the pure-python golden reference."""

import random

import numpy as np
import pytest

from keyhuntm1cpu_tpu import native
from keyhuntm1cpu_tpu.ref import ecref, hashref


@pytest.fixture(scope="module", autouse=True)
def build_lib():
    if not native.available():  # builds on first use
        pytest.skip("no C++ toolchain; python fallback covered elsewhere")


def _copy_sources(dst):
    import os
    import shutil

    for name in ("Makefile",) + native.LIB_SOURCES:
        shutil.copy(os.path.join(native.NATIVE_DIR, name), dst)


def test_library_built_on_first_use(tmp_path):
    """A checkout without the .so builds it from native/Makefile once;
    a fresh library is reused and a newer source rebuilds it."""
    import ctypes
    import os

    _copy_sources(tmp_path)
    lib = native.ensure_built(str(tmp_path))
    assert lib == str(tmp_path / native.LIB_NAME)
    assert hasattr(ctypes.CDLL(lib), "kh_baby_build")
    built = os.path.getmtime(lib)
    os.utime(lib, (built - 100, built - 100))
    for src in native.LIB_SOURCES:
        os.utime(tmp_path / src, (built - 200, built - 200))
    native.ensure_built(str(tmp_path))
    assert os.path.getmtime(lib) == built - 100  # up to date: no rebuild
    os.utime(tmp_path / native.SOURCE_NAME, (built, built))
    native.ensure_built(str(tmp_path))
    assert os.path.getmtime(lib) > built - 100  # stale: rebuilt


def test_library_build_failure_reports_output(tmp_path):
    _copy_sources(tmp_path)
    (tmp_path / native.SOURCE_NAME).write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.ensure_built(str(tmp_path))


def test_sha256_vectors():
    import hashlib

    for msg in (b"", b"abc", b"x" * 55, b"y" * 56, b"z" * 64, b"w" * 100):
        assert native.sha256(msg) == hashlib.sha256(msg).digest()


def test_hash160():
    assert (
        native.hash160(ecref.serialize_pubkey(ecref.G)).hex()
        == "751e76e8199196d454941c45d1b3a323f1433bd6"
    )


def test_scalar_mult_matches_golden():
    random.seed(11)
    keys = [1, 2, ecref.N - 1, 0x7CCE5EFDACCF6808] + [
        random.randrange(1, ecref.N) for _ in range(20)
    ]
    for k in keys:
        assert native.scalar_mult(k) == ecref.scalar_mult(k), hex(k)


def test_parse_addresses_bulk():
    addrs = [hashref.pubkey_to_address(ecref.scalar_mult(k)) for k in range(1, 33)]
    text = ("\n".join(addrs) + "\nnotanaddress\n").encode()
    out = native.parse_addresses(text, 64)
    assert len(out) == 33
    for i, k in enumerate(range(1, 33)):
        assert out[i].tobytes() == hashref.pubkey_to_hash160(ecref.scalar_mult(k))
    assert out[32].tobytes() == b"\x00" * 20  # bad line -> zeros


def test_verify_batch():
    keys = [41, 42, 43]
    target = hashref.pubkey_to_hash160(ecref.scalar_mult(42))
    assert native.verify_h160(keys, target) == [False, True, False]
    target_u = hashref.pubkey_to_hash160(ecref.scalar_mult(43), compressed=False)
    assert native.verify_h160(keys, target_u, compressed=False) == [False, False, True]
