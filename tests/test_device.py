"""core/device.py: the one backend decision and the compile-cache rule."""

import os

import jax
import pytest

from keyhuntm1cpu_tpu.core import device


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_backend_supported(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert device.backend() == platform
    assert device.on_gpu() is (platform == "gpu")


@pytest.mark.parametrize("platform", ["rocm", "METAL", "ipu"])
def test_backend_unknown_platform_raises(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        device.backend()


def test_require_gpu_fails_without_card():
    assert device.backend() == "cpu"  # conftest pins the CPU
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    assert path == os.path.join(device.CHECKOUT, ".jax_cache")
    # the checkout is the repo root: it holds the package
    assert os.path.isdir(os.path.join(device.CHECKOUT, "keyhuntm1cpu_tpu"))


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
