"""The accelerator this process runs on, decided in one place.

Every module that picks a device path (kernel or plain XLA, tuned shapes)
asks :func:`backend`; nothing else reads ``jax.default_backend()``. The
program supports an NVIDIA GPU and the CPU (tests, small runs); any other
JAX platform is an error rather than a silent fall-back.

The persistent compile cache is placed here too, so every entry point
(CLI, bsgsd, fleet worker, multi-host launcher, bench, chip smoke, tests)
shares one rule: ``JAX_COMPILATION_CACHE_DIR`` when it is set, otherwise
``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SUPPORTED = ("gpu", "cpu")


def backend() -> str:
    """``"gpu"`` or ``"cpu"``; raises on any other platform."""
    plat = jax.default_backend()
    if plat not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {plat!r}: this program runs on an "
            "NVIDIA GPU or on the CPU"
        )
    return plat


def on_gpu() -> bool:
    return backend() == "gpu"


def require_gpu() -> None:
    """Fail unless JAX found a GPU (measurement paths never fall back)."""
    if backend() != "gpu":
        raise RuntimeError(
            "no GPU found: JAX is running on "
            f"{jax.devices()[0].platform}; this command needs the card"
        )


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and return that directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
