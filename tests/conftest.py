"""Test harness config: run everything on a virtual 8-device CPU mesh.

Unit tests are hermetic and run on the CPU (the card is for chip_smoke.py
and bench.py), so we force the CPU backend and fake 8 devices for the
sharding tests. Must happen before any jax backend initialization.

Tiering: `pytest -m smoke` is the bounded-time tier — modules listed in
_SMOKE_MODULES are auto-marked, chosen so the tier stays green in <=5
minutes from a COLD compile cache (the full suite is compile-bound).
Everything else is the full tier. Tests marked `gpu` need the card: the
`gpu_only` fixture skips them elsewhere, and chip_smoke.py runs them.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compile cache: recompiling the unrolled bignum graphs
# dominates test wall-time otherwise. Same placement rule as every entry
# point: JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache.
from keyhuntm1cpu_tpu.core import device  # noqa: E402

device.enable_compile_cache()

import pytest  # noqa: E402

# Modules whose tests avoid the big unrolled-bignum compiles (field/curve
# kernels, engine chunk graphs). Keep this list honest — adding a
# compile-heavy module silently blows the 5-minute budget.
_SMOKE_MODULES = {
    "test_core",
    "test_cli",
    "test_dist",
    "test_filter",
    "test_hash",
    "test_legacy",
    "test_native",
}


# Individual slow outliers inside otherwise-fast modules (compile-bound;
# measured cold: build_bitmap_device 46 s)
_SMOKE_EXCLUDE = {"test_build_bitmap_device_matches_host"}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.module.__name__ in _SMOKE_MODULES
                and item.name not in _SMOKE_EXCLUDE):
            item.add_marker(pytest.mark.smoke)


@pytest.fixture
def gpu_only():
    """Skip unless JAX runs on the card (decided at run time, never at
    import: every xdist worker must collect the same tests)."""
    if device.backend() != "gpu":
        pytest.skip("needs the GPU (run by chip_smoke.py on the card)")
