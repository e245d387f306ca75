"""Test configuration: run on a virtual 8-device CPU mesh.

Unless JAX_PLATFORMS says otherwise, the suite runs on the CPU, with
XLA's host platform split into 8 devices so that the multi-device
sharding paths run without several cards; __graft_entry__'s
dryrun_multichip drives the same code.  Tests marked `gpu` need a card
and skip without one: run them on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.

An empty JAX_COMPILATION_CACHE_DIR keeps the suite off the persistent
compile cache that the CLI entry points would otherwise place in the
checkout (edgegraph3d_tpu/runtime.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
    return devs[0]


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_caches():
    """Drop compiled executables between test modules.

    A full-suite run accumulates hundreds of XLA:CPU executables in one
    process; compiling the large sharded shard_map program on top of
    that state segfaulted inside LLVM twice (at the same suite
    position, never in isolation).  Bounding the in-process executable
    count avoids the crash at the cost of some recompiles."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="session")
def small_scene():
    from edgegraph3d_tpu.core.synthetic import make_scene

    return make_scene(n_cams=8, n_refpoints_per_curve=16,
                      width=320, height_px=240, focal=400.0, seed=3)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
