"""Matmul-precision hygiene.

At default precision a float32 matmul/einsum may run on reduced-precision
hardware paths: TF32 on NVIDIA tensor cores keeps a 10-bit mantissa,
about three decimal digits, which is multi-pixel projection error at
this engine's magnitudes (P entries ~2e3, 1600 px frames).  Package
import pins jax_default_matmul_precision="highest"
(edgegraph3d_tpu/__init__.py); these tests make the pin and its
numerical consequence regression-checked instead of review-hygiene.
"""

import pathlib
import re

import numpy as np
import pytest

import edgegraph3d_tpu  # noqa: F401  (import installs the pin)
import jax
import jax.numpy as jnp

PKG = pathlib.Path(edgegraph3d_tpu.__file__).parent


def test_package_import_pins_default_matmul_precision():
    v = jax.config.jax_default_matmul_precision
    assert str(v).lower().endswith("highest"), v


def test_no_module_overrides_matmul_precision():
    """Only __init__.py may touch the default-precision knob."""
    offenders = []
    for py in PKG.rglob("*.py"):
        if py.name == "__init__.py" and py.parent == PKG:
            continue
        if re.search(r"jax_default_matmul_precision", py.read_text()):
            offenders.append(str(py))
    assert not offenders, offenders


def test_exact_f_table_matches_f64_reference():
    """The production F table (bare `@` composition,
    ops/geometry.py:86) must agree with a float64 numpy computation to
    f32 accuracy.  Under a reduced-precision default (TF32, bf16) this
    fails by orders of magnitude; under the package pin it passes on
    every backend (parity target: geometric_utilities.cpp:683-710
    exactness)."""
    from edgegraph3d_tpu.core.synthetic import make_cube_scene
    from edgegraph3d_tpu.ops.geometry import all_fundamental_matrices

    sfmd, _, _ = make_cube_scene(n_cams=6, n_refpoints_per_edge=4,
                                 width=1600, height_px=1200, focal=2200.0)
    P = np.asarray(sfmd.P, np.float64)
    C = np.asarray(sfmd.center, np.float64)
    F_dev = np.asarray(all_fundamental_matrices(
        jnp.asarray(P, jnp.float32), jnp.asarray(C, jnp.float32)))

    # f64 reference on host
    V = len(P)
    F_ref = np.zeros((V, V, 3, 3))
    for i in range(V):
        for j in range(V):
            C1h = np.concatenate([C[i], [1.0]])
            e2 = P[j] @ C1h
            cross = np.array([[0, -e2[2], e2[1]],
                              [e2[2], 0, -e2[0]],
                              [-e2[1], e2[0], 0]])
            F = cross @ P[j] @ np.linalg.pinv(P[i])
            n = np.linalg.norm(F)
            F_ref[i, j] = F / (n if n > 1e-20 else 1.0)

    # sign-align (F is defined up to sign) and compare
    for i in range(V):
        for j in range(V):
            if i == j:
                continue
            a, b = F_dev[i, j], F_ref[i, j]
            if np.dot(a.ravel(), b.ravel()) < 0:
                b = -b
            assert np.max(np.abs(a - b)) < 1e-4, (i, j)


@pytest.mark.gpu
def test_exact_f_table_matches_f64_reference_gpu(gpu_device):
    """The F-table check, and one [1024, 1024] product under the pin,
    on the card, where a default-precision f32 product runs in TF32
    (chip_smoke.py phase c)."""
    import chip_smoke

    with jax.default_device(gpu_device):
        assert chip_smoke.f_table_max_error() < 1e-4
        assert chip_smoke.matmul_rel_error(1024) < 1e-5
