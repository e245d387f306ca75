"""edgegraph3d_tpu — multi-view 3D edge reconstruction on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of
abignoli/EdgeGraph3D (WACV 2018): RGB images + binary edge images +
OpenMVG SfM JSON -> edge-point-augmented OpenMVG JSON.

Design stance (vs. the reference's pointer-graph C++):
  * polyline graphs are fixed-shape padded struct-of-arrays,
  * matching is dense batched epipolar geometry (vmap over work items),
  * chain following is `lax.scan` with bounded step counts,
  * dedup is occupancy/interval rasters claimed with scatter-max,
  * refinement is batched 3x3 Gauss-Newton / Schur-complement BA,
  * scale-out is `shard_map` over a `jax.sharding.Mesh` (views/points
    sharded, `psum`/`all_gather` collectives between the devices).
"""

__version__ = "0.1.0"

import jax as _jax

# Matmul precision pin.  At DEFAULT precision XLA may compute a float32
# matmul/einsum on a reduced-precision path: on NVIDIA tensor cores that
# is TF32, a 10-bit mantissa (about three decimal digits).  For the
# geometry math here (P entries ~2e3, 1600 px frames) that is
# multi-PIXEL projection error — the extension stage's 2 px consistency
# gate fails silently while a full-f32 backend passes.  Every
# jnp.einsum is pinned to Precision.HIGHEST per site; pinning the
# PACKAGE-WIDE default also covers the bare `@` matmuls (ops/geometry.py
# F-table composition, the 8-point rank-2/denormalize products,
# linalg3's adjugate solve, the BA kernels) and future code that forgets
# a per-site pin.  The hot paths are gather/elementwise-bound with tiny
# contractions, so full f32 should cost little; unmeasured on a GPU.
# The one deliberate exception is the stage-1 similarity kernel
# (matching/polyline_stages.py), whose products only rank graph edges.
_jax.config.update("jax_default_matmul_precision", "highest")

from edgegraph3d_tpu.config import EdgeGraphConfig

__all__ = ["EdgeGraphConfig", "__version__"]
