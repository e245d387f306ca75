"""f32-vs-f64 acceptance drift probe (VERDICT r2 task #5).

Runs the synthetic stage-3 e2e in the requested precision and writes
the accepted point/observation sets to an npz.  Run twice (once with
--x64) and diff — tests/test_f64_parity.py does exactly that and
quantifies the drift.  The reference mixes f64 GN during matching
(reference: src/edgegraph3d/utils/geometry/triangulation.cpp:105-176)
with f32 GN in the filter (filtering/gauss_newton.cpp); this engine
runs f32 everywhere, so the acceptance gates must be demonstrably
fp-robust.

Usage: python tools/f64_probe.py OUT.npz [--x64]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.x64:
        jax.config.update("jax_enable_x64", True)

    import numpy as np

    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.core import synthetic
    from edgegraph3d_tpu.matching import matches as mm
    from edgegraph3d_tpu.matching import refpoints
    from edgegraph3d_tpu.plgs import extraction

    cfg = EdgeGraphConfig().replace(
        max_polylines_per_view=256, max_polyline_len=128,
        max_follow_steps=64,
        dtype="float64" if args.x64 else "float32")
    sfmd, edge_imgs, curves = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=12,
        width=320, height_px=240, focal=400.0, seed=3)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)
    manager = mm.MatchesManager(np.asarray(ctx.plg_length))
    pts = refpoints.reconstruct_from_refpoints(
        sfmd, ctx, refpoint_chunk=64, seed_chunk=512,
        max_starting_views=2, manager=manager)
    np.savez(args.out, X=np.asarray(pts.X, np.float64),
             obs_mask=pts.obs_mask, obs_xy=np.asarray(pts.obs_xy,
                                                      np.float64),
             seed_id=pts.seed_id, chain_order=pts.chain_order)
    print(f"{'f64' if args.x64 else 'f32'}: {len(pts.X)} points, "
          f"{int(pts.obs_mask.sum())} observations")


if __name__ == "__main__":
    main()
