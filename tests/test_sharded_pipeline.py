"""Sharded reconstruction parity: 8-device mesh == single device.

The mesh shards the work-item axis of every sweep (refpoints, seeds,
3D points) while PLG tensors stay replicated (parallel/sharded.py); the
result must be bit-identical in structure to the single-device run —
the JAX-native determinism guarantee replacing the reference's
lock-ordered OpenMP loop (reference: plg_matching_from_refpoints.cpp:89,
plg_matches_manager.cpp:42).
"""

import numpy as np

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import refpoints as refpoints_mod
from edgegraph3d_tpu.parallel import mesh as mesh_mod
from edgegraph3d_tpu.pipeline import PipelineStats, run_pipeline
from edgegraph3d_tpu.plgs.extraction import extract_plgs

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128, max_follow_steps=32)


def _scene():
    return synthetic.make_cube_scene(n_cams=6, n_refpoints_per_edge=6,
                                     width=320, height_px=240,
                                     focal=400.0, seed=11)


def test_sharded_stage3_matches_single_device():
    sfmd, edge_imgs, _ = _scene()
    stack = extract_plgs(edge_imgs, CFG)
    ctx1 = refpoints_mod.build_context(sfmd, stack, CFG)
    pts1 = refpoints_mod.reconstruct_from_refpoints(sfmd, ctx1)

    m = mesh_mod.make_mesh(8)
    ctx8 = refpoints_mod.build_context(sfmd, stack, CFG, mesh=m)
    assert ctx8.n_shards == 8
    pts8 = refpoints_mod.reconstruct_from_refpoints(sfmd, ctx8)

    assert len(pts1.X) == len(pts8.X) > 0
    np.testing.assert_allclose(pts1.X, pts8.X, rtol=0, atol=1e-5)
    assert (pts1.obs_mask == pts8.obs_mask).all()
    np.testing.assert_allclose(pts1.obs_xy[pts1.obs_mask],
                               pts8.obs_xy[pts8.obs_mask],
                               rtol=0, atol=1e-4)
    assert (pts1.seed_refpoint == pts8.seed_refpoint).all()


def test_sharded_full_pipeline_matches_single_device():
    sfmd, edge_imgs, _ = _scene()
    out1 = run_pipeline(sfmd, edge_imgs, CFG, stats=PipelineStats())
    m = mesh_mod.make_mesh(8)
    out8 = run_pipeline(sfmd, edge_imgs, CFG, stats=PipelineStats(),
                        mesh=m)
    assert out1.n_points == out8.n_points > sfmd.n_points
    np.testing.assert_allclose(out1.points, out8.points, atol=1e-5)


def test_sharded_uneven_mesh():
    """A mesh size that does not divide the default chunks still works
    (chunks are rounded up to a device multiple)."""
    sfmd, edge_imgs, _ = _scene()
    stack = extract_plgs(edge_imgs, CFG)
    m = mesh_mod.make_mesh(3)
    ctx = refpoints_mod.build_context(sfmd, stack, CFG, mesh=m)
    pts = refpoints_mod.reconstruct_from_refpoints(sfmd, ctx)
    assert len(pts.X) > 0


def test_sharded_gn_overflow_redo_matches_single_device(monkeypatch):
    """A compacted-GN overflow is redone at the exact full width on the
    mesh as on one device.  The fast-path width is forced down to 8 rows
    so every chunk overflows; without the redo the mesh would keep the
    truncated refinement and its chains would differ."""
    from edgegraph3d_tpu.matching import following
    monkeypatch.setattr(following, "_default_gn_cap", lambda S, T: 8)
    cfg = CFG.replace(max_follow_steps=31)   # a fresh trace of the walk
    sfmd, edge_imgs, _ = _scene()
    stack = extract_plgs(edge_imgs, cfg)
    ctx1 = refpoints_mod.build_context(sfmd, stack, cfg)
    pts1 = refpoints_mod.reconstruct_from_refpoints(sfmd, ctx1)
    ctx4 = refpoints_mod.build_context(sfmd, stack, cfg,
                                       mesh=mesh_mod.make_mesh(4))
    pts4 = refpoints_mod.reconstruct_from_refpoints(sfmd, ctx4)
    assert len(pts1.X) == len(pts4.X) > 0
    np.testing.assert_allclose(pts1.X, pts4.X, rtol=0, atol=1e-5)
