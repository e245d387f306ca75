"""End-to-end stage-3 reconstruction on a synthetic scene
(SURVEY.md §7 step 4: the minimum end-to-end slice)."""

import numpy as np
import pytest

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import refpoints
from edgegraph3d_tpu.plgs import extraction


@pytest.fixture(scope="module")
def recon():
    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128,
                                    max_follow_steps=64)
    sfmd, edge_imgs, curves = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=12,
        width=320, height_px=240, focal=400.0, seed=3)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)
    pts = refpoints.reconstruct_from_refpoints(
        sfmd, ctx, refpoint_chunk=64, seed_chunk=512,
        max_starting_views=2)
    return sfmd, curves, pts


def _dist_to_curves(X, curves):
    cc = np.concatenate(curves, axis=0)
    d = np.sqrt(((X[:, None] - cc[None]) ** 2).sum(-1)).min(axis=1)
    return d


def test_produces_points(recon):
    _, _, pts = recon
    # interval dedup keeps one sweep per polyline arc, so the count is
    # near-unique coverage rather than duplicated sweeps (the exact
    # reference corner-clear — one sequential pass, not a fixpoint —
    # fragments this tiny scene a bit more than the r1 approximation)
    assert len(pts.X) > 15


def test_points_lie_on_curves(recon):
    sfmd, curves, pts = recon
    d = _dist_to_curves(pts.X, curves)
    # scene scale ~1.5; curve sampling spacing ~0.02
    assert np.median(d) < 0.02
    assert np.quantile(d, 0.9) < 0.05


def test_observations_reproject(recon):
    """Attached 2D observations agree with the 3D points' projections."""
    sfmd, _, pts = recon
    P = sfmd.P
    Xh = np.concatenate([pts.X, np.ones((len(pts.X), 1))], axis=1)
    proj = np.einsum("vij,nj->nvi", P, Xh)
    proj_xy = proj[..., :2] / proj[..., 2:3]
    err = np.linalg.norm(proj_xy - pts.obs_xy, axis=-1)
    err = err[pts.obs_mask]
    assert np.median(err) < 1.5
    assert (err < 5.0).mean() > 0.9


def test_min_three_observations(recon):
    _, _, pts = recon
    assert (pts.obs_mask.sum(axis=1) >= 3).all()


def test_chains_extend_beyond_refpoints(recon):
    """Following sweeps out many more points than the seed refpoints."""
    sfmd, _, pts = recon
    assert len(pts.X) > sfmd.n_points * 0.5


def test_compacted_seed_path_matches_dense():
    """The two-kernel compacted seed formation (_start_sweep +
    _seed_from_starts) must produce the same seed set as the dense
    _seed_sweep reference kernel — same detection, selection, and GN
    math, only skipping invalid start slots."""
    import jax.numpy as jnp

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128,
                                    max_follow_steps=64)
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=6, n_refpoints_per_curve=10,
        width=320, height_px=240, focal=400.0, seed=11)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)
    obs_xy, obs_mask = refpoints.dense_observations(sfmd)
    N = 64
    ox = jnp.asarray(np.pad(obs_xy[:N], ((0, max(0, N - len(obs_xy))),
                                         (0, 0), (0, 0))))
    om = jnp.asarray(np.pad(obs_mask[:N],
                            ((0, max(0, N - len(obs_xy))), (0, 0))))
    M = cfg.max_candidates_per_view

    dense = refpoints._seed_sweep(
        ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
        ctx.F_table, ctx.cell, ox, om, om, M, cfg)
    dbuf, dn = refpoints._pack_seed_outputs(
        dense, int(np.prod(dense["valid"].shape)))
    dense_rows = np.asarray(dbuf)[: int(dn)]

    cap = N * om.shape[1] * M
    sbuf, ns = refpoints._start_sweep(
        ctx.plg_coords, ctx.grids, ctx.cell, ox, om,
        cfg.detection_starting_dist_px, M, cap)
    cbuf, cn = refpoints._seed_from_starts(
        ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
        ctx.F_table, ctx.cell, sbuf, ns, ox, om, M, cfg, cap)
    comp_rows = np.asarray(cbuf)[: int(cn)]

    assert int(dn) > 0
    assert comp_rows.shape == dense_rows.shape
    # discrete fields exactly, float fields to tolerance
    np.testing.assert_array_equal(comp_rows[:, 0:9], dense_rows[:, 0:9])
    np.testing.assert_array_equal(comp_rows[:, 21], dense_rows[:, 21])
    np.testing.assert_allclose(comp_rows[:, 9:21], dense_rows[:, 9:21],
                               rtol=1e-4, atol=1e-4)


def test_compacted_expansion_matches_dense():
    """expand_chains_compact must equal expand_chains_sweep on the same
    chains (same detection, continuity, and GN math; only padding slots
    are skipped)."""
    import jax.numpy as jnp

    from edgegraph3d_tpu.matching import expansion, matches as mm

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128,
                                    max_follow_steps=64)
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=6, n_refpoints_per_curve=10,
        width=320, height_px=240, focal=400.0, seed=5)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)
    seeds_np, seed_ref = refpoints.compute_seeds(sfmd, ctx, 64, 2)
    manager = mm.MatchesManager(np.asarray(ctx.plg_length))
    X, obs3, cams3, refs, seed_ids, orders = refpoints.sweep_seeds(
        seeds_np, seed_ref, ctx, manager, 512)

    T = 32
    gather, vld = expansion.group_chains(seed_ids, orders, max_t=T)
    C = 32
    gi = np.pad(gather[:C], ((0, max(0, C - len(gather))), (0, 0)))
    vl = np.pad(vld[:C], ((0, max(0, C - len(vld))), (0, 0)))
    X32 = np.asarray(X, np.float32)
    o32 = np.asarray(obs3, np.float32)
    cm = jnp.asarray(cams3[gi[:, 0]].astype(np.int32))

    Xd, xyd, okd, _ = expansion.expand_chains_sweep(
        ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
        jnp.asarray(X32[gi]), jnp.asarray(o32[gi]), cm,
        jnp.asarray(vl), cfg)

    kidx = np.flatnonzero(vl.reshape(-1))
    rows = gi.reshape(-1)[kidx]
    n_k = len(kidx)
    K = C * T
    pad_k = K - n_k
    Xc, xyc, okc, _ = expansion.expand_chains_compact(
        ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table, ctx.cell,
        jnp.asarray(np.pad(X32[rows], ((0, pad_k), (0, 0)))),
        jnp.asarray(np.pad(o32[rows], ((0, pad_k), (0, 0), (0, 0)))),
        cm, jnp.asarray(np.pad((kidx // T).astype(np.int32), (0, pad_k))),
        jnp.asarray(np.pad((kidx % T).astype(np.int32), (0, pad_k))),
        jnp.asarray(np.arange(K) < n_k), jnp.asarray(vl), cfg, C, T)

    ci = kidx // T
    ti = kidx % T
    assert n_k > 0
    np.testing.assert_array_equal(np.asarray(okc)[:n_k],
                                  np.asarray(okd)[ci, ti])
    np.testing.assert_allclose(np.asarray(Xc)[:n_k],
                               np.asarray(Xd)[ci, ti], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(xyc)[:n_k],
                               np.asarray(xyd)[ci, ti], rtol=1e-4,
                               atol=1e-3)


def test_fused_path_matches_two_phase():
    """The round-4 fused megakernel (detection -> seeding -> follow ->
    pack in ONE device program, refpoints._seed_follow_fused) must be
    seed-for-seed and point-for-point identical to the two-phase path
    it replaces — including across multiple refpoint chunks (the
    global seed numbering and post-hoc claim order must agree)."""
    from edgegraph3d_tpu.matching import matches as mm

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128,
                                    max_follow_steps=64)
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=12,
        width=320, height_px=240, focal=400.0, seed=3)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)

    # refpoint_chunk=64 forces multiple chunks on this 96-refpoint scene
    seeds_np, seed_ref = refpoints.compute_seeds(
        sfmd, ctx, 64, max_starting_views=2)
    man1 = mm.MatchesManager(np.asarray(ctx.plg_length))
    res1 = refpoints.sweep_seeds(seeds_np, seed_ref, ctx, man1, 512)

    round0, n_seeds = refpoints.compute_and_follow_seeds(
        sfmd, ctx, 64, max_starting_views=2)
    man2 = mm.MatchesManager(np.asarray(ctx.plg_length))
    res2 = refpoints.sweep_seeds(None, None, ctx, man2, 512,
                                 precomputed=round0)

    assert n_seeds == len(seed_ref)
    for a, b in zip(res1, res2):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert man1.counters == man2.counters


@pytest.mark.parametrize("seed_chunk", [16, 32])
def test_sweep_order_independent_of_seed_chunk(seed_chunk):
    """The sweep emits points seed by seed in chain order, a fixed
    order whatever the seed chunk width: the
    density filter downstream is first-come, so the order is part of
    the result, and the chunk widths differ by backend and between the
    single-device and mesh drivers."""
    from edgegraph3d_tpu.matching import matches as mm

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128,
                                    max_follow_steps=64)
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=12,
        width=320, height_px=240, focal=400.0, seed=3)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg, cell=10.0)
    seeds_np, seed_ref = refpoints.compute_seeds(
        sfmd, ctx, 64, max_starting_views=2)
    assert len(seed_ref) > 2 * seed_chunk
    out = []
    for chunk in (seed_chunk, 1 << 12):
        man = mm.MatchesManager(np.asarray(ctx.plg_length))
        out.append(refpoints.sweep_seeds(seeds_np, seed_ref, ctx, man,
                                         chunk))
    seed, order = out[0][4], out[0][5]
    assert (np.diff(seed) >= 0).all()
    same_seed = np.diff(seed) == 0
    assert (np.diff(order)[same_seed] > 0).all()
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
