"""Full-pipeline and filtering tests (the complete minimum slice)."""

import json
import os

import numpy as np
import pytest

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import sfm as sfm_io
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.filtering.density import density_filter
from edgegraph3d_tpu.filtering.outliers import filter_sfm_data
from edgegraph3d_tpu.io.png import write_png
from edgegraph3d_tpu.pipeline import PipelineStats, run_pipeline

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128, max_follow_steps=64)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_cube_scene(n_cams=8, n_refpoints_per_edge=8,
                                     width=320, height_px=240, focal=400.0,
                                     seed=7)


def test_density_filter_sequential_semantics():
    # 3 points sharing one cell in one view; only the first survives
    obs_xy = np.zeros((3, 1, 2), dtype=np.float32)
    obs_xy[:, 0] = [[10.0, 10.0], [10.5, 10.4], [11.0, 10.9]]
    obs_mask = np.ones((3, 1), dtype=bool)
    keep = density_filter(obs_xy, obs_mask, 100, 100, cell=3)
    assert keep.tolist() == [True, False, False]
    # far-apart points all survive
    obs_xy2 = np.zeros((3, 1, 2), dtype=np.float32)
    obs_xy2[:, 0] = [[10.0, 10.0], [50.0, 50.0], [90.0, 90.0]]
    keep2 = density_filter(obs_xy2, obs_mask, 100, 100, cell=3)
    assert keep2.all()
    # second view gives the blocked point a free cell
    obs_xy3 = np.zeros((2, 2, 2), dtype=np.float32)
    obs_xy3[:, 0] = [[10.0, 10.0], [10.2, 10.2]]
    obs_xy3[0, 1] = [30.0, 30.0]
    obs_xy3[1, 1] = [60.0, 60.0]
    keep3 = density_filter(obs_xy3, np.ones((2, 2), bool), 100, 100, cell=3)
    assert keep3.all()


def test_density_filter_matches_sequential_reference(rng):
    """Against a brute-force sequential implementation."""
    N, V = 200, 4
    obs_xy = rng.uniform(0, 90, (N, V, 2)).astype(np.float32)
    obs_mask = rng.random((N, V)) < 0.7
    obs_mask[:, 0] = True
    keep = density_filter(obs_xy, obs_mask, 100, 100, cell=3)

    occ = np.zeros((V, 35, 35), dtype=bool)
    ref = np.zeros(N, dtype=bool)
    for i in range(N):
        cells = [(v, int(obs_xy[i, v, 1] / 3), int(obs_xy[i, v, 0] / 3))
                 for v in range(V) if obs_mask[i, v]]
        if any(not occ[c] for c in cells):
            ref[i] = True
            for c in cells:
                occ[c] = True
    np.testing.assert_array_equal(keep, ref)


def test_density_round_path_matches_sequential(rng):
    """The round-based claim path (the formulation that parallelizes at
    multi-device scale) must equal the exact sequential pass on the same
    workload — forced via `sequential_threshold=0` so the fast path
    cannot mask it (round-3 advisory: both prior tests exercised only
    the sequential branch)."""
    N, V = 500, 4
    obs_xy = rng.uniform(0, 90, (N, V, 2)).astype(np.float32)
    obs_mask = rng.random((N, V)) < 0.7
    obs_mask[:, 0] = True
    seq = density_filter(obs_xy, obs_mask, 100, 100, cell=3)
    rounds = density_filter(obs_xy, obs_mask, 100, 100, cell=3,
                            sequential_threshold=0)
    np.testing.assert_array_equal(rounds, seq)


def test_outlier_filter(scene):
    sfmd, _, _ = scene
    n_ref = sfmd.n_points
    # append bad edge-points: random 3D points with inconsistent obs
    rng = np.random.default_rng(0)
    bad_X = rng.uniform(-1, 1, (20, 3))
    bad_obs_cam = [np.asarray([0, 1, 2, 3], np.int32)] * 20
    bad_obs_xy = [rng.uniform(0, 200, (4, 2)) for _ in range(20)]
    aug = sfm_io.add_edge_points(sfmd, bad_X, bad_obs_cam, bad_obs_xy)
    out = filter_sfm_data(aug, first_edgepoint=n_ref)
    # all original refpoints survive; all garbage removed
    assert out.n_points == n_ref
    np.testing.assert_allclose(out.points[:5], sfmd.points[:5], atol=1e-3)


def test_filter_view_count_threshold(scene):
    sfmd, _, _ = scene
    n_ref = sfmd.n_points
    # a perfect edge-point with only 2 observations -> dropped (<3 views)
    X = sfmd.points[0:1] + 0.001
    xy, front = synthetic.project_points(sfmd, X)
    aug = sfm_io.add_edge_points(
        sfmd, X, [np.asarray([0, 1], np.int32)],
        [np.stack([xy[0, 0], xy[1, 0]])])
    out = filter_sfm_data(aug, first_edgepoint=n_ref)
    assert out.n_points == n_ref


def test_full_pipeline(scene):
    sfmd, edge_imgs, curves = scene
    out = run_pipeline(sfmd, edge_imgs, CFG, max_starting_views=2)
    n_new = out.n_points - sfmd.n_points
    assert n_new > 20
    # new points lie on the true curves
    cc = np.concatenate(curves)
    new_X = out.points[sfmd.n_points:]
    d = np.sqrt(((new_X[:, None] - cc[None]) ** 2).sum(-1)).min(1)
    assert np.median(d) < 0.03
    # every edge point has >= 3 observations (view-count filter)
    for i in range(sfmd.n_points, out.n_points):
        assert len(out.obs_cam[i]) >= 3


def test_cli_end_to_end(scene, tmp_path):
    """Drive the CLI surface: folders + JSON in, JSON out."""
    sfmd, edge_imgs, _ = scene
    edges_dir = tmp_path / "edges"
    imgs_dir = tmp_path / "imgs"
    work_dir = tmp_path / "work"
    edges_dir.mkdir()
    imgs_dir.mkdir()
    for v in range(edge_imgs.shape[0]):
        write_png(str(edges_dir / f"synthetic_{v:04d}.png"), edge_imgs[v])
    sfm_io.write_sfm_data(sfmd, str(tmp_path / "input.json"))

    from edgegraph3d_tpu.cli.edge_graph_3d import main
    rc = main([str(imgs_dir), str(edges_dir), str(work_dir),
               str(tmp_path / "input.json"), str(tmp_path / "out.json"),
               "--max-starting-views", "2"])
    assert rc == 0
    assert (work_dir / "before_filtering.json").exists()
    out = sfm_io.read_sfm_data(str(tmp_path / "out.json"))
    assert out.n_points > sfmd.n_points
    # verbatim blocks preserved
    doc = json.loads((tmp_path / "out.json").read_text())
    orig = json.loads((tmp_path / "input.json").read_text())
    assert doc["views"] == orig["views"]
    assert doc["intrinsics"] == orig["intrinsics"]


def test_checkpoint_restart(scene, tmp_path):
    """Failure-recovery story (SURVEY §5): a killed run restarts from
    the stage-boundary checkpoints — the PLG extraction resumes from
    plgs.npz and the final output is identical to the uninterrupted
    run.  before_filtering.json additionally lets filtering re-run
    offline (the reference's mid-pipeline dump, edge_matcher.cpp:129)."""
    sfmd, edge_imgs, _ = scene
    wf = str(tmp_path / "work")
    out1 = run_pipeline(sfmd, edge_imgs, CFG, working_folder=wf,
                        max_starting_views=2)
    assert (tmp_path / "work" / "plgs.npz").exists()
    assert (tmp_path / "work" / "before_filtering.json").exists()
    assert (tmp_path / "work" / "outgraph_3d.npz").exists()
    # "restart": a fresh process would hit the same folder; extraction
    # must load the checkpoint (CORRUPT the images to prove it is not
    # re-extracted) and reproduce the identical output
    stats = PipelineStats()
    out2 = run_pipeline(sfmd, np.zeros_like(edge_imgs), CFG,
                        working_folder=wf, max_starting_views=2,
                        stats=stats)
    assert out2.n_points == out1.n_points
    np.testing.assert_allclose(out2.points, out1.points, atol=1e-9)
    # offline filter re-run from the mid-pipeline checkpoint
    from edgegraph3d_tpu.filtering.outliers import filter_sfm_data
    mid = sfm_io.read_sfm_data(str(tmp_path / "work" /
                                   "before_filtering.json"))
    refiltered = filter_sfm_data(mid, sfmd.n_points)
    assert refiltered.n_points == out1.n_points
    # per-run manifest: machine-readable, diffable, complete
    import json
    man = json.load(open(tmp_path / "work" / "stats.json"))
    for key in ("config_hash", "config", "timings", "counts",
                "counters", "n_edge_points", "n_views"):
        assert key in man, key
    assert man["n_points_out"] == out2.n_points
    assert "outlier_filter" in man["timings"]
    from edgegraph3d_tpu.pipeline import config_hash
    assert man["config_hash"] == config_hash(CFG)
    # counters (incl. overflow observability) are ints, diff-friendly
    assert all(isinstance(v, int) for v in man["counters"].values())


def test_filter_cli(scene, tmp_path):
    sfmd, _, _ = scene
    sfm_io.write_sfm_data(sfmd, str(tmp_path / "in.json"))
    from edgegraph3d_tpu.cli.filter import main
    rc = main(["-s", "0", str(tmp_path / "in.json"),
               str(tmp_path / "out.json")])
    assert rc == 0
    out = sfm_io.read_sfm_data(str(tmp_path / "out.json"))
    assert out.n_points == sfmd.n_points  # perfect points all survive


def test_json_to_ply_cli(scene, tmp_path):
    sfmd, _, _ = scene
    sfm_io.write_sfm_data(sfmd, str(tmp_path / "in.json"))
    from edgegraph3d_tpu.cli.json_to_ply import main
    rc = main([str(tmp_path / "in.json"), str(tmp_path / "out.ply")])
    assert rc == 0
    txt = (tmp_path / "out.ply").read_text()
    assert txt.startswith("ply")
    assert f"element vertex {sfmd.n_points}" in txt


def test_coordinate_transform(scene, tmp_path):
    sfmd, _, _ = scene
    c_true = 2.5
    th = 0.7
    R_true = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    t_true = np.array([1.0, -2.0, 3.0])
    targets = (c_true * (R_true @ sfmd.center.T)).T + t_true
    np.savetxt(tmp_path / "poses.txt", targets)
    sfm_io.write_sfm_data(sfmd, str(tmp_path / "in.json"))

    from edgegraph3d_tpu.cli.coordinate_system_transform import main
    rc = main([str(tmp_path / "in.json"), str(tmp_path / "poses.txt"),
               str(tmp_path / "out.json")])
    assert rc == 0
    out = sfm_io.read_sfm_data(str(tmp_path / "out.json"))
    np.testing.assert_allclose(out.center, targets, atol=1e-6)
    # points transformed consistently: reprojection still matches
    P = out.P
    for pid in range(0, out.n_points, 11):
        Xh = np.append(out.points[pid], 1.0)
        for c, xy in zip(out.obs_cam[pid],
                         np.asarray(out.obs_xy[pid]).reshape(-1, 2)):
            pr = P[int(c)] @ Xh
            np.testing.assert_allclose(pr[:2] / pr[2], xy, atol=1e-3)
