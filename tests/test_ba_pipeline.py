"""Joint bundle adjustment as a pipeline stage (config.ba_steps /
CLI --ba-steps): the flagship multi-device capability is reachable from
the product, and its benefit is measured.

Generalizes the reference's per-point-only refinement
(reference: src/edgegraph3d/filtering/gauss_newton.cpp:136-178 — points
free, cameras fixed) to a joint Schur-LM over cameras AND points
(ops/ba.py); here it runs inside run_pipeline between reconstruction
and the outlier filter.
"""

import numpy as np
import pytest

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.pipeline import PipelineStats, run_pipeline

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128, max_follow_steps=64)


def _noisy_pose_scene(rot_sigma=0.0035, seed=3):
    """Observations at TRUE projections, camera rotations perturbed
    ~0.2 deg — the realistic imperfect-SfM input where joint BA has
    something to recover (same construction as test_fmat_ab.py)."""
    sfmd, edge_imgs, curves = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=12, width=320, height_px=240,
        focal=400.0, seed=seed)
    rng = np.random.default_rng(0)
    for c in range(sfmd.n_cameras):
        w = rng.normal(0, rot_sigma, 3)
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        dR = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * (K_ @ K_)
        sfmd.R[c] = dR @ sfmd.R[c]
        sfmd.t[c] = -sfmd.R[c] @ sfmd.center[c]
    return sfmd, edge_imgs, curves


def _reproj_mse(sfmd, first):
    """Mean squared reprojection residual of the edge-points."""
    P = sfmd.P
    tot, n = 0.0, 0
    for i in range(first, sfmd.n_points):
        Xh = np.append(sfmd.points[i], 1.0)
        pr = P[sfmd.obs_cam[i]] @ Xh
        pr = pr[:, :2] / pr[:, 2:3]
        tot += float(((pr - sfmd.obs_xy[i]) ** 2).sum())
        n += len(sfmd.obs_cam[i])
    return tot / max(n, 1)


@pytest.fixture(scope="module")
def ab():
    sfmd, edge_imgs, _ = _noisy_pose_scene()
    res = {}
    for steps in (0, 8):
        stats = PipelineStats()
        out = run_pipeline(sfmd, edge_imgs,
                           CFG.replace(ba_steps=steps),
                           max_starting_views=2, stats=stats)
        res[steps] = (out, stats, sfmd.n_points)
    return res


def test_ba_stage_runs_and_reports(ab):
    out, stats, first = ab[8]
    assert "joint_ba" in stats.timings
    assert stats.metrics["ba_mse_before"] >= 0
    assert out.n_points > first           # edge points survived


def test_ba_reduces_reprojection_error(ab):
    """The measured benefit: joint BA must cut the solver's own mean
    squared residual AND the final output's edge-point reprojection
    error on the noisy-pose scene."""
    out0, _, first0 = ab[0]
    out8, stats, first8 = ab[8]
    assert stats.metrics["ba_mse_after"] < stats.metrics["ba_mse_before"]
    m0 = _reproj_mse(out0, first0)
    m8 = _reproj_mse(out8, first8)
    print(f"edge-point reproj mse: no-BA {m0:.4f} px^2, "
          f"BA(8) {m8:.4f} px^2; solver mse "
          f"{stats.metrics['ba_mse_before']:.4f} -> "
          f"{stats.metrics['ba_mse_after']:.4f}")
    assert m8 < m0

def test_ba_nonregression_on_point_count(ab):
    """BA must not collapse the reconstruction (filter keeps a
    comparable edge-point set)."""
    out0, _, first = ab[0]
    out8, _, _ = ab[8]
    n0 = out0.n_points - first
    n8 = out8.n_points - first
    assert n8 >= 0.8 * n0


def test_cli_flag_parses():
    from edgegraph3d_tpu.cli import edge_graph_3d as cli
    import argparse
    ap_err = {}
    try:
        cli.main(["--ba-steps", "4", "a", "b", "c", "d.json", "e.json"])
    except (SystemExit, FileNotFoundError, IsADirectoryError,
            NotADirectoryError, OSError) as e:
        ap_err["e"] = e
    # argparse accepted the flag (failure, if any, came from the
    # missing input files, not from parsing)
    assert not isinstance(ap_err.get("e"), SystemExit) or \
        getattr(ap_err["e"], "code", 2) != 2
