"""Outlier filtering: batched Gauss-Newton + observation-count threshold.

JAX-native replacement for the reference's filter stage
(reference: src/edgegraph3d/filtering/outliers_filtering.cpp:14-114 and
src/edgegraph3d/filtering/gauss_newton.cpp:83-178):

  * every 3D point is re-optimized over all its observations
    (<=30 f32 GN iterations); accepted if final MSE < gn_max_mse
    (default 2.25 px^2, gauss_newton.hpp:18) — one vmapped batch, the
    reference's per-point loop becomes the batch axis
  * accepted points take their optimized coordinates
  * edge-points (id >= first_edgepoint) additionally need
    n_obs > max(3, median_ray_bucket/2 - 1) observations, where
    median_ray_bucket mirrors compute_ray_stats' bucket-index median
    (outliers_filtering.cpp:14-35, 52-61)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.core.sfm import SfMData, pack_observations, \
    remove_outliers
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched

INVALID_FORCED_MIN_FILTER = -1


def gauss_newton_filter(sfmd: SfMData, gn_max_mse: float = 2.25,
                        max_iters: int = 30, chunk: int = 8192,
                        epsilon: float = 5e-7):
    """Re-optimize all points; returns (new_points [N,3], inliers [N]).

    Parity: gaussNewtonFiltering (gauss_newton.cpp:136-178) — f32 GN,
    accepted points updated in place."""
    N = sfmd.n_points
    if N == 0:
        return sfmd.points.copy(), np.zeros(0, dtype=bool)
    # bucket the observation axis (next power of two) — a data-dependent
    # max_obs would compile a fresh GN executable per scene
    max_obs = max(int(max(len(c) for c in sfmd.obs_cam)), 2)
    max_obs = 1 << (max_obs - 1).bit_length()
    packed = pack_observations(sfmd.obs_cam, sfmd.obs_xy, max_obs=max_obs,
                               dtype=np.float32)
    P = sfmd.P.astype(np.float32)
    new_pts = sfmd.points.copy()
    inliers = np.zeros(N, dtype=bool)
    # shape-bucket the batch axis (next power of two) so repeated calls
    # with nearby N reuse one compiled executable
    chunk = min(chunk, 1 << (max(N - 1, 1)).bit_length())
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        pad = chunk - (hi - lo)

        def padded(a, fill=0):
            return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                          constant_values=fill)
        P_obs = P[np.clip(padded(packed.cam_idx[lo:hi], -1), 0, None)]
        X, mse, ok = gauss_newton_batched(
            jnp.asarray(P_obs), jnp.asarray(padded(packed.xy[lo:hi])),
            jnp.asarray(padded(packed.mask[lo:hi])),
            jnp.asarray(padded(sfmd.points[lo:hi].astype(np.float32))),
            max_iters=max_iters, accept_mse=gn_max_mse, epsilon=epsilon)
        # one fused device->host transfer per chunk (each round trip is
        # a blocking host sync; ops/compaction.py)
        from edgegraph3d_tpu.ops.compaction import fetch
        packed_out = fetch(jnp.concatenate(
            [X, ok[:, None].astype(X.dtype)], axis=1))[: hi - lo]
        ok = packed_out[:, 3] > 0.5
        inliers[lo:hi] = ok
        sel = np.flatnonzero(ok)
        new_pts[lo + sel] = packed_out[sel, :3]
    return new_pts, inliers


def compute_ray_stats(sfmd: SfMData, inliers: np.ndarray):
    """(average_rays, median_ray_bucket) over inlier points (parity:
    compute_ray_stats, outliers_filtering.cpp:14-35 — the 'median' is
    the bucket index, i.e. n_rays - 1)."""
    counts = np.asarray([len(sfmd.obs_cam[i]) for i in range(sfmd.n_points)])
    sel = counts[np.asarray(inliers, dtype=bool)]
    if len(sel) == 0:
        return 0.0, 0
    avg = float(sel.mean())
    dist = np.bincount(sel - 1, minlength=sfmd.n_cameras)
    half = len(sel) // 2
    cum = np.cumsum(dist)
    median_bucket = int(np.argmax(cum >= half))
    return avg, median_bucket


def compute_inliers(sfmd: SfMData, first_edgepoint: int,
                    gn_max_mse: float = 2.25,
                    forced_min_filter: int = INVALID_FORCED_MIN_FILTER,
                    min_views_floor: int = 3, epsilon: float = 5e-7):
    """Parity: compute_inliers (outliers_filtering.cpp:37-64).
    `min_views_floor` is FILTER_3VIEWS_AMOUNT (outliers_filtering.hpp:16).
    Returns (new_points, inliers)."""
    new_pts, inliers = gauss_newton_filter(sfmd, gn_max_mse,
                                           epsilon=epsilon)
    _, median_bucket = compute_ray_stats(sfmd, inliers)
    view_filter = max(min_views_floor, median_bucket // 2 - 1)
    if forced_min_filter > INVALID_FORCED_MIN_FILTER:
        view_filter = forced_min_filter
    for i in range(first_edgepoint, sfmd.n_points):
        inliers[i] = inliers[i] and len(sfmd.obs_cam[i]) > view_filter
    return new_pts, inliers


def filter_sfm_data(sfmd: SfMData, first_edgepoint: int,
                    gn_max_mse: float = 2.25,
                    forced_min_filter: int = INVALID_FORCED_MIN_FILTER,
                    min_views_floor: int = 3, epsilon: float = 5e-7
                    ) -> SfMData:
    """Parity: filter() (outliers_filtering.cpp:94-114) — GN + view-count
    inliers, points updated to optimized coords, scene compacted."""
    new_pts, inliers = compute_inliers(sfmd, first_edgepoint, gn_max_mse,
                                       forced_min_filter, min_views_floor,
                                       epsilon)
    out = sfmd.copy()
    out.points = new_pts
    return remove_outliers(out, inliers)
