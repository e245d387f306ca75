"""Triangulation and batched per-point Gauss-Newton refinement.

JAX-native replacement for the reference's per-point OpenCV pipeline
(reference: src/edgegraph3d/utils/geometry/triangulation.cpp):
  * init by two-view DLT on the (min-id, max-id) camera pair
    (parity: em_estimate3Dpositions, triangulation.cpp:178-323 —
    widest-baseline heuristic) or N-view DLT,
  * <=30 damped-free Gauss-Newton iterations over all observations,
    residual r = observed - projected, mse = sum r^2 / (2N),
    convergence |mse - last_mse| < 5e-7, update X += H^-1 J^T r,
    reject on near-singular Hessian (det < 1e-5) or final mse >= accept
    (parity: em_GaussNewton + em_point2D3DJacobian,
     triangulation.cpp:53-176; filter variant gauss_newton.cpp:83-134).

All functions are batched over points: observations come in fixed-shape
padded tensors [N, O, ...] with a boolean mask, and the whole solve is
one fused XLA computation of batched 3x3 solves — the reference's
`#pragma omp for` over points becomes the batch dimension.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.ops.geometry import project
from edgegraph3d_tpu.ops.linalg3 import smallest_eigvec4, solve3

# true-f32 accumulation for tiny contractions (see geometry.py)
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


# ----------------------------------------------------------------------
# DLT triangulation
# ----------------------------------------------------------------------

def p_soa(P_obs: jnp.ndarray) -> list:
    """[N,O,3,4] per-observation cameras -> nested [O][3][4] lists of
    [N] component vectors (the internal SoA layout of every solver in
    this module).

    WHY callers want this form: a materialized GATHERED [N,3,4] f32
    keeps tiny minor dims that a tiled memory layout pads heavily (a
    broadcast of the same shape fuses for free, which is why the padded
    full-width paths never hit it).  Compacted paths gather the 36
    entries as separate [N] vectors instead; unmeasured on a GPU."""
    Pc = jnp.moveaxis(P_obs, 0, -1)                 # [O,3,4,N]
    O = P_obs.shape[1]
    return [[[Pc[o, r, c] for c in range(4)] for r in range(3)]
            for o in range(O)]


def triangulate_dlt_soa(P: list, ox: list, oy: list, mf: list
                        ) -> jnp.ndarray:
    """Homogeneous N-view DLT, SoA interface.

    P: [O][3][4] nested lists of [N] vectors, ox/oy/mf: [O] lists of
    [N] vectors (mf float validity weights) -> X [N, 3].
    Rows (x*P3 - P1), (y*P3 - P2) per view; smallest eigenvector of
    A^T A via ridged inverse iteration with a closed-form 4x4 Cholesky
    (replaces cv::triangulatePoints' SVD).
    """
    O = len(P)
    N = ox[0].shape[0]
    dtype = ox[0].dtype

    ata = [[None] * 4 for _ in range(4)]
    for a in range(4):
        for b in range(a, 4):
            ata[a][b] = jnp.zeros(N, dtype)
    for o in range(O):
        p = P[o]
        m = mf[o]
        for (coord, prow) in ((ox[o], 0), (oy[o], 1)):
            row = [coord * p[2][c] - p[prow][c] for c in range(4)]
            nrm = jnp.sqrt(row[0] ** 2 + row[1] ** 2 + row[2] ** 2
                           + row[3] ** 2)
            scale = m / jnp.maximum(nrm, 1e-12)
            row = [r * scale for r in row]
            for a in range(4):
                for b in range(a, 4):
                    ata[a][b] = ata[a][b] + row[a] * row[b]

    # ridged inverse iteration (see linalg3.smallest_eigvec4): 4x4
    # Cholesky + 4 solve rounds, all [N]-scalar arithmetic
    tr = ata[0][0] + ata[1][1] + ata[2][2] + ata[3][3]
    eps = 1e-7 * tr + 1e-30
    for a in range(4):
        ata[a][a] = ata[a][a] + eps
    sq = lambda v: jnp.sqrt(jnp.maximum(v, 1e-30))
    L11 = sq(ata[0][0])
    L21 = ata[0][1] / L11
    L31 = ata[0][2] / L11
    L41 = ata[0][3] / L11
    L22 = sq(ata[1][1] - L21 * L21)
    L32 = (ata[1][2] - L31 * L21) / L22
    L42 = (ata[1][3] - L41 * L21) / L22
    L33 = sq(ata[2][2] - L31 * L31 - L32 * L32)
    L43 = (ata[2][3] - L41 * L31 - L42 * L32) / L33
    L44 = sq(ata[3][3] - L41 * L41 - L42 * L42 - L43 * L43)

    nv = float(np.sqrt(1.0 + 1.0 + 1.0 + 1.5 ** 2))
    v = [jnp.full(N, c / nv, dtype) for c in (1.0, 1.0, 1.0, 1.5)]
    for _ in range(4):
        y1 = v[0] / L11
        y2 = (v[1] - L21 * y1) / L22
        y3 = (v[2] - L31 * y1 - L32 * y2) / L33
        y4 = (v[3] - L41 * y1 - L42 * y2 - L43 * y3) / L44
        x4 = y4 / L44
        x3 = (y3 - L43 * x4) / L33
        x2 = (y2 - L32 * x3 - L42 * x4) / L22
        x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11
        n = jnp.maximum(jnp.sqrt(x1 * x1 + x2 * x2 + x3 * x3 + x4 * x4),
                        1e-30)
        v = [x1 / n, x2 / n, x3 / n, x4 / n]
    w = jnp.where(jnp.abs(v[3]) < 1e-12,
                  jnp.where(v[3] < 0, -1e-12, 1e-12), v[3])
    return jnp.stack([v[0] / w, v[1] / w, v[2] / w], axis=-1)


def triangulate_dlt(P: jnp.ndarray, xy: jnp.ndarray,
                    mask: jnp.ndarray) -> jnp.ndarray:
    """Homogeneous N-view DLT, tensor interface.

    P: [..., O, 3, 4], xy: [..., O, 2], mask: [..., O] -> X [..., 3].
    Thin wrapper over triangulate_dlt_soa (see p_soa for why the SoA
    core exists)."""
    dtype = P.dtype
    batch_shape = mask.shape[:-1]
    O = mask.shape[-1]
    Pf = P.reshape((-1, O, 3, 4))
    xyf = xy.reshape((-1, O, 2))
    mff = mask.reshape((-1, O)).astype(dtype)
    X = triangulate_dlt_soa(
        p_soa(Pf),
        [xyf[:, o, 0] for o in range(O)],
        [xyf[:, o, 1] for o in range(O)],
        [mff[:, o] for o in range(O)])
    return X.reshape(batch_shape + (3,))


def triangulate_pair_minmax(P_obs: jnp.ndarray, xy: jnp.ndarray,
                            cam_idx: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Two-view DLT on the (min cam id, max cam id) observations.

    Mirrors em_estimate3Dpositions' widest-baseline init
    (triangulation.cpp:186-254).  P_obs: [...,O,3,4] gathered per-obs
    projection matrices, cam_idx: [...,O] int (-1 padded), mask [...,O].
    """
    big = jnp.where(mask, cam_idx, jnp.iinfo(jnp.int32).max)
    small = jnp.where(mask, cam_idx, -1)
    i_min = jnp.argmin(big, axis=-1)
    i_max = jnp.argmax(small, axis=-1)
    sel = jnp.stack([i_min, i_max], axis=-1)          # [...,2]
    take = lambda arr: jnp.take_along_axis(
        arr, sel.reshape(sel.shape + (1,) * (arr.ndim - sel.ndim))
        .astype(jnp.int32), axis=sel.ndim - 1)
    P2 = jnp.take_along_axis(P_obs, sel[..., None, None], axis=-3)
    xy2 = jnp.take_along_axis(xy, sel[..., None], axis=-2)
    del take
    m2 = jnp.ones(sel.shape, dtype=bool)
    return triangulate_dlt(P2, xy2, m2)


# ----------------------------------------------------------------------
# Batched Gauss-Newton
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_iters", "epsilon", "accept_mse",
                                   "det_min"))
def gauss_newton_soa(
    P: list,                 # [O][3][4] nested lists of [N] vectors
    ox: list,                # [O] lists of [N] observed x
    oy: list,                # [O] lists of [N] observed y
    mf: list,                # [O] lists of [N] float validity weights
    X0: jnp.ndarray,         # [N, 3]       initial 3D points
    max_iters: int = 30,
    epsilon: float = 5e-7,
    accept_mse: float = 9.0,
    det_min: float = 1e-5,
):
    """Refine all points at once, SoA interface; returns (X, mse, valid).

    Semantics follow em_GaussNewton exactly (triangulation.cpp:105-176):
    per-point early stop when the mse change drops below `epsilon`
    (implemented as a freeze mask — identical fixed-point, fixed cost),
    rejection on near-singular Hessians, acceptance on final
    mse < accept_mse.  `mse` is sum of squared pixel residuals / (2 *
    n_obs).

    Layout: STRUCTURE-OF-ARRAYS.  Plain [N] component vectors instead
    of [N, O, 3, 4] tensors with tiny trailing dims make every
    iteration pure elementwise math over the batch, with no padded
    minor dims and no tiny contractions.  (See p_soa: gathered
    compacted paths also need this form.)  A design choice; its gain
    over the einsum formulation is unmeasured on a GPU.
    """
    # common promotion: under x64 the cameras/observations arrive f64
    # while seeds may still be f32 host arrays — without this the
    # while_loop carry promotes mid-loop and fails to typecheck
    dtype = jnp.result_type(X0.dtype, P[0][0][0].dtype, ox[0].dtype)
    X0 = X0.astype(dtype)
    O = len(P)
    N = X0.shape[0]
    mask_sum = sum(m for m in mf)                                  # [N]
    n_obs = jnp.maximum(mask_sum, 1.0).astype(dtype)

    def proj_o(o, x, y, z):
        p = P[o]
        xH = p[0][0] * x + p[0][1] * y + p[0][2] * z + p[0][3]
        yH = p[1][0] * x + p[1][1] * y + p[1][2] * z + p[1][3]
        zH = p[2][0] * x + p[2][1] * y + p[2][2] * z + p[2][3]
        zH = jnp.where(jnp.abs(zH) < 1e-12,
                       jnp.where(zH < 0, -1e-12, 1e-12), zH)
        return xH, yH, zH

    def cond(carry):
        # EARLY EXIT: stop when every point is frozen (converged) or
        # singular — the freeze mask makes further iterations no-ops, so
        # skipping them is exact, and typical batches converge in well
        # under max_iters sequential steps.
        i, x, y, z, last_mse, frozen, singular = carry
        return (i < max_iters) & ~jnp.all(frozen | singular)

    def body(carry):
        i, x, y, z, last_mse, frozen, singular = carry
        # residuals + Gauss-Newton normal equations, accumulated over
        # observations as unrolled [N]-vector math
        H = [[jnp.zeros(N, dtype) for _ in range(3)] for _ in range(3)]
        g = [jnp.zeros(N, dtype) for _ in range(3)]
        sq = jnp.zeros(N, dtype)
        for o in range(O):
            xH, yH, zH = proj_o(o, x, y, z)
            rx = (ox[o] - xH / zH) * mf[o]
            ry = (oy[o] - yH / zH) * mf[o]
            sq = sq + rx * rx + ry * ry
            inv_z2 = mf[o] / (zH * zH)
            p = P[o]
            Jx = [(p[0][c] * zH - p[2][c] * xH) * inv_z2 for c in range(3)]
            Jy = [(p[1][c] * zH - p[2][c] * yH) * inv_z2 for c in range(3)]
            for a in range(3):
                g[a] = g[a] + Jx[a] * rx + Jy[a] * ry
                for b in range(a, 3):
                    H[a][b] = H[a][b] + Jx[a] * Jx[b] + Jy[a] * Jy[b]
        mse = sq / (2.0 * n_obs)
        conv = jnp.abs(mse - last_mse) < epsilon
        now_frozen = frozen | conv

        h00, h01, h02 = H[0][0], H[0][1], H[0][2]
        h11, h12, h22 = H[1][1], H[1][2], H[2][2]
        # Cramer solve on the symmetric 3x3 (closed form, [N] scalars)
        c00 = h11 * h22 - h12 * h12
        c01 = h02 * h12 - h01 * h22
        c02 = h01 * h12 - h02 * h11
        detH = h00 * c00 + h01 * c01 + h02 * c02
        c11 = h00 * h22 - h02 * h02
        c12 = h01 * h02 - h00 * h12
        c22 = h00 * h11 - h01 * h01
        safe = jnp.where(jnp.abs(detH) < 1e-20,
                         jnp.where(detH < 0, -1e-20, 1e-20), detH)
        dx = (c00 * g[0] + c01 * g[1] + c02 * g[2]) / safe
        dy = (c01 * g[0] + c11 * g[1] + c12 * g[2]) / safe
        dz = (c02 * g[0] + c12 * g[1] + c22 * g[2]) / safe
        # absolute test mirrors the reference (det < 1e-5,
        # triangulation.cpp:97-99); the scale-relative test catches
        # rank-deficient H whose f32 det noise exceeds the absolute
        # threshold (e.g. all observations from one camera).
        h_sq = (h00 * h00 + h11 * h11 + h22 * h22
                + 2.0 * (h01 * h01 + h02 * h02 + h12 * h12))
        h_scale = jnp.sqrt(h_sq / 3.0)
        bad = (jnp.abs(detH) < det_min) | (
            jnp.abs(detH) < 1e-5 * h_scale ** 3)
        step_ok = ~(now_frozen | bad)
        x = jnp.where(step_ok, x + dx, x)
        y = jnp.where(step_ok, y + dy, y)
        z = jnp.where(step_ok, z + dz, z)
        last_new = jnp.where(now_frozen, last_mse, mse)
        singular = singular | (bad & ~now_frozen)
        return i + 1, x, y, z, last_new, now_frozen, singular

    zero = jnp.zeros(N, dtype=dtype)
    frozen0 = jnp.zeros(N, dtype=bool)
    _, x, y, z, last_mse, _, singular = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X0[:, 0], X0[:, 1], X0[:, 2], zero,
                     frozen0, frozen0))
    X = jnp.stack([x, y, z], axis=-1)
    valid = (~singular) & (last_mse < accept_mse) & (mask_sum >= 2)
    return X, last_mse, valid


def gauss_newton_batched(
    P_obs: jnp.ndarray,      # [N, O, 3, 4] per-observation cameras
    xy: jnp.ndarray,         # [N, O, 2]    observed 2D points
    mask: jnp.ndarray,       # [N, O]       valid observations
    X0: jnp.ndarray,         # [N, 3]       initial 3D points
    max_iters: int = 30,
    epsilon: float = 5e-7,
    accept_mse: float = 9.0,
    det_min: float = 1e-5,
):
    """Tensor-interface wrapper over gauss_newton_soa (same semantics,
    docstring there)."""
    dtype = X0.dtype
    N, O = mask.shape
    return gauss_newton_soa(
        p_soa(P_obs),
        [xy[:, o, 0] for o in range(O)],
        [xy[:, o, 1] for o in range(O)],
        [mask[:, o].astype(dtype) for o in range(O)],
        X0, max_iters=max_iters, epsilon=epsilon,
        accept_mse=accept_mse, det_min=det_min)


def estimate_3d_positions(
    P_obs: jnp.ndarray, xy: jnp.ndarray, cam_idx: jnp.ndarray,
    mask: jnp.ndarray, max_iters: int = 30, epsilon: float = 5e-7,
    accept_mse: float = 9.0,
):
    """Full em_estimate3Dpositions parity (triangulation.cpp:178-323):
    widest-pair DLT init, then batched GN over all observations."""
    X0 = triangulate_pair_minmax(P_obs, xy, cam_idx, mask)
    return gauss_newton_batched(P_obs, xy, mask, X0,
                                max_iters=max_iters, epsilon=epsilon,
                                accept_mse=accept_mse)


def reprojection_mse(P_obs, xy, mask, X):
    """Mean squared pixel reprojection error per point, sum r^2/(2N)."""
    mf = mask.astype(X.dtype)
    pr = project(P_obs, X[..., None, :])
    r = (xy - pr) * mf[..., None]
    n = jnp.maximum(jnp.sum(mask, axis=-1), 1).astype(X.dtype)
    return jnp.sum(r * r, axis=(-2, -1)) / (2.0 * n)


def add_observation_to_3d_points(
    P_obs: jnp.ndarray, xy: jnp.ndarray, mask: jnp.ndarray,
    X: jnp.ndarray, new_P: jnp.ndarray, new_xy: jnp.ndarray,
    new_valid: jnp.ndarray | None = None, max_iters: int = 30,
    epsilon: float = 5e-7, accept_mse: float = 9.0,
):
    """Add one observation per point to existing 3D estimates and
    re-refine (parity: em_add_new_observation_to_3Dpositions,
    triangulation.cpp:347-466 — warm-started from the current X rather
    than re-triangulated, then full GN over old + new observations).

    P_obs [N,O,3,4], xy [N,O,2], mask [N,O] — existing observations;
    X [N,3] current estimates; new_P [N,3,4], new_xy [N,2] the added
    observation (new_valid masks points that get no new observation).
    Returns (X', mse, valid, mask') where mask' includes the new
    observation in the first padded slot.
    """
    if new_valid is None:
        new_valid = jnp.ones(X.shape[0], dtype=bool)
    # place the new observation in each point's first free slot
    free = ~mask                                           # [N,O]
    first_free = jnp.argmax(free, axis=-1)                 # [N]
    has_free = jnp.any(free, axis=-1)
    put = new_valid & has_free
    rows = jnp.arange(X.shape[0])
    P2 = P_obs.at[rows, first_free].set(
        jnp.where(put[:, None, None], new_P, P_obs[rows, first_free]))
    xy2 = xy.at[rows, first_free].set(
        jnp.where(put[:, None], new_xy, xy[rows, first_free]))
    mask2 = mask.at[rows, first_free].set(mask[rows, first_free] | put)
    Xr, mse, valid = gauss_newton_batched(
        P2, xy2, mask2, X, max_iters=max_iters, epsilon=epsilon,
        accept_mse=accept_mse)
    return Xr, mse, valid, mask2


def triangulate_view_combinations(
    P_obs: jnp.ndarray, xy: jnp.ndarray, mask: jnp.ndarray,
    min_views: int = 3, max_iters: int = 30, epsilon: float = 5e-7,
    accept_mse: float = 9.0, max_subset_views: int = 12,
):
    """Best-subset triangulation + greedy re-expansion (parity:
    compute_3d_point_coords_combinations, triangulation.cpp:1105-1158).

    Intentional deviation from the reference's enumeration order: the
    reference enumerates subsets of exactly `min_views` size via
    prev_permutation and greedily expands the FIRST accepted one
    (triangulation.cpp:1105-1158); here every subset size is solved at
    once and the winner is chosen lexicographically by (max size, then
    min mse) before the same greedy re-add. On ambiguous inputs the two
    can pick different (point, used-set) pairs; batching all subsets is
    the batched formulation and the larger-first criterion dominates
    the reference's minimal-subset pick in observation count.

    JAX-native: all 2^O subset masks are a static tensor; every subset
    is solved in ONE batched GN (subsets = the batch dimension) and the
    greedy re-add is a static loop of O batched single-observation adds.
    To bound the 2^O blowup, at most `max_subset_views` observations
    (the first valid ones, mirroring the reference's view-id order)
    enter the enumeration; the rest are only considered by the greedy
    re-add phase.

    P_obs [O,3,4], xy [O,2], mask [O] (one point's candidate views).
    Returns (X [3], mse, valid, used_mask [O]).
    """
    O = int(mask.shape[0])
    if O > max_subset_views:
        # keep the first max_subset_views VALID observations for the
        # subset enumeration (stable sort: valid first, id order kept)
        order = jnp.argsort(~mask, stable=True)          # [O]
        sel = order[:max_subset_views]                   # [K]
        X, mse, valid, used_k = triangulate_view_combinations(
            P_obs[sel], xy[sel], mask[sel], min_views=min_views,
            max_iters=max_iters, epsilon=epsilon, accept_mse=accept_mse,
            max_subset_views=max_subset_views)
        used = jnp.zeros(O, dtype=bool).at[sel].set(used_k)
        # greedy re-add of the observations excluded from enumeration
        in_enum = jnp.zeros(O, dtype=bool).at[sel].set(True)
        for o in range(O):
            excluded = mask[o] & ~in_enum[o] & valid
            Xr, mse_r, ok_r, _ = add_observation_to_3d_points(
                P_obs[None], xy[None], used[None], X[None],
                P_obs[None, o], xy[None, o],
                new_valid=excluded[None], max_iters=max_iters,
                epsilon=epsilon, accept_mse=accept_mse)
            accept = excluded & ok_r[0]
            X = jnp.where(accept, Xr[0], X)
            used = used.at[o].set(used[o] | accept)
        mse = reprojection_mse(P_obs[None], xy[None], used[None],
                               X[None])[0]
        return X, mse, valid, used
    # static subset enumeration (skip subsets smaller than min_views)
    bits = np.arange(2 ** O, dtype=np.uint32)
    table = ((bits[:, None] >> np.arange(O)) & 1).astype(bool)   # [S,O]
    table = table[table.sum(axis=1) >= min_views]
    if len(table) == 0:
        z = jnp.zeros(3, P_obs.dtype)
        return z, jnp.asarray(jnp.inf, P_obs.dtype), jnp.asarray(False), \
            jnp.zeros(O, dtype=bool)
    sub = jnp.asarray(table)                                     # [S,O]
    m_sub = sub & mask[None, :]                                  # [S,O]
    enough = jnp.sum(m_sub, axis=-1) >= min_views
    S = sub.shape[0]
    P_b = jnp.broadcast_to(P_obs[None], (S,) + P_obs.shape)
    xy_b = jnp.broadcast_to(xy[None], (S,) + xy.shape)
    cam_b = jnp.broadcast_to(jnp.arange(O, dtype=jnp.int32)[None], (S, O))
    X_s, mse_s, ok_s = estimate_3d_positions(
        P_b, xy_b, cam_b, m_sub, max_iters=max_iters, epsilon=epsilon,
        accept_mse=accept_mse)
    ok_s = ok_s & enough
    size = jnp.sum(m_sub, axis=-1)
    # lexicographic (max size, then min mse) selection in two exact
    # integer/float steps — no composite float score, no tie-break
    # precision loss at large sizes
    max_size = jnp.max(jnp.where(ok_s, size, -1))
    tier = ok_s & (size == max_size)
    best = jnp.argmin(jnp.where(tier, mse_s, jnp.inf))
    any_ok = jnp.any(ok_s)
    X = X_s[best]
    used = m_sub[best] & any_ok
    # greedy re-add of excluded views, in view order (parity :1146-1158)
    for o in range(O):
        excluded = mask[o] & ~used[o] & any_ok
        Xr, mse_r, ok_r, _ = add_observation_to_3d_points(
            P_obs[None], xy[None], used[None], X[None],
            P_obs[None, o], xy[None, o],
            new_valid=excluded[None], max_iters=max_iters,
            epsilon=epsilon, accept_mse=accept_mse)
        accept = excluded & ok_r[0]
        X = jnp.where(accept, Xr[0], X)
        used = used.at[o].set(used[o] | accept)
    mse = reprojection_mse(P_obs[None], xy[None], used[None], X[None])[0]
    return X, mse, any_ok, used
