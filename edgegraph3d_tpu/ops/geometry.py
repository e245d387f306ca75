"""Batched multi-view geometry kernels (projection, F-matrices, epipolar).

JAX-native replacement for the reference's OpenCV-based geometry layer
(reference: src/edgegraph3d/utils/geometry/geometric_utilities.cpp):
  * projection / reprojection            — dense einsums
  * fundamental matrices                 — exact from cameras (closed form)
                                           and normalized-8-point + LMedS
                                           (parity: geometric_utilities.cpp:683-710
                                            from R,t; :750-781 FM_LMEDS from points)
  * epipolar lines                       — l' = F x, cv-style a^2+b^2=1 norm
                                           (parity: computeCorrespondEpilineSinglePoint
                                            geometric_utilities.cpp:824-843)

Everything is shape-polymorphic over leading batch dims and dtype-
polymorphic (f32 in production, f64 for CPU parity tests).  Invalid results are
flagged with boolean masks instead of the reference's 1x1 "invalid Mat"
sentinel (geometric_utilities.cpp:780).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Tiny 3x3/3x4 contractions: force true-f32 accumulation.  At default
# precision an f32 contraction may run on a reduced-precision path (TF32
# on NVIDIA tensor cores), ~1e-3 relative error — unacceptable for
# pixel-accurate geometry.  These contractions are tiny elementwise
# work anyway; batch is the parallel axis.
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


# ----------------------------------------------------------------------
# Projection
# ----------------------------------------------------------------------

def project(P: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Project world points through P = K[R|t].

    P: [..., 3, 4], X: [..., 3] -> [..., 2] (broadcasting leading dims).
    """
    Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)
    proj = _einsum("...ij,...j->...i", P, Xh)
    z = proj[..., 2:3]
    z = jnp.where(jnp.abs(z) < 1e-12, jnp.where(z < 0, -1e-12, 1e-12), z)
    return proj[..., :2] / z


def project_depth(P: jnp.ndarray, X: jnp.ndarray):
    """Like `project` but also returns the projective depth z."""
    Xh = jnp.concatenate([X, jnp.ones_like(X[..., :1])], axis=-1)
    proj = _einsum("...ij,...j->...i", P, Xh)
    z = proj[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-12, jnp.where(z < 0, -1e-12, 1e-12), z)
    return proj[..., :2] / zs[..., None], z


# ----------------------------------------------------------------------
# Fundamental matrices
# ----------------------------------------------------------------------

def _cross_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """[...,3] -> [...,3,3] skew-symmetric cross-product matrix."""
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
    ], axis=-2)


def fundamental_from_cameras(P1: jnp.ndarray, P2: jnp.ndarray,
                             C1: jnp.ndarray) -> jnp.ndarray:
    """Exact F mapping view-1 points to view-2 epipolar lines.

    F = [e2]_x P2 P1^+ with e2 = P2 [C1;1].  Equivalent to the
    reference's from-(K,R,t) path (geometric_utilities.cpp:683-710) but
    computed directly from projection matrices; exact when cameras are
    known, unlike the estimated FM_LMEDS path.
    P1,P2: [...,3,4], C1: [...,3] camera-1 center.
    """
    C1h = jnp.concatenate([C1, jnp.ones_like(C1[..., :1])], axis=-1)
    e2 = _einsum("...ij,...j->...i", P2, C1h)
    P1pinv = jnp.linalg.pinv(P1)
    F = _cross_matrix(e2) @ P2 @ P1pinv
    # scale-normalize for numerical stability
    scale = jnp.linalg.norm(F, axis=(-2, -1), keepdims=True)
    return F / jnp.where(scale < 1e-20, 1.0, scale)


@jax.jit
def all_fundamental_matrices(P: jnp.ndarray, centers: jnp.ndarray) -> jnp.ndarray:
    """All-pairs F table [C,C,3,3]; F[i,j] maps view-i points to view-j
    lines (parity: generate_all_fundamental_matrices,
    geometric_utilities.cpp:818-820)."""
    n = P.shape[0]
    Pi = jnp.broadcast_to(P[:, None], (n, n, 3, 4))
    Pj = jnp.broadcast_to(P[None, :], (n, n, 3, 4))
    Ci = jnp.broadcast_to(centers[:, None], (n, n, 3))
    return fundamental_from_cameras(Pi, Pj, Ci)


def _normalize_points(x: jnp.ndarray, mask: jnp.ndarray):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    w = mask.astype(x.dtype)[..., None]
    n = jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    mean = jnp.sum(x * w, axis=-2, keepdims=True) / n[..., None, :]
    d = jnp.sqrt(jnp.sum((x - mean) ** 2, axis=-1, keepdims=True))
    mean_d = jnp.sum(d * w, axis=-2) / n
    s = jnp.sqrt(jnp.asarray(2.0, x.dtype)) / jnp.maximum(mean_d[..., 0], 1e-12)
    xn = (x - mean) * s[..., None, None]
    # T: [...,3,3] such that xn_h = T x_h
    zeros = jnp.zeros_like(s)
    ones = jnp.ones_like(s)
    T = jnp.stack([
        jnp.stack([s, zeros, -s * mean[..., 0, 0]], axis=-1),
        jnp.stack([zeros, s, -s * mean[..., 0, 1]], axis=-1),
        jnp.stack([zeros, zeros, ones], axis=-1),
    ], axis=-2)
    return xn, T


def fundamental_8point(x1: jnp.ndarray, x2: jnp.ndarray,
                       mask: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Normalized 8-point algorithm on masked correspondences.

    x1, x2: [..., N, 2]; mask: [..., N].  Returns (F [...,3,3], valid).
    F maps x1-points to x2-lines: x2h^T F x1h = 0.
    """
    dtype = x1.dtype
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    ones = jnp.ones_like(u1)
    # row per correspondence of A f = 0 with F flattened row-major
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, ones], axis=-1)
    A = A * mask.astype(dtype)[..., None]
    AtA = _einsum("...ni,...nj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    f = vecs[..., :, 0]                       # smallest eigenvalue
    F = f.reshape(f.shape[:-1] + (3, 3))
    # enforce rank 2
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    F = U @ (S[..., :, None] * Vt)
    # denormalize: F = T2^T F T1
    F = jnp.swapaxes(T2, -2, -1) @ F @ T1
    scale = jnp.linalg.norm(F, axis=(-2, -1), keepdims=True)
    F = F / jnp.where(scale < 1e-20, 1.0, scale)
    valid = jnp.sum(mask, axis=-1) >= 8
    return F, valid


def _sampson_sq(F, x1, x2):
    """Squared Sampson distance per correspondence [..., N]."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Fx1 = _einsum("...ij,...nj->...ni", F, x1h)
    Ftx2 = _einsum("...ji,...nj->...ni", F, x2h)
    num = _einsum("...ni,...ni->...n", x2h, Fx1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / jnp.maximum(den, 1e-20)


def fundamental_lmeds(x1: jnp.ndarray, x2: jnp.ndarray, mask: jnp.ndarray,
                      key: jax.Array, n_subsets: int = 64,
                      min_points: int = 10):
    """LMedS-style robust F (parity: cv::findFundamentalMat(FM_LMEDS)
    used at geometric_utilities.cpp:754).

    Draws `n_subsets` random 8-point subsets, fits each, scores by the
    median squared Sampson distance over the masked correspondences,
    keeps the best, then refits on inliers within 2.5*sigma of the
    robust scale.  Fully batched; fixed key -> deterministic.
    Returns (F, valid); valid requires >= `min_points` correspondences
    (parity: >= 10 common points, geometric_utilities.cpp:750-781).
    """
    dtype = x1.dtype
    N = x1.shape[-2]
    n_pts = jnp.sum(mask, axis=-1)

    # random subsets: sample indices proportional to mask
    logits = jnp.where(mask, 0.0, -1e9).astype(jnp.float32)
    def draw(k):
        return jax.random.categorical(
            k, logits, axis=-1, shape=(8,) + logits.shape[:-1]
        )  # [8, ...batch]
    keys = jax.random.split(key, n_subsets)
    subs = jax.vmap(draw)(keys)                   # [S, 8, ...batch]

    def fit_one(sub_idx):
        # gather an 8-subset along the N axis
        take = lambda arr: jnp.take_along_axis(
            arr, jnp.moveaxis(sub_idx, 0, -1)[..., None], axis=-2)
        s1, s2 = take(x1), take(x2)
        m8 = jnp.ones(s1.shape[:-1], dtype=bool)
        F, _ = fundamental_8point(s1, s2, m8)
        d2 = _sampson_sq(F, x1, x2)
        d2 = jnp.where(mask, d2, jnp.inf)
        med = _masked_median(d2, mask)
        return F, med

    Fs, meds = jax.vmap(fit_one)(subs)            # [S,...,3,3], [S,...]
    best = jnp.argmin(meds, axis=0)
    F_best = jnp.take_along_axis(
        Fs, best[None, ..., None, None], axis=0)[0]
    med_best = jnp.take_along_axis(meds, best[None], axis=0)[0]

    # robust scale (as in LMedS): sigma = 1.4826 (1 + 5/(n-8)) sqrt(med)
    sigma = 1.4826 * (1.0 + 5.0 / jnp.maximum(n_pts - 8, 1)) * jnp.sqrt(med_best)
    d2 = _sampson_sq(F_best, x1, x2)
    inl = mask & (d2 <= (2.5 * sigma[..., None]) ** 2)
    F_ref, ok8 = fundamental_8point(x1, x2, inl)
    use_refit = ok8 & jnp.isfinite(med_best)
    F_out = jnp.where(use_refit[..., None, None], F_ref, F_best).astype(dtype)
    valid = n_pts >= min_points
    return F_out, valid


def _masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over masked entries along the last axis."""
    big = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(big, axis=-1)
    n = jnp.sum(mask, axis=-1)
    hi = jnp.clip((n - 1) // 2 + (n % 2 == 0).astype(n.dtype), 0, x.shape[-1] - 1)
    lo = jnp.clip((n - 1) // 2, 0, x.shape[-1] - 1)
    vlo = jnp.take_along_axis(s, lo[..., None], axis=-1)[..., 0]
    vhi = jnp.take_along_axis(s, hi[..., None], axis=-1)[..., 0]
    return 0.5 * (vlo + vhi)


# ----------------------------------------------------------------------
# Epipolar lines
# ----------------------------------------------------------------------

def epipolar_line(F: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Epipolar line l' = F [x;1], normalized so a^2 + b^2 = 1
    (cv::computeCorrespondEpilines convention; parity:
    geometric_utilities.cpp:824-843).  F: [...,3,3], x: [...,2] -> [...,3]."""
    xh = jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)
    l = _einsum("...ij,...j->...i", F, xh)
    n = jnp.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    return l / jnp.maximum(n, 1e-20)[..., None]


def point_line_distance(line: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Signed distance of 2D points to a*x+b*y+c=0 lines with a^2+b^2=1."""
    return (line[..., 0] * x[..., 0] + line[..., 1] * x[..., 1]
            + line[..., 2])
