"""Closed-form small-matrix linear algebra for huge batches.

`jnp.linalg.{det,solve,inv,eigh}` on batched 3x3/4x4 matrices lower to
batched LU/QR factorization loops; every hot path here (per-point
Gauss-Newton Hessians, DLT normal matrices, BA point blocks) is a huge
batch of tiny matrices, which closed-form arithmetic turns into plain
elementwise math over the batch.  A design choice, unmeasured against
the library solvers on a GPU.

Provides: det3, adjugate3, inv3, solve3 (Cramer/adjugate), and
smallest_eigvec4 (shifted power iteration for the homogeneous-DLT
nullspace).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def det3(A: jnp.ndarray) -> jnp.ndarray:
    """Determinant of [...,3,3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (transposed cofactor matrix) of [...,3,3]."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return jnp.stack([
        jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], axis=-1),
        jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], axis=-1),
        jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], axis=-1),
    ], axis=-2)


def inv3(A: jnp.ndarray, det_eps: float = 1e-20) -> jnp.ndarray:
    """Inverse of [...,3,3] via adjugate/det."""
    det = det3(A)
    safe = jnp.where(jnp.abs(det) < det_eps,
                     jnp.where(det < 0, -det_eps, det_eps), det)
    return adjugate3(A) / safe[..., None, None]


def solve3(A: jnp.ndarray, b: jnp.ndarray, det_eps: float = 1e-20):
    """Solve A x = b for [...,3,3] x [...,3] -> ([...,3], det)."""
    det = det3(A)
    safe = jnp.where(jnp.abs(det) < det_eps,
                     jnp.where(det < 0, -det_eps, det_eps), det)
    adj = adjugate3(A)
    x = jnp.einsum("...ij,...j->...i", adj, b) / safe[..., None]
    return x, det


def cholesky4(A: jnp.ndarray, eps: float = 1e-30):
    """Closed-form Cholesky of SPD [...,4,4] -> lower factor entries.

    Elementwise arithmetic; returns the 10 lower-triangular entries."""
    sq = lambda x: jnp.sqrt(jnp.maximum(x, eps))
    a = A
    L11 = sq(a[..., 0, 0])
    L21 = a[..., 1, 0] / L11
    L31 = a[..., 2, 0] / L11
    L41 = a[..., 3, 0] / L11
    L22 = sq(a[..., 1, 1] - L21 * L21)
    L32 = (a[..., 2, 1] - L31 * L21) / L22
    L42 = (a[..., 3, 1] - L41 * L21) / L22
    L33 = sq(a[..., 2, 2] - L31 * L31 - L32 * L32)
    L43 = (a[..., 3, 2] - L41 * L31 - L42 * L32) / L33
    L44 = sq(a[..., 3, 3] - L41 * L41 - L42 * L42 - L43 * L43)
    return (L11, L21, L31, L41, L22, L32, L42, L33, L43, L44)


def cho_solve4(L, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given cholesky4 factors; b [...,4]."""
    L11, L21, L31, L41, L22, L32, L42, L33, L43, L44 = L
    # forward: L y = b
    y1 = b[..., 0] / L11
    y2 = (b[..., 1] - L21 * y1) / L22
    y3 = (b[..., 2] - L31 * y1 - L32 * y2) / L33
    y4 = (b[..., 3] - L41 * y1 - L42 * y2 - L43 * y3) / L44
    # backward: L^T x = y
    x4 = y4 / L44
    x3 = (y3 - L43 * x4) / L33
    x2 = (y2 - L32 * x3 - L42 * x4) / L22
    x1 = (y1 - L21 * x2 - L31 * x3 - L41 * x4) / L11
    return jnp.stack([x1, x2, x3, x4], axis=-1)


def smallest_eigvec4(A: jnp.ndarray, n_iters: int = 4) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of symmetric PSD [...,4,4].

    Inverse iteration with a tiny relative ridge: x <- (A + eps I)^-1 x.
    Convergence ratio (lam_min+eps)/(lam_2+eps) makes 3-4 rounds plenty;
    the solve is a closed-form 4x4 Cholesky — all elementwise math,
    in place of `jnp.linalg.eigh`'s batched QR loops."""
    tr = jnp.trace(A, axis1=-2, axis2=-1)
    eps = (1e-7 * tr + 1e-30)[..., None, None]
    Ar = A + eps * jnp.eye(4, dtype=A.dtype)
    L = cholesky4(Ar)
    v = jnp.full(A.shape[:-1], 1.0, A.dtype)
    v = v.at[..., 3].set(1.5)            # deterministic asymmetric init
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    def body(_, v):
        v = cho_solve4(L, v)
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        return v / jnp.maximum(n, 1e-30)

    return jax.lax.fori_loop(0, n_iters, body, v)
