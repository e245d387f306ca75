"""Joint bundle adjustment over edge-point reprojection residuals.

This is the multi-device generalization of the reference's independent
per-point Gauss-Newton (reference: src/edgegraph3d/filtering/
gauss_newton.cpp:83-178 refines points only, cameras fixed): a joint
Levenberg-Marquardt step over camera poses AND points, solved by
Schur-complement reduction — the BASELINE.json north-star "distributed
BA solved via Schur-complement reduction over collectives (psum of
per-view Hessian blocks)".

Structure per step (standard sparse BA normal equations):

    H = [[Hcc, Hcx], [Hxc, Hxx]]    g = [gc, gx]
    S   = Hcc - sum_i Hcx_i Hxx_i^-1 Hxc_i        (6V x 6V, dense)
    rhs = gc  - sum_i Hcx_i Hxx_i^-1 gx_i
    solve S dc = rhs  ->  dx_i = Hxx_i^-1 (gx_i - Hxc_i dc)

The sum over points i is the only cross-device reduction: with points
sharded over a mesh axis, S and rhs are formed locally and `psum`'d over
the mesh (see parallel/sharded.py); the tiny 6V system is solved replicated,
and point updates stay local.  Camera poses use a left-multiplicative
se(3) perturbation; per-observation Jacobians come from `jax.jacfwd`
(exact, batched by vmap).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class BAState(NamedTuple):
    K: jnp.ndarray        # [V,3,3] intrinsics (fixed)
    R: jnp.ndarray        # [V,3,3] world->cam rotations
    t: jnp.ndarray        # [V,3]
    X: jnp.ndarray        # [N,3] points


def _hat(w):
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([zeros, -w[..., 2], w[..., 1]], axis=-1),
        jnp.stack([w[..., 2], zeros, -w[..., 0]], axis=-1),
        jnp.stack([-w[..., 1], w[..., 0], zeros], axis=-1),
    ], axis=-2)


def exp_so3(w):
    """Rodrigues: [...,3] -> [...,3,3].

    Differentiable at w = 0: the sqrt is guarded with a `where` inside
    (so jacfwd sees no 0-division) and the sin/cos coefficients switch
    to their Taylor series for small angles — BA linearizes exactly at
    w = 0, so this point must have exact, finite derivatives.
    """
    th2 = jnp.sum(w * w, axis=-1)
    small = th2 < 1e-8
    th2_safe = jnp.where(small, 1.0, th2)
    th = jnp.sqrt(th2_safe)
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    B = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / th2_safe)
    W = _hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def _residual_one(K, R, t, dpose, X, xy_obs):
    """Residual of one observation under pose perturbation dpose=(w,u)."""
    w, u = dpose[:3], dpose[3:]
    p = exp_so3(w) @ (R @ X + t) + u
    z = jnp.where(jnp.abs(p[2]) < 1e-9, 1e-9, p[2])
    proj = (K @ (p / z))[:2]
    return xy_obs - proj


def ba_build_blocks(state: BAState, obs_cam: jnp.ndarray,
                    obs_xy: jnp.ndarray, obs_mask: jnp.ndarray):
    """Per-shard normal-equation blocks.

    obs_cam [N,O] int32, obs_xy [N,O,2], obs_mask [N,O].
    Returns (S_local [6V,6V], rhs_local [6V], Hxx [N,3,3], gx [N,3],
    Hxc [N,O,3,6], resid_sq_local scalar) — caller psums the first two
    (and the scalar) across the point-sharded axis.
    """
    V = state.K.shape[0]
    N, O = obs_cam.shape
    dtype = state.X.dtype
    cam = jnp.maximum(obs_cam, 0)
    Ko = state.K[cam]
    Ro = state.R[cam]
    to = state.t[cam]
    Xo = jnp.broadcast_to(state.X[:, None, :], (N, O, 3))
    zero_pose = jnp.zeros((N, O, 6), dtype)

    res_fn = _residual_one
    r = jax.vmap(jax.vmap(res_fn))(Ko, Ro, to, zero_pose, Xo, obs_xy)
    Jc = jax.vmap(jax.vmap(jax.jacfwd(res_fn, argnums=3)))(
        Ko, Ro, to, zero_pose, Xo, obs_xy)            # [N,O,2,6]
    Jx = jax.vmap(jax.vmap(jax.jacfwd(res_fn, argnums=4)))(
        Ko, Ro, to, zero_pose, Xo, obs_xy)            # [N,O,2,3]
    # GN convention: J = -d(residual)/d(param); solve H d = J^T r
    Jc = -Jc * obs_mask[..., None, None]
    Jx = -Jx * obs_mask[..., None, None]
    r = r * obs_mask[..., None]

    Hxx = _einsum("noki,nokj->nij", Jx, Jx)           # [N,3,3]
    gx = _einsum("noki,nok->ni", Jx, r)               # [N,3]
    Hxc = _einsum("noki,nokj->noij", Jx, Jc)          # [N,O,3,6]
    Hcc_o = _einsum("noki,nokj->noij", Jc, Jc)        # [N,O,6,6]
    gc_o = _einsum("noki,nok->noi", Jc, r)            # [N,O,6]

    # scatter per-observation camera blocks into [V,...]
    onehot = jax.nn.one_hot(cam, V, dtype=dtype) * obs_mask[..., None]
    Hcc = _einsum("nov,noij->vij", onehot, Hcc_o)     # [V,6,6]
    gc = _einsum("nov,noi->vi", onehot, gc_o)         # [V,6]
    return r, Hxx, gx, Hxc, Hcc, gc, onehot


def ba_schur_local(state: BAState, obs_cam, obs_xy, obs_mask,
                   damping: float = 1e-4):
    """Local (per-shard) Schur pieces; psum-able."""
    V = state.K.shape[0]
    dtype = state.X.dtype
    r, Hxx, gx, Hxc, Hcc, gc, onehot = ba_build_blocks(
        state, obs_cam, obs_xy, obs_mask)
    eye3 = jnp.eye(3, dtype=dtype)
    # LM-style relative damping + small absolute guard for padding rows
    diag = jnp.diagonal(Hxx, axis1=-2, axis2=-1)
    Hxx_d = Hxx + damping * diag[..., None] * eye3[None] + 1e-8 * eye3[None]
    from edgegraph3d_tpu.ops.linalg3 import inv3
    Hxx_inv = inv3(Hxx_d)

    # W_i = Hcx(Hxx^-1): per point, [O,6,3] blocks; S -= W Hxc.
    # Contract via per-camera intermediates [N,V,6,3] to avoid the
    # [N,O,O,6,6] pair tensor.
    Wt = _einsum("noij,njk->noik",
                 jnp.swapaxes(Hxc, -2, -1), Hxx_inv)  # [N,O,6,3]
    A = _einsum("nov,noik->nvik", onehot, Wt)         # [N,V,6,3]
    B = _einsum("npw,npkj->nwkj", onehot, Hxc)        # [N,V,3,6]
    S_full = -_einsum("nvik,nwkj->vwij", A, B)        # [V,V,6,6]
    S_full = S_full.at[jnp.arange(V), jnp.arange(V)].add(Hcc)
    rhs = gc - _einsum("nov,noik,nk->vi", onehot, Wt, gx)
    resid_sq = jnp.sum(r * r)
    n_obs = jnp.sum(obs_mask)
    return S_full, rhs, Hxx_inv, gx, Hxc, onehot, resid_sq, n_obs


def ba_apply(state: BAState, S_full, rhs, Hxx_inv, gx, Hxc, onehot,
             damping: float = 1e-4, fix_first_camera: bool = True):
    """Solve the (already psum-reduced) camera system and update state."""
    V = state.K.shape[0]
    dtype = state.X.dtype
    # the camera system is tiny (6V x 6V) but ill-conditioned in f32
    # (rotation blocks ~ (f*X)^2 vs translation blocks ~ f^2): Jacobi
    # preconditioning + relative damping keep the solve stable across
    # shard-reduction orderings.
    S = S_full.transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
    rhs_f = rhs.reshape(6 * V)
    diag = jnp.diagonal(S)
    S = S + (damping * diag + 1e-12) * jnp.eye(6 * V, dtype=S.dtype)
    if fix_first_camera:
        # gauge fixing: clamp camera 0 (delta = 0)
        mask = jnp.arange(6 * V) >= 6
        S = jnp.where(mask[:, None] & mask[None, :], S,
                      jnp.eye(6 * V, dtype=S.dtype))
        rhs_f = jnp.where(mask, rhs_f, 0.0)
    precond = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
    S_p = S * precond[:, None] * precond[None, :]
    dc = (jnp.linalg.solve(S_p, rhs_f * precond) * precond)
    dc = dc.astype(dtype).reshape(V, 6)

    # local point updates: dx = Hxx^-1 (gx - Hxc dc_gathered)
    dc_o = _einsum("nov,vj->noj", onehot, dc)          # [N,O,6]
    corr = _einsum("noij,noj->ni", Hxc, dc_o)
    dx = _einsum("nij,nj->ni", Hxx_inv, gx - corr)

    # p' = exp(w)(R X + t) + u  ->  R' = exp(w) R, t' = exp(w) t + u
    w, u = dc[:, :3], dc[:, 3:]
    dR = exp_so3(w)
    R_new = dR @ state.R
    t_new = _einsum("vij,vj->vi", dR, state.t) + u
    return BAState(K=state.K, R=R_new, t=t_new, X=state.X + dx), dc, dx


def ba_step_single(state: BAState, obs_cam, obs_xy, obs_mask,
                   damping: float = 1e-4):
    """One LM step on a single device (no collectives)."""
    S, rhs, Hxx_inv, gx, Hxc, onehot, resid_sq, n_obs = ba_schur_local(
        state, obs_cam, obs_xy, obs_mask, damping)
    new_state, dc, dx = ba_apply(state, S, rhs, Hxx_inv, gx, Hxc, onehot,
                                 damping)
    return new_state, resid_sq / jnp.maximum(n_obs, 1)


@partial(jax.jit, static_argnames=("n_steps",))
def ba_run(state: BAState, obs_cam, obs_xy, obs_mask, n_steps: int,
           damping: float = 1e-4):
    """n_steps LM steps on one device (jit once, scan inside).

    Returns (final state, per-step mse [n_steps] — each the mean
    squared residual AT the linearization point of that step, so
    mses[0] is the pre-BA error)."""
    def body(st, _):
        st2, mse = ba_step_single(st, obs_cam, obs_xy, obs_mask, damping)
        return st2, mse
    return jax.lax.scan(body, state, None, length=n_steps)


def ba_mse(state: BAState, obs_cam, obs_xy, obs_mask):
    """Mean squared pixel residual of the current state."""
    N, O = obs_cam.shape
    cam = jnp.maximum(obs_cam, 0)
    zero = jnp.zeros((N, O, 6), state.X.dtype)
    Xo = jnp.broadcast_to(state.X[:, None, :], (N, O, 3))
    r = jax.vmap(jax.vmap(_residual_one))(
        state.K[cam], state.R[cam], state.t[cam], zero, Xo, obs_xy)
    r = r * obs_mask[..., None]
    return jnp.sum(r * r) / jnp.maximum(jnp.sum(obs_mask), 1)
