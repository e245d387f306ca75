"""Micro-profile the pieces of _seed_sweep on the bench workload."""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from edgegraph3d_tpu import runtime

runtime.cli_start()

from functools import partial

from bench import build_workload
from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.matching import detection
from edgegraph3d_tpu.matching import refpoints as rp
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched, \
    triangulate_dlt
from edgegraph3d_tpu.plgs.extraction import extract_plgs

cfg = EdgeGraphConfig().replace(max_polylines_per_view=2048,
                                max_polyline_len=256,
                                max_follow_steps=128)
sfmd, edge_imgs, curves = build_workload(8, 1600, 1200, 48)
stack = extract_plgs(edge_imgs, cfg)
ctx = rp.build_context(sfmd, stack, cfg)
obs_xy, obs_mask = rp.dense_observations(sfmd)
N = 256
ox = jnp.asarray(obs_xy[:N])
om = jnp.asarray(obs_mask[:N])
cum = np.cumsum(obs_mask, axis=1)
sm = jnp.asarray((obs_mask & (cum <= 2))[:N])
M = cfg.max_candidates_per_view
V = obs_mask.shape[1]
print("M =", M, "V =", V)


def t(fn, *a, reps=5, **k):
    out = fn(*a, **k)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return np.median(ts) * 1e3, out


# piece 1: starting intersections
@jax.jit
def starts_only(ox):
    def start_view(v):
        def q(pt):
            return detection.detect_starting_intersections(
                ctx.grids[v], pt, ctx.cell,
                cfg.detection_starting_dist_px, M)
        return jax.vmap(q)(ox[:, v])
    s = jax.lax.map(start_view, jnp.arange(V))
    return jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), s)

ms, starts = t(starts_only, ox)
print(f"starts detection: {ms:.1f} ms")
sv = np.asarray(starts.valid) & np.asarray(sm)[..., None]
print(f"  valid starts: {sv.sum()} / {sv.size} ({sv.mean():.3f})")


# piece 2: epipolar correspondences (dense, as in _seed_sweep)
@jax.jit
def corr_only(starts, ox, om):
    xyh = jnp.concatenate([starts.xy, jnp.ones(starts.xy.shape[:-1] + (1,),
                                               starts.xy.dtype)], axis=-1)
    lines = jnp.einsum("abij,namj->nambi", ctx.F_table, xyh,
                       precision=jax.lax.Precision.HIGHEST)
    ln = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / jnp.maximum(ln, 1e-20)[..., None]
    radius = jnp.minimum(starts.dist * cfg.detection_correspondence_factor,
                         3.0 * cfg.detection_starting_dist_px)
    radius = jnp.maximum(radius, cfg.detection_starting_dist_px * 0.3)

    def corr_view(vo):
        def q(pt, line, rad):
            return detection.detect_epipolar_correspondences(
                ctx.grids[vo], pt, line, ctx.cell,
                rad, M)
        pt = jnp.broadcast_to(ox[:, vo][:, None, None, :], (N, V, M, 2))
        line = lines[:, :, :, vo]
        flat = jax.vmap(q)(pt.reshape(-1, 2), line.reshape(-1, 3),
                           radius.reshape(-1))
        return jax.tree.map(lambda a: a.reshape((N, V, M) + a.shape[1:]),
                            flat)
    corr = jax.lax.map(corr_view, jnp.arange(V))
    return jax.tree.map(lambda a: jnp.moveaxis(a, 0, 3), corr)

ms, corr = t(corr_only, starts, ox, om)
print(f"corr detection (dense N*V*M*V): {ms:.1f} ms")


# piece 3: M^2 triangulation + GN over the dense block
@jax.jit
def tri_only(starts, corr):
    flat_xy = jnp.zeros((N * V * M * M * M, 3, 2), jnp.float32)
    flat_P = jnp.broadcast_to(ctx.P_mats[0], (N * V * M * M * M, 3, 3, 4))
    m3 = jnp.ones(flat_xy.shape[:2], bool)
    X0 = triangulate_dlt(flat_P, flat_xy, m3)
    X, mse, ok = gauss_newton_batched(flat_P, flat_xy, m3, X0,
                                      max_iters=cfg.gn_max_iters,
                                      accept_mse=cfg.match_gn_max_mse,
                                      epsilon=cfg.gn_epsilon)
    return X, ok

ms, _ = t(tri_only, starts, corr)
print(f"DLT+GN dense block ({N*V*M*M*M} solves): {ms:.1f} ms")

ms, out = t(rp._seed_sweep, ctx.plg_coords, ctx.plg_length, ctx.grids,
            ctx.P_mats, ctx.F_table, ctx.cell, ox, om, sm, M, cfg)
print(f"full _seed_sweep: {ms:.1f} ms")
