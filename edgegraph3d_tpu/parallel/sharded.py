"""Sharded compute paths: distributed BA and sharded matching sweeps.

The distributed Gauss-Newton / bundle-adjustment design (SURVEY.md §2.10
item 3, BASELINE.json north star): 3D points and their observations are
sharded over the mesh's work axis; each device builds its local Schur
pieces; the 6Vx6V camera system and the scalar residual are reduced with
`jax.lax.psum` between devices; the tiny camera solve is replicated; point
updates stay local.  Per-point GN (no camera coupling) needs no
collectives at all — sharding the batch axis is enough.

The reconstruction sweeps (seed formation, bidirectional following,
all-view expansion) are the JAX-native replacement of the reference's
OpenMP loop over refpoints (reference:
plg_matching_from_refpoints.cpp:89-95): the work-item axis (refpoints /
seeds / 3D points) is sharded over the mesh, PLG tensors and grids are
replicated, and there is NO cross-device traffic inside a sweep — each
device's early-exit `while_loop` terminates independently.  Claim /
dedup merging (the reference's single `omp_lock`) happens on host
between chunked sweeps in deterministic seed order.

Every wrapper builds its `shard_map` ONCE per (mesh, static params) and
wraps it in `jax.jit` (module-level cache): a bare shard_map called
eagerly re-traces and re-lowers on EVERY chunk call, which round-2's
scaling probe measured as a ~20x per-dispatch tax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from edgegraph3d_tpu.ops import ba as ba_ops
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched
from edgegraph3d_tpu.parallel.mesh import SHARD_AXIS

def _cached(mesh, key, build):
    """Per-mesh cache of jitted shard_maps, stored ON the mesh object.

    The jitted values close over the mesh, so any module-level table
    holding them keeps the mesh alive — round 4's WeakKeyDictionary
    never collected an entry because its own values referenced their
    keys (the documented value->key pitfall; JAX also interns Mesh
    objects, so "same" meshes share one identity).  Attaching the dict
    to the mesh instead makes mesh -> dict -> fn -> mesh a pure
    reference cycle with no external root: the cyclic GC frees the
    whole group (mesh, cache, compiled executables) as soon as the
    caller drops the mesh.  Interning is a feature here: rebuilding an
    identical Mesh reuses the cached executables."""
    per = mesh.__dict__.setdefault("_eg3d_fn_cache", {})
    fn = per.get(key)
    if fn is None:
        fn = jax.jit(build())
        per[key] = fn
    return fn


def distributed_ba_step(mesh, state: ba_ops.BAState, obs_cam, obs_xy,
                        obs_mask, damping: float = 1e-4):
    """One joint LM step with points sharded over the mesh.

    state.X / obs_* are sharded on axis 0; cameras are replicated.
    Returns (new_state with sharded X, mean squared residual).
    """

    def build():
        def local(X, obs_cam, obs_xy, obs_mask, K, R, t):
            st = ba_ops.BAState(K=K, R=R, t=t, X=X)
            S, rhs, Hxx_inv, gx, Hxc, onehot, resid_sq, n_obs = \
                ba_ops.ba_schur_local(st, obs_cam, obs_xy, obs_mask,
                                      damping)
            # the only cross-device communication: psum of the per-view
            # Hessian blocks, rhs, and residual stats
            S = jax.lax.psum(S, SHARD_AXIS)
            rhs = jax.lax.psum(rhs, SHARD_AXIS)
            resid_sq = jax.lax.psum(resid_sq, SHARD_AXIS)
            n_obs = jax.lax.psum(n_obs, SHARD_AXIS)
            new_state, dc, dx = ba_ops.ba_apply(
                st, S, rhs, Hxx_inv, gx, Hxc, onehot, damping)
            return (new_state.R, new_state.t, new_state.X,
                    resid_sq / jnp.maximum(n_obs, 1))

        sh = P(SHARD_AXIS)
        rep = P()
        return shard_map(local, mesh=mesh,
                         in_specs=(sh, sh, sh, sh, rep, rep, rep),
                         out_specs=(rep, rep, sh, rep),
                         check_vma=False)

    fn = _cached(mesh, ("ba_step", float(damping)), build)
    R, t, X, mse = fn(state.X, obs_cam, obs_xy, obs_mask,
                      state.K, state.R, state.t)
    return ba_ops.BAState(K=state.K, R=R, t=t, X=X), mse


def distributed_ba(mesh, state, obs_cam, obs_xy, obs_mask,
                   n_steps: int = 10, damping: float = 1e-4):
    """n_steps of distributed LM (jit once, scan inside)."""

    def build():
        def run(state, obs_cam, obs_xy, obs_mask):
            def body(st, _):
                st2, mse = distributed_ba_step(mesh, st, obs_cam, obs_xy,
                                               obs_mask, damping)
                return st2, mse
            return jax.lax.scan(body, state, None, length=n_steps)
        return run

    fn = _cached(mesh, ("ba", n_steps, float(damping)), build)
    return fn(state, obs_cam, obs_xy, obs_mask)


def sharded_gauss_newton(mesh, P_obs, xy, mask, X0, **kw):
    """Per-point GN with the point axis sharded (no collectives)."""

    def build():
        sh = P(SHARD_AXIS)

        def local(P_obs, xy, mask, X0):
            return gauss_newton_batched(P_obs, xy, mask, X0, **kw)

        return shard_map(local, mesh=mesh, in_specs=(sh, sh, sh, sh),
                         out_specs=(sh, sh, sh), check_vma=False)

    fn = _cached(mesh, ("gn", tuple(sorted(kw.items()))), build)
    return fn(P_obs, xy, mask, X0)


# ----------------------------------------------------------------------
# Sharded reconstruction sweeps (refpoints / seeds / points over devices)
# ----------------------------------------------------------------------

def sharded_start_sweep(mesh, plg_coords, grids, cell, obs_xy,
                        start_mask, starting_dist: float, M: int,
                        cap_dev: int):
    """Compacted kernel A with the refpoint axis sharded over the mesh.

    JAX-native replacement of `#pragma omp for` over refpoints
    (reference: plg_matching_from_refpoints.cpp:89-95): each device
    detects + stream-compacts starting intersections for its contiguous
    refpoint block (cap_dev slots per device) against replicated
    PLG/grid tensors; no collectives.  Returns (buf [D*cap_dev, 8],
    n [D]) in device-block order = global refpoint order."""
    from edgegraph3d_tpu.matching import refpoints as refpoints_mod

    def build():
        sh = P(SHARD_AXIS)
        rep = P()

        def local(obs_xy, start_mask, plg_coords, grids):
            buf, n = refpoints_mod._start_sweep(
                plg_coords, grids, cell, obs_xy, start_mask,
                starting_dist, M, cap_dev)
            return buf, n[None]

        return shard_map(local, mesh=mesh, in_specs=(sh, sh, rep, rep),
                         out_specs=(sh, sh), check_vma=False)

    fn = _cached(mesh, ("start", float(cell), float(starting_dist), M,
                  cap_dev), build)
    return fn(obs_xy, start_mask, plg_coords, grids)


def sharded_seed_from_starts(mesh, plg_coords, plg_length, grids, P_mats,
                             F_table, cell, starts_buf, n_starts, obs_xy,
                             obs_mask, M: int, cfg, cap_dev: int):
    """Compacted kernel B sharded: correspondences + 3-view seeding on
    each device's compacted start block (which stays device-local
    between the two kernels — no host round trip).  The emitted
    refpoint-row column is LOCAL to the device block; the caller adds
    the block offset.  Returns (buf [D*cap_dev, 22], n [D])."""
    from edgegraph3d_tpu.matching import refpoints as refpoints_mod

    def build():
        sh = P(SHARD_AXIS)
        rep = P()

        def local(starts_buf, n_starts, obs_xy, obs_mask, plg_coords,
                  plg_length, grids, P_mats, F_table):
            buf, n = refpoints_mod._seed_from_starts(
                plg_coords, plg_length, grids, P_mats, F_table, cell,
                starts_buf, n_starts[0], obs_xy, obs_mask, M, cfg,
                cap_dev)
            return buf, n[None]

        return shard_map(local, mesh=mesh,
                         in_specs=(sh, sh, sh, sh, rep, rep, rep, rep,
                                   rep),
                         out_specs=(sh, sh), check_vma=False)

    fn = _cached(mesh, ("seed", float(cell), M, cfg, cap_dev), build)
    return fn(starts_buf, n_starts, obs_xy, obs_mask, plg_coords,
              plg_length, grids, P_mats, F_table)


def sharded_follow_bidirectional(mesh, seeds, plg_coords, plg_length,
                                 P_mats, F_table, cfg, max_steps: int,
                                 gn_cap: int | None = None):
    """Bidirectional chain following with the seed axis sharded.

    Each device sweeps its slice with its own early-exit `while_loop`
    (devices terminate independently — no synchronization inside the
    walk), replacing the reference's sequential per-seed recursion
    (plg_matching.cpp:765-795).  `gn_cap` is the PER-DEVICE compacted
    post-walk GN width (following.follow_seeds); the per-device
    gn_overflow scalars replicate to the caller via the sharded output.
    """
    from edgegraph3d_tpu.matching import following

    def build():
        sh = P(SHARD_AXIS)
        rep = P()

        def local(seeds, plg_coords, plg_length, P_mats, F_table):
            # gn_overflow is [1] per device -> the sharded output
            # concatenates to [D]; callers read .max()
            return following.follow_seeds_bidirectional(
                seeds, plg_coords, plg_length, P_mats, F_table, cfg,
                max_steps, gn_cap=gn_cap)

        return shard_map(local, mesh=mesh,
                         in_specs=(sh, rep, rep, rep, rep),
                         out_specs=sh, check_vma=False)

    fn = _cached(mesh, ("followb", cfg, max_steps, gn_cap), build)
    return fn(seeds, plg_coords, plg_length, P_mats, F_table)


def sharded_follow_fixed(mesh, seeds, plg_coords, plg_length, P_mats,
                         F_table, cfg, max_steps: int, perm, dirs,
                         gn_cap: int | None = None):
    """Direction-pinned continuation sweep with the seed axis sharded
    (chains that hit max_steps resume from their final position)."""
    from edgegraph3d_tpu.matching import following

    def build():
        sh = P(SHARD_AXIS)
        rep = P()

        def local(seeds, perm, dirs, plg_coords, plg_length, P_mats,
                  F_table):
            return following.follow_seeds(
                seeds, plg_coords, plg_length, P_mats, F_table,
                jnp.int32(1), cfg, max_steps, fixed_perm=perm,
                fixed_dirs=dirs, gn_cap=gn_cap)

        return shard_map(local, mesh=mesh,
                         in_specs=(sh, sh, sh, rep, rep, rep, rep),
                         out_specs=sh, check_vma=False)

    fn = _cached(mesh, ("followf", cfg, max_steps, gn_cap), build)
    return fn(seeds, perm, dirs, plg_coords, plg_length, P_mats, F_table)


def sharded_expand_compact(mesh, plg_coords, grids, P_mats, F_table,
                           cell, X, obs3, cams3, chain_idx, t_idx,
                           item_ok, chain_valid, cfg, C_dev: int, T: int):
    """Compacted chain-aware expansion with CHAINS partitioned over
    devices (all points of a chain stay on one device — the continuity
    run test is chain-local).  Flat item tensors are device-major
    [D*K_dev, ...], chain tensors [D*C_dev, ...]; `chain_idx` is LOCAL
    to each device block (padding rows index out of bounds).  Each
    device expands its slice against replicated PLG tensors — no
    collectives.  Returns (X' [D*K_dev,3], out_xy, out_ok, mse)."""
    from edgegraph3d_tpu.matching import expansion

    def build():
        sh = P(SHARD_AXIS)
        rep = P()

        def local(X, obs3, cams3, chain_idx, t_idx, item_ok, chain_valid,
                  plg_coords, grids, P_mats, F_table):
            return expansion.expand_chains_compact(
                plg_coords, grids, P_mats, F_table, cell, X, obs3, cams3,
                chain_idx, t_idx, item_ok, chain_valid, cfg, C_dev, T)

        return shard_map(local, mesh=mesh,
                         in_specs=(sh, sh, sh, sh, sh, sh, sh, rep, rep,
                                   rep, rep),
                         out_specs=(sh, sh, sh, sh), check_vma=False)

    fn = _cached(mesh, ("expand", float(cell), cfg, C_dev, T), build)
    return fn(X, obs3, cams3, chain_idx, t_idx, item_ok, chain_valid,
              plg_coords, grids, P_mats, F_table)
