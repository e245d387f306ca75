"""PLG following: sweeping 3D edge chains from seed matches.

JAX-native redesign of the reference's recursive chain following
(reference: src/edgegraph3d/matching/plg_matching/plg_matching.cpp):

  * one step = advance 10 px on the driving view, intersect the epipolar
    lines on the other tuple views within [5, 20] px of their current
    points, triangulate + Gauss-Newton, accept at MSE < 9
    (parity: compatible(), :633-759; follow distances plg_matching.hpp:39-41)
  * direction resolution tries all 4 (other-view direction) combos and
    keeps the first that yields a valid first step
    (parity: follow_plgs_from_match3/4 combo testing, :142-203)
  * the unbounded `while(compatible(...))` walk (:765-795) becomes a
    `lax.scan` with `max_steps` and an active mask; termination flags
    mirror the reference's (extreme reached, quasi-parallel, bounded
    distance violated, triangulation failed)

Everything is batched over seeds: a follow sweep processes [S] seeds x
3 tuple views at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from edgegraph3d_tpu.ops import polyline_ops as po
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched, \
    gauss_newton_soa, triangulate_dlt, triangulate_dlt_soa


class SeedTuple(NamedTuple):
    """A validated 3-view seed (all arrays batched over seeds [S])."""
    cams: jnp.ndarray      # [S,3] int32 camera ids (0 = driving view)
    pl_id: jnp.ndarray     # [S,3] int32 polyline ids
    seg: jnp.ndarray       # [S,3] int32
    t: jnp.ndarray         # [S,3]
    xy: jnp.ndarray        # [S,3,2]
    X: jnp.ndarray         # [S,3] seed 3D point
    valid: jnp.ndarray     # [S]


class FollowResult(NamedTuple):
    X: jnp.ndarray         # [S,T,3] swept 3D points
    obs_xy: jnp.ndarray    # [S,T,3,2] per-tuple-view 2D points
    valid: jnp.ndarray     # [S,T]
    n_steps: jnp.ndarray   # [S] accepted steps
    final_seg: jnp.ndarray  # [S,3] last accepted position (original order)
    final_t: jnp.ndarray    # [S,3]
    perm: jnp.ndarray       # [S,3] chosen tuple permutation (driving=0)
    dirs: jnp.ndarray       # [S,3] walk directions in PERMUTED order
    gn_overflow: jnp.ndarray  # [1] ([D] when mesh-sharded): walk rows
    #                           beyond the compacted-GN cap (0 in normal
    #                           operation; >0 => chains were prefix-cut
    #                           at the cap, caller must redo at full
    #                           width — counted, never silent)


def _triangulate_tuple(P_cams: jnp.ndarray, xy: jnp.ndarray,
                       accept_mse: float, gn_iters: int,
                       X_prev: jnp.ndarray | None = None,
                       epsilon: float = 5e-7):
    """P_cams [S,3,3,4], xy [S,3,2] -> (X [S,3], ok [S]).

    With `X_prev` (the previous chain point, ~10 px of image motion
    away) GN is warm-started and the DLT init is skipped — same fixed
    point, far fewer sequential iterations per following step."""
    mask = jnp.ones(xy.shape[:2], dtype=bool)
    X0 = triangulate_dlt(P_cams, xy, mask) if X_prev is None else X_prev
    X, mse, ok = gauss_newton_batched(P_cams, xy, mask, X0,
                                      max_iters=gn_iters,
                                      accept_mse=accept_mse,
                                      epsilon=epsilon)
    return X, ok


def _walk_step(px, py, lengths, plp_seg, plp_t, plp_xy, dirs,
               F_pairs, cfg):
    """One WALK step (no triangulation) for all seeds: advance the
    driving view, intersect epipolar lines on the other two.

    The walk recurrence does not depend on triangulation results —
    the reference's per-step GN (compatible(), plg_matching.cpp:633-759)
    only decides TERMINATION, so it is hoisted out of the sequential
    loop and batched over every recorded step afterwards (follow_seeds).
    px/py are [S,3,L] packed-layout coordinate blocks (see follow_seeds).
    Returns (new_seg, new_t, new_xy, walk_ok)."""
    S = px.shape[0]
    # 1. advance the driving view by the follow distance
    adv = jax.vmap(po.advance_by_distance_xy,
                   in_axes=(0, 0, 0, 0, 0, None))(
        px[:, 0], py[:, 0], lengths[:, 0],
        po.PLPoint(seg=plp_seg[:, 0], t=plp_t[:, 0], xy=plp_xy[:, 0]),
        dirs[:, 0], cfg.follow_first_image_dist_px)
    drive_ok = adv.found

    # 2. epipolar lines of the new driving point into the other views
    xh = jnp.concatenate([adv.plp.xy, jnp.ones((S, 1), px.dtype)], axis=1)
    lines = jnp.einsum("skij,sj->ski", F_pairs, xh,
                       precision=jax.lax.Precision.HIGHEST)
    ln = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / jnp.maximum(ln, 1e-20)[..., None]

    # 3. bounded epipolar intersection on BOTH other views in one
    # batched call (halves kernel count inside the hot loop)
    ot = jax.vmap(po.next_intersection_bounded_xy,
                  in_axes=(0, 0, 0, 0, 0, 0, None, None, None, None))(
        px[:, 1:].reshape((2 * S,) + px.shape[2:]),
        py[:, 1:].reshape((2 * S,) + py.shape[2:]),
        lengths[:, 1:].reshape(-1),
        po.PLPoint(seg=plp_seg[:, 1:].reshape(-1),
                   t=plp_t[:, 1:].reshape(-1),
                   xy=plp_xy[:, 1:].reshape(-1, 2)),
        dirs[:, 1:].reshape(-1), lines.reshape(-1, 3),
        cfg.follow_min_dist_px, cfg.follow_max_dist_px,
        cfg.quasiparallel_cos, cfg.quasiparallel_dist_px)
    o_seg = ot.plp.seg.reshape(S, 2)
    o_t = ot.plp.t.reshape(S, 2)
    o_xy = ot.plp.xy.reshape(S, 2, 2)
    o_found = ot.found.reshape(S, 2)

    new_xy = jnp.concatenate([adv.plp.xy[:, None], o_xy], axis=1)
    new_seg = jnp.concatenate([adv.plp.seg[:, None], o_seg], axis=1)
    new_t = jnp.concatenate([adv.plp.t[:, None], o_t], axis=1)
    ok = drive_ok & o_found[:, 0] & o_found[:, 1]
    return new_seg, new_t, new_xy, ok


def _one_step(px, py, lengths, plp_seg, plp_t, plp_xy, dirs,
              P_cams, F_pairs, cfg, X_prev=None):
    """One full following step (walk + triangulation) — used by the
    direction resolve, where a single step's GN validity picks the
    configuration.  Returns (new_seg, new_t, new_xy, X, ok)."""
    new_seg, new_t, new_xy, walk_ok = _walk_step(
        px, py, lengths, plp_seg, plp_t, plp_xy, dirs, F_pairs, cfg)
    gn_iters = cfg.follow_gn_iters if X_prev is not None else cfg.gn_max_iters
    X, tri_ok = _triangulate_tuple(P_cams, new_xy, cfg.match_gn_max_mse,
                                   gn_iters, X_prev, cfg.gn_epsilon)
    ok = walk_ok & tri_ok
    return new_seg, new_t, new_xy, X, ok


_PERMS = jnp.asarray([[0, 1, 2], [1, 0, 2], [2, 0, 1]], dtype=jnp.int32)
_COMBOS = jnp.asarray([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=jnp.int32)


def _permute_tuple(arrs, perm):
    """Reorder the 3-view axis (axis=1) of each array by perm [S,3]."""
    def p(a):
        idx = perm.reshape(perm.shape + (1,) * (a.ndim - 2))
        return jnp.take_along_axis(a, idx, axis=1)
    return [p(a) for a in arrs]


def resolve_configuration(seeds: SeedTuple, packed, plg_length,
                          P_mats, F_table, drive_dir, cfg):
    """Pick (driving view, other-view directions): try all 3 driving
    roles x 4 direction combos, keep the first whose first step is valid.

    Parity: the reference tries 4 direction combos
    (follow_plgs_from_match3/4, plg_matching.cpp:142-203) and retries
    with a different first view on parallel-epipolar failure (:375-450);
    here both fallbacks are one batched 12-config test.
    `packed` is the flat [V*P, 2L] coordinate layout (see follow_seeds).
    Returns (perm [S,3], dirs [S,3], ok [S]).
    """
    S = seeds.cams.shape[0]
    P_cnt = plg_length.shape[1]
    L = packed.shape[1] // 2

    def try_cfg(carry, dperm_combo):
        d, c1, c2 = dperm_combo
        perm = jnp.broadcast_to(_PERMS[d], (S, 3))
        cams, seg, t, xyv = _permute_tuple(
            [seeds.cams, seeds.seg[..., None], seeds.t[..., None],
             seeds.xy], perm)
        seg = seg[..., 0]
        t = t[..., 0]
        pl = _permute_tuple([seeds.pl_id[..., None]], perm)[0][..., 0]
        rows = packed[cams * P_cnt + pl]                  # [S,3,2L]
        px, py = rows[..., :L], rows[..., L:]
        lengths = plg_length[cams, pl]
        P_cams = P_mats[cams]
        F_pairs = F_table[cams[:, 0:1], cams[:, 1:]]
        dirs = jnp.stack([jnp.broadcast_to(drive_dir, (S,)).astype(jnp.int32),
                          jnp.full((S,), c1, jnp.int32),
                          jnp.full((S,), c2, jnp.int32)], axis=1)
        _, _, _, _, ok = _one_step(px, py, lengths, seg, t, xyv, dirs,
                                   P_cams, F_pairs, cfg, X_prev=seeds.X)
        return carry, ok

    configs = jnp.asarray([(d, int(c[0]), int(c[1]))
                           for d in range(3) for c in np.asarray(_COMBOS)],
                          dtype=jnp.int32)
    oks = jax.vmap(lambda c: try_cfg(None, c)[1])(configs)   # [12,S]
    any_ok = jnp.any(oks, axis=0)
    first = jnp.argmax(oks, axis=0)                    # [S]
    chosen = configs[first]                            # [S,3]
    perm = _PERMS[chosen[:, 0]]
    dirs = jnp.stack([jnp.broadcast_to(drive_dir, (S,)).astype(jnp.int32),
                      chosen[:, 1], chosen[:, 2]], axis=1)
    return perm, dirs, any_ok


def _default_gn_cap(S: int, T: int) -> int:
    """Static width of the compacted post-walk GN buffer.

    Full-scale measurement: the recorded-step grid is [S, T] = millions
    of slots of which well under 1% hold a live walk row (most chains
    die in a few steps), yet round 4 ran DLT + 30 GN iterations over
    every slot — the single largest slice of the stage-3 wall.  8 rows
    per seed lane (min 4096) is ~30x the observed fill; an overflowing
    chunk is detected (gn_overflow) and redone at full width by the
    callers, so the cap is a fast path, never a silent truncation."""
    return min(S * T, max(4096, 8 * S))


@partial(jax.jit, static_argnames=("cfg", "max_steps", "gn_cap"))
def follow_seeds(seeds: SeedTuple, plg_coords: jnp.ndarray,
                 plg_length: jnp.ndarray, P_mats: jnp.ndarray,
                 F_table: jnp.ndarray, drive_dir, cfg,
                 max_steps: int, fixed_perm=None,
                 fixed_dirs=None, gn_cap: int | None = None
                 ) -> FollowResult:
    """Sweep all seeds in one direction of the driving view.

    plg_coords [V,P,L,2], plg_length [V,P], P_mats [V,3,4],
    F_table [V,V,3,3].  The emitted obs_xy follow the ORIGINAL tuple
    view order of `seeds.cams`.

    With `fixed_perm`/`fixed_dirs` (continuation rounds: chains that
    hit max_steps resume from their final position) the direction
    resolve is skipped and the given configuration is used as-is.

    `gn_cap` sizes the compacted post-walk GN (None = heuristic
    default, see _default_gn_cap; pass S*max_steps to force the exact
    full-width path when a previous call reported gn_overflow > 0).
    """
    S = seeds.cams.shape[0]
    # flat one-row-per-polyline coordinate layout [V*P, 2L] (x block
    # then y block): seed gathers pull one CONTIGUOUS row per (seed,
    # tuple view) instead of a stride-2 [L,2] window, and the
    # loop-resident tensor has no trailing dim of 2.  The repack itself
    # is one linear pass, amortized across the whole walk.  A layout
    # choice, unmeasured on a GPU.
    V, P_cnt, L, _ = plg_coords.shape
    packed = jnp.concatenate(
        [plg_coords[..., 0], plg_coords[..., 1]],
        axis=-1).reshape(V * P_cnt, 2 * L)
    if fixed_perm is not None:
        perm, dirs = fixed_perm, fixed_dirs
        dir_ok = jnp.ones((S,), bool)
    else:
        perm, dirs, dir_ok = resolve_configuration(
            seeds, packed, plg_length, P_mats, F_table, drive_dir,
            cfg)

    # permute each seed's tuple so the chosen driving view is index 0
    cams, seg0, t0, xy0 = _permute_tuple(
        [seeds.cams, seeds.seg[..., None], seeds.t[..., None], seeds.xy],
        perm)
    seg0 = seg0[..., 0]
    t0 = t0[..., 0]
    pl = _permute_tuple([seeds.pl_id[..., None]], perm)[0][..., 0]
    seeds = SeedTuple(cams=cams, pl_id=pl, seg=seg0, t=t0, xy=xy0,
                      X=seeds.X, valid=seeds.valid)
    inv_perm = jnp.argsort(perm, axis=1)

    # pre-gather each seed's tuple polylines (fixed during following)
    rows = packed[seeds.cams * P_cnt + seeds.pl_id]     # [S,3,2L]
    px, py = rows[..., :L], rows[..., L:]
    lengths = plg_length[seeds.cams, seeds.pl_id]       # [S,3]
    P_cams = P_mats[seeds.cams]                         # [S,3,3,4]
    F_pairs = F_table[seeds.cams[:, 0:1], seeds.cams[:, 1:]]  # [S,2,3,3]

    # bounded WALK with EARLY EXIT: a while_loop (not scan) stops as
    # soon as every chain has terminated.  The loop body is walk-only
    # (advance + epipolar intersections); triangulation + GN acceptance
    # runs ONCE afterwards, batched over all [S, T] recorded steps —
    # the walk recurrence does not depend on triangulation results, so
    # this is exactly the reference's semantics (cold-start
    # compute_3d_point per step, plg_matching.cpp:633-759) at a
    # fraction of the sequential-loop cost (the nested GN while_loop
    # used to run inside every walk iteration).
    Sb = seeds.cams.shape[0]
    obs0 = jnp.zeros((Sb, max_steps, 3, 2), seeds.xy.dtype)
    segb0 = jnp.zeros((Sb, max_steps, 3), jnp.int32)
    tb0 = jnp.zeros((Sb, max_steps, 3), seeds.t.dtype)
    alive0 = jnp.zeros((Sb, max_steps), bool)

    def cond_fn(carry):
        i, _, _, _, active = carry[:5]
        return (i < max_steps) & jnp.any(active)

    def body_fn(carry):
        i, seg, t, xy, active, obs, segb, tb, alive_buf = carry
        nseg, nt, nxy, ok = _walk_step(px, py, lengths, seg, t, xy, dirs,
                                       F_pairs, cfg)
        alive = active & ok
        seg = jnp.where(alive[:, None], nseg, seg)
        t = jnp.where(alive[:, None], nt, t)
        xy = jnp.where(alive[:, None, None], nxy, xy)
        obs = jax.lax.dynamic_update_index_in_dim(obs, nxy, i, 1)
        segb = jax.lax.dynamic_update_index_in_dim(segb, nseg, i, 1)
        tb = jax.lax.dynamic_update_index_in_dim(tb, nt, i, 1)
        alive_buf = jax.lax.dynamic_update_index_in_dim(alive_buf, alive,
                                                        i, 1)
        return (i + 1, seg, t, xy, alive, obs, segb, tb, alive_buf)

    init = (jnp.int32(0), seeds.seg, seeds.t, seeds.xy,
            seeds.valid & dir_ok, obs0, segb0, tb0, alive0)
    (_, _, _, _, _, obs, segb, tb, walk_alive) = jax.lax.while_loop(
        cond_fn, body_fn, init)

    # batched triangulation + GN acceptance over the recorded steps
    # (parity: compute_3d_point_coords -> em_GaussNewton, MSE < 9).
    # COMPACTED: the [Sb, T] step grid is <1% live at scale, so live
    # rows are stream-compacted to `gn_cap` first and DLT + GN run only
    # there (round 4 ran 30 GN iterations over every dead slot — the
    # largest single slice of the full-scale stage-3 wall).  Per-row
    # math is identical: GN updates depend only on the row's own data,
    # so batch composition cannot change any accepted fixed point.
    if gn_cap is None:
        gn_cap = _default_gn_cap(Sb, max_steps)
    dt = obs.dtype
    valid_flat = walk_alive.reshape(-1)                # [Sb*T]
    pos = jnp.cumsum(valid_flat.astype(jnp.int32)) - 1
    n_w = jnp.sum(valid_flat.astype(jnp.int32))
    in_cap = valid_flat & (pos < gn_cap)
    widx = jnp.where(in_cap, pos, gn_cap)
    obs_flat = obs.reshape(Sb * max_steps, 6)
    obs_c = jnp.zeros((gn_cap + 1, 6), dt).at[widx].set(
        obs_flat, mode="drop")[:gn_cap]
    sid_flat = (jnp.arange(Sb * max_steps) // max_steps).astype(jnp.int32)
    sid_c = jnp.zeros((gn_cap + 1,), jnp.int32).at[widx].set(
        sid_flat, mode="drop")[:gn_cap]
    live_c = jnp.arange(gn_cap) < jnp.minimum(n_w, gn_cap)
    # camera matrices as 36 separate [gn_cap] gathers: a materialized
    # gathered [N,3,4] tiles to T(4,128) = 43x padding (see
    # ops/triangulation.p_soa) — the SoA gather costs 36 vectors
    P_c = [[[P_cams[:, o, r, c][sid_c] for c in range(4)]
            for r in range(3)] for o in range(3)]
    ox_c = [obs_c[:, 2 * o] for o in range(3)]
    oy_c = [obs_c[:, 2 * o + 1] for o in range(3)]
    mf_c = [live_c.astype(dt)] * 3
    X0c = triangulate_dlt_soa(P_c, ox_c, oy_c, mf_c)
    Xc, _, ok_c = gauss_newton_soa(
        P_c, ox_c, oy_c, mf_c, X0c, max_iters=cfg.gn_max_iters,
        epsilon=cfg.gn_epsilon, accept_mse=cfg.match_gn_max_mse)
    # scatter verdicts/points back to the [Sb, T] grid (pure gathers)
    posg = jnp.minimum(pos, gn_cap - 1)
    gn_ok = (in_cap & ok_c[posg]).reshape(Sb, max_steps)
    Xs = jnp.where(in_cap[:, None], Xc[posg], 0).reshape(
        Sb, max_steps, 3)
    gn_overflow = jnp.reshape(jnp.maximum(n_w - gn_cap, 0), (1,))
    # a GN failure terminates the chain at that step (prefix cut)
    ok_or_dead = gn_ok | ~walk_alive
    alive = walk_alive & jnp.cumprod(
        ok_or_dead.astype(jnp.int32), axis=1).astype(bool)
    n_steps = jnp.sum(alive, axis=1)

    # final accepted position per seed (for interval claiming)
    last = jnp.maximum(n_steps - 1, 0)
    fseg = jnp.take_along_axis(segb, last[:, None, None], axis=1)[:, 0]
    ft = jnp.take_along_axis(tb, last[:, None, None], axis=1)[:, 0]
    fseg = jnp.where((n_steps > 0)[:, None], fseg, seeds.seg)
    ft = jnp.where((n_steps > 0)[:, None], ft, seeds.t)

    # restore the caller's tuple-view order
    obs = jnp.take_along_axis(obs, inv_perm[:, None, :, None], axis=2)
    fseg = jnp.take_along_axis(fseg, inv_perm, axis=1)
    ft = jnp.take_along_axis(ft, inv_perm, axis=1)
    return FollowResult(X=Xs, obs_xy=obs, valid=alive,
                        n_steps=n_steps, final_seg=fseg, final_t=ft,
                        perm=perm, dirs=dirs, gn_overflow=gn_overflow)


@partial(jax.jit, static_argnames=("min_steps", "cap"))
def pack_follow_outputs(fwd: FollowResult, bwd: FollowResult,
                        seed_valid: jnp.ndarray, min_steps: int, cap: int):
    """Compact both directions' emitted chain points on device.

    Returns (buf [cap, 11], n_emitted, meta [S, 40]) where each buf row
    is [X(3), obs_xy(6), seed_idx(1), signed_order(1)] and meta rows are
    [total_steps(1),
     fwd final_seg(3), fwd final_t(3), bwd final_seg(3), bwd final_t(3),
     fwd n_steps(1), bwd n_steps(1),
     fwd final_xy(6), bwd final_xy(6),
     fwd perm(3), fwd dirs(3), bwd perm(3), bwd dirs(3),
     gn_overflow(1, broadcast — col 39; >0 => the caller must redo the
     follow with gn_cap = S*T, see follow_seeds)]
    — everything the host needs for interval claiming, chain
    continuation, and assembly in TWO transfers instead of ~20 padded
    ones (see ops/compaction.py).
    """
    from edgegraph3d_tpu.ops.compaction import compact_rows

    S, T = fwd.valid.shape
    total = fwd.n_steps + bwd.n_steps
    keep = seed_valid & (total >= min_steps)

    def flat(res, sign):
        val = (res.valid & keep[:, None]).reshape(-1)
        sidx = jnp.broadcast_to(
            jnp.arange(S, dtype=res.X.dtype)[:, None], (S, T))
        order = sign * (jnp.broadcast_to(
            jnp.arange(T, dtype=res.X.dtype)[None, :], (S, T)) + 1)
        payload = jnp.concatenate(
            [res.X, res.obs_xy.reshape(S, T, 6), sidx[..., None],
             order[..., None]], axis=-1).reshape(S * T, 11)
        return val, payload

    def final_xy(res):
        # observation tuple at the last accepted step (caller view order)
        last = jnp.maximum(res.n_steps - 1, 0)
        return jnp.take_along_axis(
            res.obs_xy, last[:, None, None, None], axis=1)[:, 0]  # [S,3,2]

    v1, p1 = flat(fwd, 1.0)
    v2, p2 = flat(bwd, -1.0)
    buf, n = compact_rows(jnp.concatenate([v1, v2]),
                          jnp.concatenate([p1, p2]), cap)
    f = fwd.X.dtype
    ovf = jnp.broadcast_to(
        jnp.maximum(fwd.gn_overflow.max(),
                    bwd.gn_overflow.max()).astype(f), (S,))
    meta = jnp.concatenate(
        [total.astype(f)[:, None],
         fwd.final_seg.astype(f), fwd.final_t.astype(f),
         bwd.final_seg.astype(f), bwd.final_t.astype(f),
         fwd.n_steps.astype(f)[:, None], bwd.n_steps.astype(f)[:, None],
         final_xy(fwd).reshape(S, 6), final_xy(bwd).reshape(S, 6),
         fwd.perm.astype(f), fwd.dirs.astype(f),
         bwd.perm.astype(f), bwd.dirs.astype(f), ovf[:, None]],
        axis=1)
    return buf, n, meta


def dead_follow_result(res: FollowResult, seeds: SeedTuple) -> FollowResult:
    """An all-invalid FollowResult shaped like `res` whose final
    position is the seed position — the 'other half' when packing a
    direction-pinned continuation sweep through pack_follow_outputs."""
    return FollowResult(
        X=jnp.zeros_like(res.X), obs_xy=jnp.zeros_like(res.obs_xy),
        valid=jnp.zeros_like(res.valid),
        n_steps=jnp.zeros_like(res.n_steps),
        final_seg=seeds.seg, final_t=seeds.t,
        perm=res.perm, dirs=res.dirs,
        gn_overflow=jnp.zeros_like(res.gn_overflow))


def follow_seeds_bidirectional(seeds: SeedTuple, plg_coords, plg_length,
                               P_mats, F_table, cfg, max_steps: int,
                               gn_cap: int | None = None):
    """Both driving directions (parity: follow_plgs_from_match* sweeping
    both ways, plg_matching.cpp:205-265), run as ONE double-width batch
    (fwd seeds stacked on bwd seeds) so the sequential scan is paid
    once.  Returns (fwd, bwd) results and the per-seed total step count
    used for the >=2-step seed validation (parity:
    compatible_new_plg_point, plg_matching.cpp:1276-1287)."""
    S = seeds.cams.shape[0]
    both = SeedTuple(*[jnp.concatenate([a, a], axis=0) for a in seeds])
    drive = jnp.concatenate([jnp.full((S,), 1, jnp.int32),
                             jnp.full((S,), -1, jnp.int32)])
    res = follow_seeds(both, plg_coords, plg_length, P_mats, F_table,
                       drive, cfg, max_steps, gn_cap=gn_cap)
    halve = lambda a, off: (a[off: off + S]
                            if a.shape and a.shape[0] == 2 * S else a)
    fwd = jax.tree.map(lambda a: halve(a, 0), res)
    bwd = jax.tree.map(lambda a: halve(a, S), res)
    total = fwd.n_steps + bwd.n_steps
    return fwd, bwd, total
