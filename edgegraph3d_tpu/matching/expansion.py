"""Chain-aware all-view expansion with Gauss-Newton re-validation.

JAX-native redesign of the reference's expansion of swept 3D chains to
every other view (reference:
src/edgegraph3d/utils/geometry/triangulation.cpp:742-919
`expand_allpoints_to_other_view_using_plmap` calling
src/edgegraph3d/matching/plg_matching/plg_matching.cpp:1345
`add_view_to_3dpoint_and_sides_plgp_matches_vector`, whose walk
re-validates every added observation through
`em_add_new_observation_to_3Dpositions`, triangulation.cpp:347-466):

  reference semantics (SWITCH_DISABLE_INTERVAL +
  SWITCH_PLG_MATCHING_ADDPOINT_BOTHDIR_ONE variant, the production
  configuration):
    per (chain, other view):
      1. anchor: scan chain points in order; project the 3D point, find
         the unique nearby polyline (<= 4 px, plmap), require the closest
         polyline point within MAX_3DPOINT_PROJECTIONDISTSQ_EXPANDALLVIEWS
         (16 px^2)
      2. the anchor observation must survive a GN re-run over all its
         observations + the new one at MSE < 9
         (em_add_new_observation_to_3Dpositions)
      3. walk the view's polyline ALONG THE CHAIN in both directions
         (epipolar intersection steps), re-validating every stepped
         observation the same way; stop at the first failure; an interior
         anchor whose either side fails to match >= 1 point is rejected
         outright (plg_matching.cpp:1370-1376)
      4. re-anchor after the matched interval and repeat

  JAX-native formulation (parallel over chains x chain points,
  sequential only over views):
      1. candidates for ALL chain points at once: closest polyline point
         within 4 px via the segment grid (the reference's plmap anchor
         IS the closest-point query; the walk's epipolar intersections
         land on the same polyline arc — here every point uses the
         closest-point form, a documented deviation)
      2. the walk's continuity becomes a parallel run test: accepted
         candidates must sit in a same-polyline, locally monotone
         (coordinate-position) run along the chain; runs shorter than 3
         (2 when touching a chain end) are dropped — exactly the
         both-directions-must-match rule for interior anchors
      3. GN re-validation is sequential over views like the reference
         (each view's accepted observation updates X before the next
         view is tried): one batched add_observation_to_3d_points per
         view over all [C*T] chain points

  Correspondence modes (config.expand_correspondence_mode):
    "closest"  — every chain point uses the closest-point-on-polyline
                 query (the round-2 formulation)
    "epipolar" — reference semantics: the anchor polyline still comes
                 from the unique closest-point query (the plmap anchor,
                 polyLine_2d_map_search.cpp find_unique_polyline...),
                 but the matched POSITION on it is the intersection of
                 the chain point's driving-view epipolar line with that
                 polyline when one exists within the tolerance — the
                 reference's epipolar-intersection walk
                 (triangulation.cpp:742-919) — falling back to the
                 closest point (the reference's projection+plmap
                 fallback) otherwise.
  tests/test_expansion.py A/Bs the two modes on a curve scene.

  The reference's follow_direction tail that EXTENDS the chain with
  brand-new 3D points when an expansion walk matches the full remaining
  chain (plg_matching.cpp:1393-1412) is implemented post-hoc by
  refpoints.extend_chains: chains whose expanded observation set covers
  a chain end are re-followed outward from that end with tuples drawn
  from the EXPANDED view set.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.matching import detection
from edgegraph3d_tpu.ops.geometry import project_depth
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched


def _expand_candidates(grid_v, proj, line, cell, tol: float,
                       mode: str, qp_cos: float = 0.965):
    """Per-query expansion candidate on one view.

    proj [Q,2] projected chain points, line [Q,3] driving-view epipolar
    lines (unused in "closest" mode).  Returns (pl, seg, t, xy, ok)
    where ok = unique anchor polyline within tol (the reference's
    find_unique_polyline_potentially_within_search_dist demand)."""
    cl = detection.map_query_blocks(
        jax.vmap(lambda pt: detection.detect_starting_intersections(
            grid_v, pt, cell, tol, 2)), (proj,), proj.shape[0])
    pl = cl.pl_id[:, 0]
    seg = cl.seg[:, 0]
    t = cl.t[:, 0]
    xy = cl.xy[:, 0]
    ok = cl.valid[:, 0] & ~cl.valid[:, 1]
    if mode == "epipolar":
        # position refinement: intersect the epipolar line with the
        # anchored polyline near the projection (reference walk step,
        # next_pl_point_by_line_intersection); fall back to the closest
        # point when the line misses within tol
        # quasi-parallel crossings are excluded (the reference walk's
        # next_pl_point_by_line_intersection quasi-parallel guard,
        # polyline_graph_2d.hpp:72-74) — near-tangent intersections
        # amplify discretization error; those points use the fallback
        ep = detection.map_query_blocks(
            jax.vmap(
                lambda pt, ln: detection.detect_epipolar_correspondences(
                    grid_v, pt, ln, cell, tol, 4,
                    exclude_parallel_cos=qp_cos)),
            (proj, line), proj.shape[0])
        same = ep.valid & (ep.pl_id == pl[:, None])        # [Q,4]
        has = jnp.any(same, axis=1)
        j = jnp.argmax(same, axis=1)
        rq = jnp.arange(proj.shape[0])
        seg = jnp.where(has, ep.seg[rq, j], seg)
        t = jnp.where(has, ep.t[rq, j], t)
        xy = jnp.where(has[:, None], ep.xy[rq, j], xy)
    return pl, seg, t, xy, ok


def _monotone_runs(pl_id: jnp.ndarray, pos: jnp.ndarray,
                   cand_ok: jnp.ndarray, chain_valid: jnp.ndarray):
    """Per chain point: length of the same-polyline monotone run it
    belongs to, plus whether the run touches a chain end.

    pl_id [C,T] int32, pos [C,T] float (seg + t along the polyline),
    cand_ok [C,T], chain_valid [C,T].  Returns (run_len [C,T],
    touches_end [C,T]) — all-parallel prefix/suffix maxes over T.
    """
    C, T = pl_id.shape
    idx = jnp.arange(T)
    ok = cand_ok & chain_valid

    # link[t]: candidate t continues the run from t-1
    same_pl = (pl_id[:, 1:] == pl_id[:, :-1]) & ok[:, 1:] & ok[:, :-1]
    dpos = pos[:, 1:] - pos[:, :-1]
    nonzero = jnp.abs(dpos) > 0
    base = same_pl & nonzero                               # [C,T-1]
    # local monotonicity: consecutive steps must advance the same way
    # (the reference's walk direction is fixed per run); the first step
    # of a run sets the sign, later steps must agree with the previous.
    # The sign constraint applies ONLY when the previous step is itself
    # a link candidate (base) — base requires ok on both its ends, so
    # the result is a pure function of values at ok slots.  Reading
    # `sign` through a non-ok slot would make run membership depend on
    # padding garbage and diverge between the dense and compacted
    # kernels (the round-2 parity failure).
    sign = jnp.sign(dpos)
    prev_base = jnp.concatenate(
        [jnp.zeros((C, 1), bool), base[:, :-1]], axis=1)   # [C,T-1]
    sign_agree = jnp.concatenate(
        [jnp.ones((C, 1), bool), sign[:, 1:] == sign[:, :-1]], axis=1)
    link = jnp.concatenate(
        [jnp.zeros((C, 1), bool),
         base & (~prev_base | sign_agree)], axis=1)        # [C,T]

    # run start per element: last index with ~link (cummax over t)
    start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(link, -1, idx[None, :]), axis=1)
    start = jnp.where(start < 0, 0, start)
    # run end per element: first index whose successor does not link
    link_next = jnp.concatenate([link[:, 1:],
                                 jnp.zeros((C, 1), bool)], axis=1)
    end = jax.lax.associative_scan(
        jnp.minimum, jnp.where(link_next, T, idx[None, :]), axis=1,
        reverse=True)
    run_len = jnp.where(ok, end - start + 1, 0)

    # chain extent (first/last valid chain point)
    big = T + 1
    first_valid = jnp.min(jnp.where(chain_valid, idx[None, :], big), axis=1)
    last_valid = jnp.max(jnp.where(chain_valid, idx[None, :], -1), axis=1)
    touches_end = (start <= first_valid[:, None]) | \
        (end >= last_valid[:, None])
    return run_len, touches_end


@partial(jax.jit, static_argnames=("cfg",))
def expand_chains_sweep(plg_coords, grids, P_mats, F_table, cell: float,
                        X, obs3, cams3, chain_valid,
                        cfg: EdgeGraphConfig):
    """Expand chains to all views with continuity + GN re-validation.

    plg_coords [V,P,L,2], grids [V,GH,GW,K,2], P_mats [V,3,4],
    F_table [V,V,3,3] (epipolar correspondence mode);
    X [C,T,3] chain points (T = chain axis, padded), obs3 [C,T,3,2]
    tuple-view observations, cams3 [C,3] tuple view ids,
    chain_valid [C,T].

    Returns (X' [C,T,3], obs_xy [C,T,V,2], obs_mask [C,T,V], mse [C,T])
    where obs_mask covers the 3 tuple views plus every accepted
    expansion view and X' is the per-view-sequentially re-refined point
    (parity: em_add_new_observation_to_3Dpositions acceptance chain).
    """
    V = P_mats.shape[0]
    C, T = chain_valid.shape
    dtype = X.dtype
    flat = lambda a: a.reshape((C * T,) + a.shape[2:])

    tol = float(np.sqrt(cfg.expand_max_projection_distsq))
    vs = cams3[:, 0]                                       # [C] driving view
    drive_h = jnp.concatenate(
        [obs3[:, :, 0, :], jnp.ones((C, T, 1), dtype)], axis=-1)

    # observation buffers start with the 3 tuple views
    Omax = min(V, max(cfg.max_obs_per_point, 4))
    P3 = P_mats[cams3]                                    # [C,3,3,4]
    P_obs = jnp.zeros((C, T, Omax, 3, 4), dtype)
    P_obs = P_obs.at[:, :, :3].set(
        jnp.broadcast_to(P3[:, None], (C, T, 3, 3, 4)))
    obs_xy_buf = jnp.zeros((C, T, Omax, 2), dtype)
    obs_xy_buf = obs_xy_buf.at[:, :, :3].set(obs3)
    obs_mask = jnp.zeros((C, T, Omax), bool)
    obs_mask = obs_mask.at[:, :, :3].set(chain_valid[..., None])

    # per-view output observations
    out_xy = jnp.zeros((C, T, V, 2), dtype)
    out_ok = jnp.zeros((C, T, V), bool)
    # tuple views: exact tracked coordinates
    rows = jnp.arange(C)[:, None]
    for k in range(3):
        out_xy = out_xy.at[rows, jnp.arange(T)[None, :],
                           cams3[:, k][:, None]].set(obs3[:, :, k])
        out_ok = out_ok.at[rows, jnp.arange(T)[None, :],
                           cams3[:, k][:, None]].set(chain_valid)

    mse0 = jnp.zeros((C, T), dtype)

    def per_view(carry, v):
        X, P_obs, obs_xy_buf, obs_mask, out_xy, out_ok, _ = carry
        proj, depth = project_depth(P_mats[v][None, None], X)   # [C,T,2]

        Fv = jnp.take(F_table, v, axis=1)[vs]              # [C,3,3]
        line = jnp.einsum("cij,ctj->cti", Fv, drive_h,
                          precision=jax.lax.Precision.HIGHEST)
        ln = jnp.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
        line = line / jnp.maximum(ln, 1e-20)[..., None]
        pl, seg, t, xy, uq = _expand_candidates(
            grids[v], flat(proj), flat(line), cell, tol,
            cfg.expand_correspondence_mode, cfg.quasiparallel_cos)
        c_pl = pl.reshape(C, T)
        c_seg = seg.reshape(C, T)
        c_t = t.reshape(C, T)
        c_xy = xy.reshape(C, T, 2)
        c_ok = uq.reshape(C, T) & (depth > 0)

        is_tuple = jnp.any(cams3 == v, axis=1)            # [C]
        c_ok = c_ok & ~is_tuple[:, None] & chain_valid

        # continuity: same-polyline locally-monotone runs along the chain
        pos = c_seg.astype(dtype) + c_t
        run_len, touches = _monotone_runs(c_pl, pos, c_ok, chain_valid)
        min_run = jnp.where(touches, 2, 3)
        # single-point chains (seed only) keep the plain anchor rule
        n_chain = jnp.sum(chain_valid, axis=1)
        cont_ok = (run_len >= min_run) | (n_chain[:, None] <= 2)
        c_ok = c_ok & cont_ok

        # GN re-validation: add this view's observation, keep if the
        # re-refined point stays under the matching MSE gate
        free = ~obs_mask                                   # [C,T,O]
        slot = jnp.argmax(flat(free), axis=-1)             # [C*T]
        has_free = jnp.any(flat(free), axis=-1)
        put = flat(c_ok) & has_free
        r = jnp.arange(C * T)
        P_f = flat(P_obs)
        xy_f = flat(obs_xy_buf)
        m_f = flat(obs_mask)
        P_try = P_f.at[r, slot].set(
            jnp.where(put[:, None, None], P_mats[v], P_f[r, slot]))
        xy_try = xy_f.at[r, slot].set(
            jnp.where(put[:, None], flat(c_xy), xy_f[r, slot]))
        m_try = m_f.at[r, slot].set(m_f[r, slot] | put)
        Xr, mse, ok = gauss_newton_batched(
            P_try, xy_try, m_try, flat(X),
            max_iters=cfg.follow_gn_iters, epsilon=cfg.gn_epsilon,
            accept_mse=cfg.match_gn_max_mse)
        accept = put & ok

        # commit accepted observations
        X = jnp.where(accept[:, None], Xr, flat(X)).reshape(C, T, 3)
        P_obs = jnp.where(accept[:, None, None, None],
                          P_try, P_f).reshape(P_obs.shape)
        obs_xy_buf = jnp.where(accept[:, None, None],
                               xy_try, xy_f).reshape(obs_xy_buf.shape)
        obs_mask = jnp.where(accept[:, None],
                             m_try, m_f).reshape(obs_mask.shape)
        acc2 = accept.reshape(C, T)
        out_xy = out_xy.at[:, :, v].set(
            jnp.where(acc2[..., None], c_xy, out_xy[:, :, v]))
        out_ok = out_ok.at[:, :, v].set(out_ok[:, :, v] | acc2)
        return (X, P_obs, obs_xy_buf, obs_mask, out_xy, out_ok,
                mse.reshape(C, T)), None

    carry0 = (X, P_obs, obs_xy_buf, obs_mask, out_xy, out_ok, mse0)
    (X, P_obs, obs_xy_buf, obs_mask, out_xy, out_ok, mse), _ = \
        jax.lax.scan(per_view, carry0, jnp.arange(V))
    return X, out_xy, out_ok, mse


@partial(jax.jit, static_argnames=("cfg", "C", "T"))
def expand_chains_compact(plg_coords, grids, P_mats, F_table, cell: float,
                          X, obs3, cams3, chain_idx, t_idx, item_ok,
                          chain_valid, cfg: EdgeGraphConfig,
                          C: int, T: int):
    """Compacted expand_chains_sweep: identical semantics, but the
    detection + GN work runs on a flat [K] list of valid chain points
    instead of the padded [C, T] grid (typical fill is ~15-20%, so this
    is a ~5x device-time cut; the continuity run test still scatters to
    the [C, T] layout, which is cheap elementwise work).

    X [K,3], obs3 [K,3,2], cams3 [C,3], chain_idx/t_idx [K] (the chain
    slot each compacted point occupies), item_ok [K] (padding rows
    False), chain_valid [C,T] (must equal scatter(item_ok)).

    Returns (X' [K,3], out_xy [K,V,2], out_ok [K,V], mse [K]).
    """
    V = P_mats.shape[0]
    K = X.shape[0]
    # common promotion: under x64 P_mats/obs arrive f64 while seed X may
    # still be f32 — the scan carry (X, mse) must not promote mid-loop
    dtype = jnp.result_type(X.dtype, P_mats.dtype, obs3.dtype)
    X = X.astype(dtype)
    obs3 = obs3.astype(dtype)
    tol = float(np.sqrt(cfg.expand_max_projection_distsq))
    Omax = min(V, max(cfg.max_obs_per_point, 4))
    cam_rows = cams3[chain_idx]                            # [K,3]
    vs = cam_rows[:, 0]                                    # [K] driving view
    drive_h = jnp.concatenate(
        [obs3[:, 0, :], jnp.ones((K, 1), dtype)], axis=-1)

    # compact observation buffers: camera INDICES (one i32 per slot)
    # instead of materialized [K, Omax, 3, 4] matrices (36 floats per
    # slot, with tiny minor dims that a tiled layout pads), and split
    # x/y coordinate planes instead of a trailing dim of 2.  The GN
    # consumes the SoA form directly (gauss_newton_soa), gathering each
    # P entry as a [K] vector from the tiny [V] table.
    cam_buf = jnp.full((K, Omax), 0, jnp.int32).at[:, :3].set(cam_rows)
    obs_x_buf = jnp.zeros((K, Omax), dtype).at[:, :3].set(obs3[..., 0])
    obs_y_buf = jnp.zeros((K, Omax), dtype).at[:, :3].set(obs3[..., 1])
    obs_mask = jnp.zeros((K, Omax), bool).at[:, :3].set(
        item_ok[:, None])

    out_x = jnp.zeros((K, V), dtype)
    out_y = jnp.zeros((K, V), dtype)
    out_ok = jnp.zeros((K, V), bool)
    r = jnp.arange(K)
    for k in range(3):
        out_x = out_x.at[r, cam_rows[:, k]].set(obs3[:, k, 0])
        out_y = out_y.at[r, cam_rows[:, k]].set(obs3[:, k, 1])
        out_ok = out_ok.at[r, cam_rows[:, k]].set(item_ok)

    n_chain = jnp.sum(chain_valid, axis=1)                 # [C]
    from edgegraph3d_tpu.ops.triangulation import gauss_newton_soa

    def per_view(carry, v):
        X, cam_buf, obs_x_buf, obs_y_buf, obs_mask, out_x, out_y, \
            out_ok, _ = carry
        proj, depth = project_depth(P_mats[v][None, None], X[:, None, :])
        proj = proj[:, 0]
        depth = depth[:, 0]

        Fv = jnp.take(F_table, v, axis=1)[vs]              # [K,3,3]
        line = jnp.einsum("kij,kj->ki", Fv, drive_h,
                          precision=jax.lax.Precision.HIGHEST)
        ln = jnp.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2)
        line = line / jnp.maximum(ln, 1e-20)[..., None]
        c_pl, c_seg, c_t, c_xy, uq = _expand_candidates(
            grids[v], proj, line, cell, tol,
            cfg.expand_correspondence_mode, cfg.quasiparallel_cos)
        is_tuple = jnp.any(cam_rows == v, axis=1)          # [K]
        c_ok = uq & (depth > 0) & ~is_tuple & item_ok

        # continuity run test in the [C,T] layout.  Padding rows are
        # routed to an OUT-OF-BOUNDS chain index so mode="drop" really
        # drops them — zero-padded chain_idx/t_idx would alias slot
        # (0, 0) and clobber a real chain point's scattered values
        # (the round-2 dense-vs-compact parity failure).
        pos = c_seg.astype(dtype) + c_t
        ci_s = jnp.where(item_ok, chain_idx, C)
        pl_g = jnp.full((C, T), -2, jnp.int32).at[ci_s, t_idx].set(
            c_pl, mode="drop")
        pos_g = jnp.zeros((C, T), dtype).at[ci_s, t_idx].set(
            pos, mode="drop")
        ok_g = jnp.zeros((C, T), bool).at[ci_s, t_idx].set(
            c_ok, mode="drop")
        run_len, touches = _monotone_runs(pl_g, pos_g, ok_g, chain_valid)
        min_run = jnp.where(touches, 2, 3)
        cont_g = (run_len >= min_run) | (n_chain[:, None] <= 2)
        c_ok = c_ok & cont_g[chain_idx, t_idx]

        # GN re-validation (identical semantics to expand_chains_sweep)
        free = ~obs_mask
        slot = jnp.argmax(free, axis=-1)
        put = c_ok & jnp.any(free, axis=-1)
        cam_try = cam_buf.at[r, slot].set(
            jnp.where(put, v, cam_buf[r, slot]))
        x_try = obs_x_buf.at[r, slot].set(
            jnp.where(put, c_xy[:, 0], obs_x_buf[r, slot]))
        y_try = obs_y_buf.at[r, slot].set(
            jnp.where(put, c_xy[:, 1], obs_y_buf[r, slot]))
        m_try = obs_mask.at[r, slot].set(obs_mask[r, slot] | put)
        P_soa = [[[P_mats[:, a, b][cam_try[:, o]] for b in range(4)]
                  for a in range(3)] for o in range(Omax)]
        mf = [m_try[:, o].astype(dtype) for o in range(Omax)]
        Xr, mse, ok = gauss_newton_soa(
            P_soa, [x_try[:, o] for o in range(Omax)],
            [y_try[:, o] for o in range(Omax)], mf, X,
            max_iters=cfg.follow_gn_iters, epsilon=cfg.gn_epsilon,
            accept_mse=cfg.match_gn_max_mse)
        accept = put & ok

        X = jnp.where(accept[:, None], Xr, X)
        cam_buf = jnp.where(accept[:, None], cam_try, cam_buf)
        obs_x_buf = jnp.where(accept[:, None], x_try, obs_x_buf)
        obs_y_buf = jnp.where(accept[:, None], y_try, obs_y_buf)
        obs_mask = jnp.where(accept[:, None], m_try, obs_mask)
        out_x = out_x.at[:, v].set(
            jnp.where(accept, c_xy[:, 0], out_x[:, v]))
        out_y = out_y.at[:, v].set(
            jnp.where(accept, c_xy[:, 1], out_y[:, v]))
        out_ok = out_ok.at[:, v].set(out_ok[:, v] | accept)
        return (X, cam_buf, obs_x_buf, obs_y_buf, obs_mask, out_x,
                out_y, out_ok, mse), None

    carry0 = (X, cam_buf, obs_x_buf, obs_y_buf, obs_mask, out_x, out_y,
              out_ok, jnp.zeros((K,), dtype))
    (X, cam_buf, obs_x_buf, obs_y_buf, obs_mask, out_x, out_y, out_ok,
     mse), _ = jax.lax.scan(per_view, carry0, jnp.arange(V))
    return X, jnp.stack([out_x, out_y], axis=-1), out_ok, mse


def group_chains(seed_ids: np.ndarray, orders: np.ndarray,
                 max_t: int = 64):
    """Group flat chain rows into padded [C, T<=max_t] index tensors.

    Rows of one seed sorted by signed chain order form the chain
    (backward sweep reversed, seed, forward sweep); chains longer than
    max_t are split into consecutive pieces (continuity runs are cut at
    piece boundaries — a bounded-recall tradeoff for fixed shapes).

    Returns (gather_idx [C, max_t] int64 into the flat rows, valid
    [C, max_t]).
    """
    n = len(seed_ids)
    if n == 0:
        return (np.zeros((0, max_t), np.int64),
                np.zeros((0, max_t), bool))
    order = np.lexsort((orders, seed_ids))
    sid = seed_ids[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(sid)) + 1, [n]])
    gather, valid = [], []
    for a, b in zip(starts[:-1], starts[1:]):
        for lo in range(a, b, max_t):
            hi = min(lo + max_t, b)
            pad = max_t - (hi - lo)
            gather.append(np.pad(order[lo:hi], (0, pad)))
            valid.append(np.pad(np.ones(hi - lo, bool), (0, pad)))
    return np.stack(gather), np.stack(valid)
