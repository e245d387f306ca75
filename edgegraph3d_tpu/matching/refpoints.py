"""Stage 3: edge reconstruction from SfM reference points.

JAX-native redesign of the reference's per-refpoint OpenMP loop
(reference: src/edgegraph3d/matching/plg_matching/plg_matching_from_refpoints.cpp:55-165
and matching/consensus_manager/plgpcm_3views_plg_following.cpp:40-69):

  per refpoint, per viewing cam, per nearby polyline intersection:
    1. detect starting intersections (<= 10 px) on the starting cam
    2. epipolar correspondences on the other viewing cams
       (radius = starting distance x 3)
    3. select 3 views: (min id, starting cam, max id) among views with
       candidates (parity: triangulation.cpp:1035-1066)
    4. cartesian candidate pairs -> triangulate + GN; require a UNIQUE
       valid seed (parity: compute_unique_potential_3d_points_3views_...
       triangulation.cpp:550-601)
    5. follow the seed both ways (following.py); seeds surviving < 2
       steps are dropped (parity: compatible_new_plg_point)
    6. expand every swept point to all other views by projection +
       grid lookup within 4 px (parity:
       expand_allpoints_to_other_view_using_plmap, triangulation.cpp:742-919,
       MAX_3DPOINT_PROJECTIONDISTSQ_EXPANDALLVIEWS = 16 px^2)

Data layout is DENSE over views: observations are [N, V] masked tensors,
and all grid work iterates views with `lax.map` so each step indexes one
view's grid/polylines concretely (a dynamic-slice, not a per-query
gather of whole grids).  The refpoint loop becomes a batch dimension;
chunks are jitted device sweeps with host-side compaction between
stages.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu.core.sfm import SfMData
from edgegraph3d_tpu.matching import detection, following
from edgegraph3d_tpu.matching import matches as matches_mod
from edgegraph3d_tpu.matching.grid import build_grids
from edgegraph3d_tpu.ops.geometry import all_fundamental_matrices
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched, \
    triangulate_dlt
from edgegraph3d_tpu.plgs.polyline_graph import PLGStack


@dataclass
class MatchingContext:
    """Device-resident inputs shared by all matching stages.

    With `mesh` set (a 1-D `jax.sharding.Mesh`), every sweep shards its
    work-item axis (refpoints / seeds / 3D points) over the mesh devices
    and replicates these context tensors — the JAX-native replacement of
    the reference's OpenMP refpoint loop (SURVEY.md §2.10)."""
    plg_coords: jnp.ndarray    # [V,P,L,2]
    plg_length: jnp.ndarray    # [V,P]
    grids: jnp.ndarray         # [V,GH,GW,K,2]
    P_mats: jnp.ndarray        # [V,3,4]
    F_table: jnp.ndarray       # [V,V,3,3]
    cell: float
    config: EdgeGraphConfig
    mesh: object = None        # jax.sharding.Mesh | None

    @property
    def n_shards(self) -> int:
        return self.mesh.size if self.mesh is not None else 1


def lmeds_fundamental_table(sfmd: SfMData, config: EdgeGraphConfig,
                            dtype=jnp.float32) -> jnp.ndarray:
    """All-pairs F table fit from common refpoint observations with
    LMedS (the reference's production path:
    generate_all_fundamental_matrices -> cv::findFundamentalMat(FM_LMEDS)
    on >= fmat_min_common_points common points,
    geometric_utilities.cpp:750-781).  Pairs with too few common points
    get the line (0,0,1) sentinel — epipolar queries then find no
    crossings, mirroring the reference's invalid-F skip (:824-843)."""
    from edgegraph3d_tpu.ops.geometry import fundamental_lmeds

    V = sfmd.n_cameras
    obs_xy, obs_mask = dense_observations(sfmd, dtype=np.float32)
    pairs = [(i, j) for i in range(V) for j in range(V) if i != j]
    x1 = np.stack([obs_xy[:, i] for i, _ in pairs])      # [P,N,2]
    x2 = np.stack([obs_xy[:, j] for _, j in pairs])
    mm = np.stack([obs_mask[:, i] & obs_mask[:, j] for i, j in pairs])
    F_out = np.zeros((V, V, 3, 3), np.float32)
    F_out[:, :, 2, 2] = 1.0          # invalid-F sentinel: line (0,0,1)
    fit = jax.jit(jax.vmap(
        lambda a, b, m, k: fundamental_lmeds(
            a, b, m, k, min_points=config.fmat_min_common_points)))
    chunk = 256
    for lo in range(0, len(pairs), chunk):
        hi = min(lo + chunk, len(pairs))
        pad = chunk - (hi - lo)
        keys = jax.random.split(jax.random.PRNGKey(0), chunk)
        Fc, ok = fit(jnp.asarray(np.pad(x1[lo:hi],
                                        ((0, pad), (0, 0), (0, 0)))),
                     jnp.asarray(np.pad(x2[lo:hi],
                                        ((0, pad), (0, 0), (0, 0)))),
                     jnp.asarray(np.pad(mm[lo:hi], ((0, pad), (0, 0)))),
                     keys)
        Fc = np.asarray(Fc)[: hi - lo]
        ok = np.asarray(ok)[: hi - lo]
        for k, (i, j) in enumerate(pairs[lo:hi]):
            if ok[k]:
                F_out[i, j] = Fc[k]
    return jnp.asarray(F_out, dtype)


def build_context(sfmd: SfMData, stack: PLGStack,
                  config: EdgeGraphConfig = DEFAULT_CONFIG,
                  cell: float = 10.0, mesh=None) -> MatchingContext:
    dtype = jnp.float32 if config.dtype == "float32" else jnp.float64
    P_mats = jnp.asarray(sfmd.P, dtype)
    if config.fmat_source == "lmeds":
        F = lmeds_fundamental_table(sfmd, config, dtype)
    else:
        F = all_fundamental_matrices(P_mats,
                                     jnp.asarray(sfmd.center, dtype))
    grids = build_grids(stack, sfmd.widths, sfmd.heights, cell,
                        config.grid_cell_capacity)
    ctx = MatchingContext(
        plg_coords=jnp.asarray(stack.coords, dtype),
        plg_length=jnp.asarray(stack.length),
        grids=jnp.asarray(grids),
        P_mats=P_mats,
        F_table=F,
        cell=cell,
        config=config,
        mesh=mesh,
    )
    if mesh is not None:
        # pin the replicated context on the mesh once so per-chunk sweeps
        # do not re-broadcast it
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(mesh, PartitionSpec())
        for f in ("plg_coords", "plg_length", "grids", "P_mats",
                  "F_table"):
            setattr(ctx, f, jax.device_put(getattr(ctx, f), rep))
    return ctx


def dense_observations(sfmd: SfMData, dtype=np.float32):
    """Ragged per-point obs -> dense [N,V] tensors (obs_xy, obs_mask).

    Vectorized scatter; memoized on the scene object (all three matching
    stages ask for the same tensors)."""
    cached = getattr(sfmd, "_dense_obs_cache", None)
    if cached is not None and cached[0] == (sfmd.n_points, str(dtype)):
        return cached[1], cached[2]
    N, V = sfmd.n_points, sfmd.n_cameras
    xy = np.zeros((N, V, 2), dtype=dtype)
    mask = np.zeros((N, V), dtype=bool)
    if N:
        counts = np.asarray([len(c) for c in sfmd.obs_cam])
        rows = np.repeat(np.arange(N), counts)
        cams = np.concatenate([np.asarray(c, np.int64).reshape(-1)
                               for c in sfmd.obs_cam])
        pts = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2)
                              for p in sfmd.obs_xy])
        xy[rows, cams] = pts
        mask[rows, cams] = True
    object.__setattr__(sfmd, "_dense_obs_cache",
                       ((N, str(dtype)), xy, mask))
    return xy, mask


# ----------------------------------------------------------------------
# Seed formation (one refpoint-chunk sweep, jitted)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("M", "cfg"))
def _seed_sweep(plg_coords, plg_length, grids, P_mats, F_table,
                cell: float, obs_xy, obs_mask, start_mask, M: int,
                cfg: EdgeGraphConfig):
    """Form seeds for a chunk of refpoints.

    obs_xy [N,V,2], obs_mask [N,V], start_mask [N,V] (which views may act
    as the starting cam).  Returns per-(refpoint, starting-view,
    candidate) seed fields [N,V,M,...] + valid [N,V,M].
    """
    N, V = obs_mask.shape

    # 1. starting intersections per (refpoint, view)
    def start_view(v):
        def q(pt):
            return detection.detect_starting_intersections(
                grids[v], pt, cell,
                cfg.detection_starting_dist_px, M)
        return jax.vmap(q)(obs_xy[:, v])
    starts = jax.lax.map(start_view, jnp.arange(V))       # fields [V,N,M]
    starts = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), starts)
    s_valid = starts.valid & start_mask[..., None]        # [N,V,M]

    # 2. epipolar lines of each starting candidate into every other view
    xyh = jnp.concatenate(
        [starts.xy, jnp.ones(starts.xy.shape[:-1] + (1,),
                             starts.xy.dtype)], axis=-1)  # [N,V,M,3]
    lines = jnp.einsum("abij,namj->nambi", F_table, xyh,
                       precision=jax.lax.Precision.HIGHEST)  # [N,Vs,M,Vo,3]
    lnorm = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / jnp.maximum(lnorm, 1e-20)[..., None]

    radius = jnp.minimum(starts.dist * cfg.detection_correspondence_factor,
                         3.0 * cfg.detection_starting_dist_px)
    radius = jnp.maximum(radius, cfg.detection_starting_dist_px
                         * cfg.detection_radius_floor_factor)

    # 3. correspondences: iterate target views, vmap over (n, vs, m)
    def corr_view(vo):
        def q(pt, line, rad):
            return detection.detect_epipolar_correspondences(
                grids[vo], pt, line, cell, rad, M)
        pt = jnp.broadcast_to(obs_xy[:, vo][:, None, None, :], (N, V, M, 2))
        line = lines[:, :, :, vo]
        flat = jax.vmap(q)(pt.reshape(-1, 2), line.reshape(-1, 3),
                           radius.reshape(-1))
        return jax.tree.map(
            lambda a: a.reshape((N, V, M) + a.shape[1:]), flat)
    corr = jax.lax.map(corr_view, jnp.arange(V))          # fields [Vo,N,Vs,M,Mc]
    corr = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 3), corr)  # [N,Vs,M,Vo,Mc]

    not_self = ~jnp.eye(V, dtype=bool)                    # [Vs,Vo]
    corr_ok = corr.valid & obs_mask[:, None, None, :, None] \
        & not_self[None, :, None, :, None] & s_valid[..., None, None]

    # 4. select (min view id, starting, max view id) among views with
    #    >= 1 correspondence
    view_has = jnp.any(corr_ok, axis=-1)                  # [N,Vs,M,Vo]
    vids = jnp.arange(V)
    big = jnp.int32(10 ** 6)
    v1 = jnp.argmin(jnp.where(view_has, vids, big), axis=-1)   # [N,Vs,M]
    v2 = jnp.argmax(jnp.where(view_has, vids, -1), axis=-1)
    two_views = (jnp.sum(view_has, axis=-1) >= 2) & (v1 != v2)

    def gather_view(arr, v):
        return jnp.take_along_axis(
            arr, v[..., None].reshape(v.shape + (1,) * (arr.ndim - v.ndim)),
            axis=3).squeeze(3)

    c1 = jax.tree.map(lambda a: gather_view(a, v1), corr)  # [N,Vs,M,Mc]
    c2 = jax.tree.map(lambda a: gather_view(a, v2), corr)
    c1_ok = gather_view(corr_ok, v1)
    c2_ok = gather_view(corr_ok, v2)

    # 5. triangulate all candidate pairs; unique valid seed required
    cam_s = jnp.broadcast_to(vids[None, :, None], (N, V, M))
    cams3 = jnp.stack([cam_s, v1, v2], axis=-1)            # [N,V,M,3]
    P3 = P_mats[cams3]                                     # [N,V,M,3,3,4]

    pair_xy = jnp.stack([
        jnp.broadcast_to(starts.xy[..., None, None, :], (N, V, M, M, M, 2)),
        jnp.broadcast_to(c1.xy[..., :, None, :], (N, V, M, M, M, 2)),
        jnp.broadcast_to(c2.xy[..., None, :, :], (N, V, M, M, M, 2)),
    ], axis=-2)                                            # [N,V,M,M,M,3,2]
    P_pairs = jnp.broadcast_to(P3[..., None, None, :, :, :],
                               (N, V, M, M, M, 3, 3, 4))
    flat_xy = pair_xy.reshape(-1, 3, 2)
    flat_P = P_pairs.reshape(-1, 3, 3, 4)
    mask3 = jnp.ones(flat_xy.shape[:2], dtype=bool)
    X0 = triangulate_dlt(flat_P, flat_xy, mask3)
    X, mse, ok = gauss_newton_batched(
        flat_P, flat_xy, mask3, X0, max_iters=cfg.gn_max_iters,
        accept_mse=cfg.match_gn_max_mse, epsilon=cfg.gn_epsilon)
    X = X.reshape(N, V, M, M, M, 3)
    ok = ok.reshape(N, V, M, M, M)
    ok = ok & c1_ok[..., :, None] & c2_ok[..., None, :] \
        & two_views[..., None, None]

    n_valid = jnp.sum(ok.reshape(N, V, M, -1), axis=-1)
    unique = n_valid == 1
    pick = jnp.argmax(ok.reshape(N, V, M, -1), axis=-1)
    i1 = pick // M
    i2 = pick % M

    def pick_cand(arr, idx):
        return jnp.take_along_axis(
            arr, idx[..., None].reshape(idx.shape + (1,) * (arr.ndim - idx.ndim)),
            axis=3).squeeze(3)

    seed_X = jnp.take_along_axis(
        X.reshape(N, V, M, -1, 3), pick[..., None, None], axis=3).squeeze(3)
    seed_valid = unique & s_valid & two_views

    sel1 = jax.tree.map(lambda a: pick_cand(a, i1), c1)
    sel2 = jax.tree.map(lambda a: pick_cand(a, i2), c2)
    pl3 = jnp.stack([starts.pl_id, sel1.pl_id, sel2.pl_id], axis=-1)
    seg3 = jnp.stack([starts.seg, sel1.seg, sel2.seg], axis=-1)
    t3 = jnp.stack([starts.t, sel1.t, sel2.t], axis=-1)
    xy3 = jnp.stack([starts.xy, sel1.xy, sel2.xy], axis=-2)

    return dict(cams=cams3, pl_id=pl3, seg=seg3, t=t3, xy=xy3,
                X=seed_X, valid=seed_valid)


# ----------------------------------------------------------------------
# Compacted seed formation (single-device fast path)
#
# The dense _seed_sweep spends ~95% of its device time on epipolar
# correspondence detection over the full [N, V, M] start grid, of which
# only a few percent of slots hold a valid starting intersection.  The
# fast path splits the sweep: kernel A detects
# starting intersections and stream-compacts the valid (refpoint, view,
# candidate) triples on device; kernel B runs correspondence detection +
# triangulation only on the compacted list.  Seed-for-seed identical to
# _seed_sweep (same detection, selection, and GN math; the compaction
# preserves (n, v, m) order) — asserted by tests/test_refpoints_e2e.py.
# ----------------------------------------------------------------------

# compacted-start buffer columns: [ridx, vs, pl_id, seg, t, xy(2), dist]
_S_COLS = 8


@partial(jax.jit, static_argnames=("M", "cap"))
def _start_sweep(plg_coords, grids, cell: float, obs_xy, start_mask,
                 starting_dist: float, M: int, cap: int):
    """Kernel A: starting intersections for a refpoint chunk, compacted
    to [cap, 8] in (n, v, m) order.  Returns (buf, n_valid)."""
    from edgegraph3d_tpu.ops.compaction import compact_rows
    N, V = start_mask.shape

    def start_view(v):
        def q(pt):
            return detection.detect_starting_intersections(
                grids[v], pt, cell, starting_dist, M)
        return jax.vmap(q)(obs_xy[:, v])
    starts = jax.lax.map(start_view, jnp.arange(V))       # fields [V,N,M]
    starts = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), starts)
    s_valid = starts.valid & start_mask[..., None]        # [N,V,M]

    f = obs_xy.dtype
    ridx = jnp.broadcast_to(jnp.arange(N, dtype=f)[:, None, None],
                            (N, V, M))
    vs = jnp.broadcast_to(jnp.arange(V, dtype=f)[None, :, None],
                          (N, V, M))
    payload = jnp.stack([
        ridx, vs, starts.pl_id.astype(f), starts.seg.astype(f),
        starts.t.astype(f), starts.xy[..., 0], starts.xy[..., 1],
        starts.dist.astype(f)], axis=-1).reshape(N * V * M, _S_COLS)
    return compact_rows(s_valid.reshape(-1), payload, cap)


@partial(jax.jit, static_argnames=("M", "cfg", "cap_out"))
def _seed_from_starts(plg_coords, plg_length, grids, P_mats, F_table,
                      cell: float, starts_buf, n_starts, obs_xy, obs_mask,
                      M: int, cfg: EdgeGraphConfig, cap_out: int):
    """Kernel B: epipolar correspondences + 3-view triangulation for the
    compacted starts.  Same math and selection as _seed_sweep steps 2-5;
    returns a packed [cap_out, 22] seed buffer + count (the layout of
    _pack_seed_outputs)."""
    from edgegraph3d_tpu.ops.compaction import compact_rows
    K = starts_buf.shape[0]
    V = obs_mask.shape[1]
    ridx = starts_buf[:, 0].astype(jnp.int32)
    vs = starts_buf[:, 1].astype(jnp.int32)
    s_pl = starts_buf[:, 2].astype(jnp.int32)
    s_seg = starts_buf[:, 3].astype(jnp.int32)
    s_t = starts_buf[:, 4]
    s_xy = starts_buf[:, 5:7]
    s_dist = starts_buf[:, 7]
    item_ok = jnp.arange(K) < n_starts

    # 2. epipolar lines of each start into every other view
    xyh = jnp.concatenate([s_xy, jnp.ones((K, 1), s_xy.dtype)], axis=-1)
    lines = jnp.einsum("kvab,kb->kva", F_table[vs], xyh,
                       precision=jax.lax.Precision.HIGHEST)   # [K,V,3]
    lnorm = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / jnp.maximum(lnorm, 1e-20)[..., None]

    radius = jnp.minimum(s_dist * cfg.detection_correspondence_factor,
                         3.0 * cfg.detection_starting_dist_px)
    radius = jnp.maximum(radius, cfg.detection_starting_dist_px
                         * cfg.detection_radius_floor_factor)

    # 3. correspondences: iterate target views, vmap over compacted items
    obs_rows = obs_xy[ridx]                                  # [K,V,2]

    def corr_view(vo):
        def q(pt, line, rad):
            return detection.detect_epipolar_correspondences(
                grids[vo], pt, line, cell, rad, M)
        # blocked queries: bounds the padded neighborhood-gather temp
        # (see detection.map_query_blocks) at any compacted-start width
        return detection.map_query_blocks(
            jax.vmap(q), (obs_rows[:, vo], lines[:, vo], radius), K)
    corr = jax.lax.map(corr_view, jnp.arange(V))             # [V,K,M]
    corr = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), corr)  # [K,V,M]

    vids = jnp.arange(V)
    corr_ok = corr.valid & obs_mask[ridx][:, :, None] \
        & (vids[None, :, None] != vs[:, None, None]) \
        & item_ok[:, None, None]

    # 4. select (min view id, starting, max view id)
    view_has = jnp.any(corr_ok, axis=-1)                     # [K,V]
    big = jnp.int32(10 ** 6)
    v1 = jnp.argmin(jnp.where(view_has, vids, big), axis=-1)   # [K]
    v2 = jnp.argmax(jnp.where(view_has, vids, -1), axis=-1)
    two_views = (jnp.sum(view_has, axis=-1) >= 2) & (v1 != v2)

    arK = jnp.arange(K)
    c1 = jax.tree.map(lambda a: a[arK, v1], corr)            # [K,M]
    c2 = jax.tree.map(lambda a: a[arK, v2], corr)
    c1_ok = corr_ok[arK, v1]
    c2_ok = corr_ok[arK, v2]

    # 5. triangulate all candidate pairs; unique valid seed required
    cams3 = jnp.stack([vs, v1, v2], axis=-1)                 # [K,3]
    P3 = P_mats[cams3]                                       # [K,3,3,4]
    pair_xy = jnp.stack([
        jnp.broadcast_to(s_xy[:, None, None, :], (K, M, M, 2)),
        jnp.broadcast_to(c1.xy[:, :, None, :], (K, M, M, 2)),
        jnp.broadcast_to(c2.xy[:, None, :, :], (K, M, M, 2)),
    ], axis=-2)                                              # [K,M,M,3,2]
    P_pairs = jnp.broadcast_to(P3[:, None, None], (K, M, M, 3, 3, 4))
    flat_xy = pair_xy.reshape(-1, 3, 2)
    flat_P = P_pairs.reshape(-1, 3, 3, 4)
    mask3 = jnp.ones(flat_xy.shape[:2], dtype=bool)
    X0 = triangulate_dlt(flat_P, flat_xy, mask3)
    X, mse, ok = gauss_newton_batched(
        flat_P, flat_xy, mask3, X0, max_iters=cfg.gn_max_iters,
        accept_mse=cfg.match_gn_max_mse, epsilon=cfg.gn_epsilon)
    X = X.reshape(K, M, M, 3)
    ok = ok.reshape(K, M, M) & c1_ok[:, :, None] & c2_ok[:, None, :] \
        & two_views[:, None, None]

    n_valid = jnp.sum(ok.reshape(K, -1), axis=-1)
    unique = n_valid == 1
    pick = jnp.argmax(ok.reshape(K, -1), axis=-1)
    i1 = pick // M
    i2 = pick % M
    seed_X = X.reshape(K, -1, 3)[arK, pick]
    seed_valid = unique & item_ok & two_views

    sel1 = jax.tree.map(lambda a: a[arK, i1], c1)
    sel2 = jax.tree.map(lambda a: a[arK, i2], c2)
    f = s_xy.dtype
    payload = jnp.concatenate([
        cams3.astype(f),
        jnp.stack([s_pl, sel1.pl_id, sel2.pl_id], -1).astype(f),
        jnp.stack([s_seg, sel1.seg, sel2.seg], -1).astype(f),
        jnp.stack([s_t, sel1.t, sel2.t], -1).astype(f),
        jnp.stack([s_xy, sel1.xy, sel2.xy], -2).reshape(K, 6),
        seed_X, ridx[:, None].astype(f)], axis=-1)           # [K,22]
    return compact_rows(seed_valid, payload, cap_out)


@partial(jax.jit, static_argnames=("M", "cfg", "cap_s", "cap_rows"))
def _seed_follow_fused(plg_coords, plg_length, grids, P_mats, F_table,
                       cell: float, obs_xy, obs_mask, start_mask,
                       M: int, cfg: EdgeGraphConfig, cap_s: int,
                       cap_rows: int):
    """Stage-3 round-0 megakernel: starting-intersection detection ->
    compacted correspondence/seeding -> bidirectional follow -> packed
    emission, all device-resident.

    Every blocking fetch stalls the dispatch queue, so fusing phases A+B of the reference's per-refpoint loop
    (plg_matching_from_refpoints.cpp:64-81 detection + consensus +
    follow) into ONE device program turns 2 dispatch/fetch pairs per
    chunk into one fetch, with the compacted seed buffer never leaving
    the device.  Seed-for-seed identical to the two-phase path
    (tests/test_refpoints_e2e.py::test_fused_path_matches_two_phase).

    Returns (rows_buf [cap_rows, 11], n_rows, extra) where extra is the
    flat concat of [meta (cap_s*40), seed_buf (cap_s*22),
    n_starts, n_seeds]."""
    from edgegraph3d_tpu.matching import following

    sbuf, ns = _start_sweep(plg_coords, grids, cell, obs_xy, start_mask,
                            cfg.detection_starting_dist_px, M, cap_s)
    buf, n_seeds = _seed_from_starts(
        plg_coords, plg_length, grids, P_mats, F_table, cell, sbuf, ns,
        obs_xy, obs_mask, M, cfg, cap_s)
    seeds = following.SeedTuple(
        cams=buf[:, 0:3].astype(jnp.int32),
        pl_id=buf[:, 3:6].astype(jnp.int32),
        seg=buf[:, 6:9].astype(jnp.int32),
        t=buf[:, 9:12],
        xy=buf[:, 12:18].reshape(cap_s, 3, 2),
        X=buf[:, 18:21],
        valid=jnp.arange(cap_s) < n_seeds)
    fwd, bwd, _ = following.follow_seeds_bidirectional(
        seeds, plg_coords, plg_length, P_mats, F_table, cfg,
        cfg.max_follow_steps)
    rows, n_emit, meta = following.pack_follow_outputs(
        fwd, bwd, seeds.valid, cfg.new_point_min_steps, cap_rows)
    f = buf.dtype
    extra = jnp.concatenate([
        jnp.ravel(meta).astype(f), jnp.ravel(buf),
        jnp.reshape(ns, (1,)).astype(f),
        jnp.reshape(n_seeds, (1,)).astype(f)])
    return rows, n_emit, extra


def compute_and_follow_seeds(sfmd: SfMData, ctx: MatchingContext,
                             refpoint_chunk: int = 256,
                             max_starting_views: int | None = None):
    """Pipelined fused phase A+B: every chunk's megakernel is ENQUEUED
    before any result is fetched (JAX dispatch is async), so device
    compute and the fetches overlap across chunks; each
    chunk then costs exactly one blocking fetch.

    Returns (round0 list of (seed_lo, chunk_dict, rows, meta),
    n_seeds_total) for sweep_seeds(precomputed=...), or (None, 0)."""
    cfg = ctx.config
    M = cfg.max_candidates_per_view
    obs_xy, obs_mask = dense_observations(sfmd)
    N = len(obs_xy)
    cap_chunk = 1024 if jax.default_backend() != "cpu" else refpoint_chunk
    refpoint_chunk = min(cap_chunk, max(refpoint_chunk,
                                        1 << max(N - 1, 1).bit_length()))
    start_mask = obs_mask.copy()
    if max_starting_views is not None:
        cum = np.cumsum(obs_mask, axis=1)
        start_mask &= cum <= max_starting_views

    # size the chunk so EXPECTED starts stay near one pow2 seed-buffer
    # capacity (~2 real candidates per allowed starting view, the
    # measured density; the count-checked fallback below is exact on
    # under-estimates).  With uncapped starting views (the reference's
    # all-viewing-cams loop, plg_matching_from_refpoints.cpp:64-81) a
    # refpoint contributes ~V starts, so full-scale scenes take many
    # small pipelined chunks instead of one overflowing monster.
    svr = float(start_mask.sum(axis=1).mean()) if N else 1.0
    est_per_ref = max(1.0, 2.0 * svr)
    # accelerators amortize the walk's serial per-iteration overhead
    # over wide chunks (the 49-view run spent 191 s on 98 narrow
    # chunks); CPU keeps narrow chunks — its lockstep while_loop wastes
    # work on the slowest lane
    seed_target = 16384 if jax.default_backend() != "cpu" else 4096
    fit = max(64, int(seed_target / est_per_ref))
    refpoint_chunk = min(refpoint_chunk,
                         1 << max(fit - 1, 1).bit_length())

    from edgegraph3d_tpu.ops.compaction import to_host_with_extra
    V = obs_mask.shape[1]
    full = refpoint_chunk * V * M
    est = int(est_per_ref * refpoint_chunk)
    cap_s = min(full, max(1024, 1 << max(est - 1, 1).bit_length()))
    cap_rows = 32 * cap_s
    pend = []
    for lo in range(0, N, refpoint_chunk):
        hi = min(lo + refpoint_chunk, N)
        pad = refpoint_chunk - (hi - lo)
        ox = jnp.asarray(np.pad(obs_xy[lo:hi],
                                ((0, pad), (0, 0), (0, 0))))
        om = jnp.asarray(np.pad(obs_mask[lo:hi], ((0, pad), (0, 0))))
        sm = jnp.asarray(np.pad(start_mask[lo:hi], ((0, pad), (0, 0))))
        out = _seed_follow_fused(
            ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
            ctx.F_table, ctx.cell, ox, om, sm, M, cfg, cap_s, cap_rows)
        pend.append((lo, ox, om, sm, out))

    round0 = []
    seed_lo = 0
    for lo, ox, om, sm, (rows_buf, n_emit, extra) in pend:
        rows, n_rows, extra_np = to_host_with_extra(rows_buf, n_emit,
                                                    extra)
        meta = extra_np[: cap_s * 40].reshape(cap_s, 40)
        sbuf = extra_np[cap_s * 40: cap_s * 62].reshape(cap_s, 22)
        ns = int(extra_np[cap_s * 62])
        n_seeds = int(extra_np[cap_s * 62 + 1])
        if ns > cap_s or n_rows > cap_rows or meta[0, _M_GNOVF] > 0:
            # rare dense chunk: redo this chunk at full width through
            # the two-phase path (same math; overflow-exact — covers
            # start/seed-buffer, emission, AND compacted-GN overflow)
            rows, meta, sbuf, n_seeds = _fused_fallback_full(
                ctx, ox, om, sm, M, cfg, full)
        if n_seeds == 0:
            continue
        chunk = _chunk_from_seed_buf(sbuf[:n_seeds], lo)
        round0.append((seed_lo, chunk, rows, meta[:n_seeds]))
        seed_lo += n_seeds
    return (round0 if round0 else None), seed_lo


def _chunk_from_seed_buf(sbuf: np.ndarray, refpoint_lo: int) -> dict:
    """[n, 22] packed seed rows -> the chunk dict sweep_seeds uses."""
    return dict(
        cams=sbuf[:, 0:3].astype(np.int32),
        pl_id=sbuf[:, 3:6].astype(np.int32),
        seg=sbuf[:, 6:9].astype(np.int32),
        t=sbuf[:, 9:12],
        xy=sbuf[:, 12:18].reshape(-1, 3, 2),
        X=sbuf[:, 18:21],
        _ref=refpoint_lo + sbuf[:, 21].astype(np.int64))


def _follow_seed_rows(ctx, sbuf: np.ndarray, n_seeds: int):
    """Host-side FULL-WIDTH follow of packed [*, 22] seed rows: pad to
    pow2, follow bidirectionally (gn_cap = exact S*T — no compacted-GN
    cap on this path), pack, fetch.  Shared overflow path of the fused
    sweeps."""
    from edgegraph3d_tpu.matching import following
    from edgegraph3d_tpu.ops.compaction import to_host_with_extra
    cfg = ctx.config
    Sp = 1 << max(n_seeds - 1, 1).bit_length()
    pad = Sp - n_seeds
    sb = np.pad(sbuf[:n_seeds], ((0, pad), (0, 0)))
    seeds = following.SeedTuple(
        cams=jnp.asarray(sb[:, 0:3].astype(np.int32)),
        pl_id=jnp.asarray(sb[:, 3:6].astype(np.int32)),
        seg=jnp.asarray(sb[:, 6:9].astype(np.int32)),
        t=jnp.asarray(sb[:, 9:12]),
        xy=jnp.asarray(sb[:, 12:18].reshape(-1, 3, 2)),
        X=jnp.asarray(sb[:, 18:21]),
        valid=jnp.asarray(np.arange(Sp) < n_seeds))
    fwd, bwd, _ = following.follow_seeds_bidirectional(
        seeds, ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table,
        cfg, cfg.max_follow_steps,
        gn_cap=2 * Sp * cfg.max_follow_steps)
    cap = 2 * Sp * cfg.max_follow_steps
    buf2, n_emit, meta = following.pack_follow_outputs(
        fwd, bwd, seeds.valid, cfg.new_point_min_steps, cap)
    rows, n_rows, meta_np = to_host_with_extra(buf2, n_emit, meta)
    return rows, meta_np[:n_seeds]


def _fused_fallback_full(ctx, ox, om, sm, M, cfg, full):
    """Overflow path of the fused sweep: full-width two-phase kernels +
    a full-width follow/pack (counted, never silently truncating)."""
    from edgegraph3d_tpu.ops.compaction import to_host
    sbuf_d, ns_d = _start_sweep(
        ctx.plg_coords, ctx.grids, ctx.cell, ox, sm,
        cfg.detection_starting_dist_px, M, full)
    buf_d, n_d = _seed_from_starts(
        ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
        ctx.F_table, ctx.cell, sbuf_d, ns_d, ox, om, M, cfg, full)
    sbuf, n_seeds = to_host(buf_d, n_d)
    if n_seeds == 0:
        return np.zeros((0, 11)), np.zeros((0, _M_COLS)), sbuf, 0
    rows, meta = _follow_seed_rows(ctx, sbuf, n_seeds)
    return rows, meta, sbuf, n_seeds


# ----------------------------------------------------------------------
# Full stage-3 driver
# ----------------------------------------------------------------------

@dataclass
class EdgePoints:
    """Host-side reconstruction result.

    (seed_id, chain_order) identify the swept 3D chains: points of one
    seed sorted by chain_order form a 3D polyline (backward sweep,
    seed point, forward sweep)."""
    X: np.ndarray          # [M,3]
    obs_xy: np.ndarray     # [M,V,2]
    obs_mask: np.ndarray   # [M,V]
    seed_refpoint: np.ndarray  # [M] originating refpoint id
    seed_id: np.ndarray = None       # [M] global seed index
    chain_order: np.ndarray = None   # [M] order along the chain

    def __post_init__(self):
        if self.seed_id is None:
            self.seed_id = np.zeros(len(self.X), np.int64)
        if self.chain_order is None:
            self.chain_order = np.zeros(len(self.X), np.int64)

    def select(self, keep: np.ndarray) -> "EdgePoints":
        return EdgePoints(X=self.X[keep], obs_xy=self.obs_xy[keep],
                          obs_mask=self.obs_mask[keep],
                          seed_refpoint=self.seed_refpoint[keep],
                          seed_id=self.seed_id[keep],
                          chain_order=self.chain_order[keep])


def _empty_points(V: int) -> EdgePoints:
    return EdgePoints(X=np.zeros((0, 3)), obs_xy=np.zeros((0, V, 2)),
                      obs_mask=np.zeros((0, V), bool),
                      seed_refpoint=np.zeros(0, np.int64))


@partial(jax.jit, static_argnames=("cap",))
def _pack_seed_outputs(out: dict, cap: int):
    """Compact valid seeds on device into one [cap, 22] buffer:
    [cams(3), pl_id(3), seg(3), t(3), xy(6), X(3), refpoint_row(1)].
    See ops/compaction.py for why (fewer, smaller fetches)."""
    from edgegraph3d_tpu.ops.compaction import compact_rows
    N, V, M = out["valid"].shape
    f = out["xy"].dtype
    ridx = jnp.broadcast_to(jnp.arange(N, dtype=f)[:, None, None],
                            (N, V, M))
    payload = jnp.concatenate([
        out["cams"].astype(f), out["pl_id"].astype(f),
        out["seg"].astype(f), out["t"].astype(f),
        out["xy"].reshape(N, V, M, 6), out["X"],
        ridx[..., None]], axis=-1).reshape(N * V * M, 22)
    return compact_rows(out["valid"].reshape(-1), payload, cap)


def compute_seeds(sfmd: SfMData, ctx: MatchingContext,
                  refpoint_chunk: int = 256,
                  max_starting_views: int | None = None):
    """Phase A: form + host-compact seeds for all refpoints."""
    cfg = ctx.config
    M = cfg.max_candidates_per_view
    obs_xy, obs_mask = dense_observations(sfmd)
    N = len(obs_xy)
    # adaptive chunk: one dispatch when the workload fits (each chunk
    # costs ~4 blocking fetches); pow2-bucketed for compile
    # reuse, capped so huge scenes still stream.  On the CPU backend
    # dispatches are cheap and big lockstep chunks WASTE work (the
    # early-exit while_loop runs to the slowest seed), so the cap stays
    # at the small default there.
    cap_chunk = 1024 if jax.default_backend() != "cpu" else refpoint_chunk
    refpoint_chunk = min(cap_chunk, max(refpoint_chunk,
                                        1 << max(N - 1, 1).bit_length()))
    refpoint_chunk = -(-refpoint_chunk // ctx.n_shards) * ctx.n_shards
    start_mask = obs_mask.copy()
    if max_starting_views is not None:
        cum = np.cumsum(obs_mask, axis=1)
        start_mask &= cum <= max_starting_views

    seeds_acc = {k: [] for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
    seed_ref = []
    for lo in range(0, N, refpoint_chunk):
        hi = min(lo + refpoint_chunk, N)
        pad = refpoint_chunk - (hi - lo)
        ox = np.pad(obs_xy[lo:hi], ((0, pad), (0, 0), (0, 0)))
        om = np.pad(obs_mask[lo:hi], ((0, pad), (0, 0)))
        sm = np.pad(start_mask[lo:hi], ((0, pad), (0, 0)))
        from edgegraph3d_tpu.ops.compaction import to_host
        if ctx.mesh is not None:
            # same two-kernel compacted path as single-device, with the
            # refpoint axis sharded over the mesh; the compacted start
            # buffers stay device-local between kernels A and B
            from edgegraph3d_tpu.parallel import sharded
            nd = ctx.n_shards
            Nd = refpoint_chunk // nd
            full_d = Nd * obs_mask.shape[1] * M
            cap_d = min(4 * Nd, full_d)
            sbuf, ns = sharded.sharded_start_sweep(
                ctx.mesh, ctx.plg_coords, ctx.grids, ctx.cell,
                jnp.asarray(ox), jnp.asarray(sm),
                cfg.detection_starting_dist_px, M, cap_d)
            from edgegraph3d_tpu.ops.compaction import fetch_global
            if (fetch_global(ns) > cap_d).any():  # dense block: full width
                cap_d = full_d
                sbuf, ns = sharded.sharded_start_sweep(
                    ctx.mesh, ctx.plg_coords, ctx.grids, ctx.cell,
                    jnp.asarray(ox), jnp.asarray(sm),
                    cfg.detection_starting_dist_px, M, cap_d)
            buf, n = sharded.sharded_seed_from_starts(
                ctx.mesh, ctx.plg_coords, ctx.plg_length, ctx.grids,
                ctx.P_mats, ctx.F_table, ctx.cell, sbuf, ns,
                jnp.asarray(ox), jnp.asarray(om), M, cfg, cap_d)
            bufs = fetch_global(buf).reshape(nd, cap_d, 22)
            n_dev = np.minimum(fetch_global(n), cap_d)
            rows = np.concatenate([bufs[d, : n_dev[d]]
                                   for d in range(nd)])
            # refpoint-row column is local to the device block
            rows[:, 21] += np.repeat(np.arange(nd) * Nd, n_dev)
            n_int = len(rows)
        else:
            # compacted two-kernel fast path (see _start_sweep docstring)
            full = refpoint_chunk * obs_mask.shape[1] * M
            cap_s = min(4 * refpoint_chunk, full)
            sbuf, ns = _start_sweep(
                ctx.plg_coords, ctx.grids, ctx.cell, jnp.asarray(ox),
                jnp.asarray(sm), cfg.detection_starting_dist_px, M, cap_s)
            from edgegraph3d_tpu.ops.compaction import \
                to_host_with_extra
            buf, n = _seed_from_starts(
                ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
                ctx.F_table, ctx.cell, sbuf, ns, jnp.asarray(ox),
                jnp.asarray(om), M, cfg, cap_s)
            # fetch the start count alongside the seed rows; redo both
            # kernels at full width only on the (counted) overflow
            rows, n_int, ns_np = to_host_with_extra(
                buf, n, jnp.reshape(ns, (1,)))
            if int(ns_np[0]) > cap_s:  # dense chunk: recompact full
                cap_s = full
                sbuf, ns = _start_sweep(
                    ctx.plg_coords, ctx.grids, ctx.cell, jnp.asarray(ox),
                    jnp.asarray(sm), cfg.detection_starting_dist_px, M,
                    cap_s)
                buf, n = _seed_from_starts(
                    ctx.plg_coords, ctx.plg_length, ctx.grids,
                    ctx.P_mats, ctx.F_table, ctx.cell, sbuf, ns,
                    jnp.asarray(ox), jnp.asarray(om), M, cfg, cap_s)
                rows, n_int = to_host(buf, n)
        if n_int == 0:
            continue
        seeds_acc["cams"].append(rows[:, 0:3].astype(np.int32))
        seeds_acc["pl_id"].append(rows[:, 3:6].astype(np.int32))
        seeds_acc["seg"].append(rows[:, 6:9].astype(np.int32))
        seeds_acc["t"].append(rows[:, 9:12])
        seeds_acc["xy"].append(rows[:, 12:18].reshape(-1, 3, 2))
        seeds_acc["X"].append(rows[:, 18:21])
        seed_ref.append(lo + rows[:, 21].astype(np.int64))

    if not seed_ref:
        return None, None
    seeds_np = {k: np.concatenate(v) for k, v in seeds_acc.items()}
    return seeds_np, np.concatenate(seed_ref)


def _resolve_claims(ctx: MatchingContext, manager, *args,
                    skip_start_check: bool = False):
    """Dispatch claiming to the configured backend (config.claiming_backend):
    host-sequential numpy or the device fixpoint kernel with the
    cross-device pmin merge (matching/claiming_device.py)."""
    if ctx.config.claiming_backend == "device":
        from edgegraph3d_tpu.matching import claiming_device
        return claiming_device.apply_device_claiming(
            manager, *args, skip_start_check=skip_start_check,
            mesh=ctx.mesh)
    return manager.resolve_and_claim(
        *args, skip_start_check=skip_start_check)


# pack_follow_outputs meta column layout (following.py)
_M_TOTAL = 0
_M_FSEG, _M_FT = slice(1, 4), slice(4, 7)
_M_BSEG, _M_BT = slice(7, 10), slice(10, 13)
_M_FNS, _M_BNS = 13, 14
_M_FXY, _M_BXY = slice(15, 21), slice(21, 27)
_M_FPERM, _M_FDIRS = slice(27, 30), slice(30, 33)
_M_BPERM, _M_BDIRS = slice(33, 36), slice(36, 39)
_M_GNOVF = 39     # compacted-GN overflow (broadcast; >0 => redo full)
_M_COLS = 40


def sweep_seeds(seeds_np: dict, seed_ref: np.ndarray,
                ctx: MatchingContext,
                manager: "matches_mod.MatchesManager",
                seed_chunk: int = 2048, seed_id_offset: int = 0,
                max_continuation_rounds: int = 8,
                precomputed: list | None = None):
    """Phase B shared by all stages: follow all seeds bidirectionally,
    resolve collisions POST-HOC in seed-index order against `manager`
    (a seed is suppressed only by arcs of ACCEPTED matches, exactly the
    reference's sequential interval skip — polyline_matching.cpp:173-190),
    claim accepted arcs, and collect the emitted chain points.

    Chains that hit `max_follow_steps` are continued from their final
    position in follow-up rounds with the direction configuration
    pinned (SURVEY §7 hard-part 1: "chains longer than the bound
    continue in a next sweep round"; parity target: the unbounded while
    at plg_matching.cpp:765-795).

    With `precomputed` (list of (seed_lo, chunk, rows, meta) from
    compute_and_follow_seeds) round 0's follow dispatches are skipped —
    the fused megakernel already ran them — and this function only does
    the host half: claim resolution, collection, continuations.

    Returns (X, obs3, cams3, refs, seed_ids, orders) or None."""
    cfg = ctx.config
    S = (len(seed_ref) if precomputed is None
         else sum(len(c["_ref"]) for _, c, _, _ in precomputed))
    # adaptive chunk (see compute_seeds): fewer dispatches, pow2 shapes
    cap_chunk = 4096 if jax.default_backend() != "cpu" else seed_chunk
    seed_chunk = min(cap_chunk, max(seed_chunk,
                                    1 << max(S - 1, 1).bit_length()))
    seed_chunk = -(-seed_chunk // ctx.n_shards) * ctx.n_shards

    all_X, all_obs3, all_cams3, all_ref = [], [], [], []
    all_seed, all_order = [], []

    def run_follow(chunk: dict, valid_np, fixed_perm=None,
                   fixed_dirs=None, min_steps=None):
        """Follow one padded chunk; returns (rows, meta) numpy."""
        pad = seed_chunk - len(valid_np)

        def padded(a, fill=0):
            return jnp.asarray(np.pad(
                a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                constant_values=fill))
        seeds = following.SeedTuple(
            cams=padded(chunk["cams"]), pl_id=padded(chunk["pl_id"]),
            seg=padded(chunk["seg"]), t=padded(chunk["t"]),
            xy=padded(chunk["xy"]), X=padded(chunk["X"]),
            valid=jnp.asarray(np.pad(valid_np, (0, pad))))

        def follow(gn_cap):
            # the sharded walks take the PER-DEVICE width (seed_chunk is
            # a multiple of the shard count)
            gn_dev = None if gn_cap is None else gn_cap // ctx.n_shards
            if fixed_perm is None:
                if ctx.mesh is not None:
                    from edgegraph3d_tpu.parallel import sharded
                    fwd, bwd, _ = sharded.sharded_follow_bidirectional(
                        ctx.mesh, seeds, ctx.plg_coords, ctx.plg_length,
                        ctx.P_mats, ctx.F_table, cfg,
                        cfg.max_follow_steps, gn_cap=gn_dev)
                else:
                    fwd, bwd, _ = following.follow_seeds_bidirectional(
                        seeds, ctx.plg_coords, ctx.plg_length,
                        ctx.P_mats, ctx.F_table, cfg,
                        cfg.max_follow_steps, gn_cap=gn_cap)
                return fwd, bwd
            fp = padded(fixed_perm)
            fd = padded(fixed_dirs)
            if ctx.mesh is not None:
                from edgegraph3d_tpu.parallel import sharded
                fwd = sharded.sharded_follow_fixed(
                    ctx.mesh, seeds, ctx.plg_coords, ctx.plg_length,
                    ctx.P_mats, ctx.F_table, cfg, cfg.max_follow_steps,
                    fp, fd, gn_cap=gn_dev)
            else:
                fwd = following.follow_seeds(
                    seeds, ctx.plg_coords, ctx.plg_length, ctx.P_mats,
                    ctx.F_table, jnp.int32(1), cfg,
                    cfg.max_follow_steps, fixed_perm=fp, fixed_dirs=fd,
                    gn_cap=gn_cap)
            return fwd, following.dead_follow_result(fwd, seeds)

        from edgegraph3d_tpu.ops.compaction import to_host_with_extra
        ms = cfg.new_point_min_steps if min_steps is None else min_steps

        def pack_fetch(fwd, bwd, cap):
            buf, n_emit, meta = following.pack_follow_outputs(
                fwd, bwd, seeds.valid, ms, cap)
            # rows + count + meta in ONE device->host round trip
            return to_host_with_extra(buf, n_emit, meta)

        cap = 32 * seed_chunk
        fwd, bwd = follow(None)
        rows, n_int, meta_np = pack_fetch(fwd, bwd, cap)
        if meta_np[0, _M_GNOVF] > 0:
            # compacted-GN overflow (counted, never silent): redo the
            # follow with the exact full-width GN
            lanes = seed_chunk if fixed_perm is not None \
                else 2 * seed_chunk
            fwd, bwd = follow(lanes * cfg.max_follow_steps)
            rows, n_int, meta_np = pack_fetch(fwd, bwd, cap)
        if n_int > cap:
            # dense chunk: repack at full width (2 directions x S x T)
            cap = 2 * seed_chunk * cfg.max_follow_steps
            rows, n_int, meta_np = pack_fetch(fwd, bwd, cap)
        return rows, meta_np[: len(valid_np)]

    def queue_continuations(pending, chunk, meta, accept, seed_gid,
                            order_base_f, order_base_b, first_round,
                            sign_map=None):
        """Collect truncated directions for the next round.  In
        continuation rounds only the fwd half runs (the call is
        direction-pinned), and the new entry inherits the parent's
        chain-order sign."""
        T = cfg.max_follow_steps
        for half, ns_col, seg_sl, t_sl, xy_sl, perm_sl, dirs_sl, base in (
            (1, _M_FNS, _M_FSEG, _M_FT, _M_FXY, _M_FPERM, _M_FDIRS,
             order_base_f),
            (-1, _M_BNS, _M_BSEG, _M_BT, _M_BXY, _M_BPERM, _M_BDIRS,
             order_base_b),
        ):
            if not first_round and half < 0:
                continue     # continuation rounds only run the fwd half
            trunc = accept & (meta[:, ns_col] >= T)
            for i in np.flatnonzero(trunc):
                sign = half if sign_map is None else int(sign_map[i])
                pending.append(dict(
                    cams=chunk["cams"][i], pl_id=chunk["pl_id"][i],
                    seg=meta[i, seg_sl].astype(np.int32),
                    t=meta[i, t_sl].astype(chunk["t"].dtype),
                    xy=meta[i, xy_sl].reshape(3, 2),
                    X=chunk["X"][i],
                    perm=meta[i, perm_sl].astype(np.int32),
                    dirs=meta[i, dirs_sl].astype(np.int32),
                    sign=sign, gid=seed_gid[i],
                    ref=chunk["_ref"][i],
                    base=base[i] + int(meta[i, ns_col])))
        manager.counters["chains_truncated"] += int(
            (accept & ((meta[:, _M_FNS] >= T)
                       | (meta[:, _M_BNS] >= T))).sum())

    def collect_rows(rows, chunk, seed_gid, accept, sign_map, base_f,
                     base_b):
        if len(rows) == 0:
            return
        sidx = rows[:, 9].astype(np.int64)
        keep = accept[sidx]
        rows = rows[keep]
        sidx = sidx[keep]
        order = rows[:, 10].astype(np.int64)
        fwd_rows = order > 0
        sign = np.where(fwd_rows, sign_map[sidx], -sign_map[sidx])
        base = np.where(fwd_rows, base_f[sidx], base_b[sidx])
        all_X.append(rows[:, 0:3].astype(np.float64))
        all_obs3.append(rows[:, 3:9].reshape(-1, 3, 2))
        all_cams3.append(chunk["cams"][sidx])
        all_ref.append(chunk["_ref"][sidx])
        all_seed.append(seed_gid[sidx])
        all_order.append(sign * (base + np.abs(order)))

    # ---- round 0: fresh seeds, bidirectional, full resolve
    pending = []
    if precomputed is None:
        round0 = []
        for lo in range(0, S, seed_chunk):
            hi = min(lo + seed_chunk, S)
            chunk = {k: v[lo:hi] for k, v in seeds_np.items()}
            chunk["_ref"] = seed_ref[lo:hi]
            rows, meta = run_follow(chunk, np.ones(hi - lo, bool))
            round0.append((lo, chunk, rows, meta))
    else:
        round0 = precomputed
    for lo, chunk, rows, meta in round0:
        n = len(chunk["_ref"])
        hi = lo + n
        success = meta[:, _M_TOTAL] >= cfg.new_point_min_steps
        accept = _resolve_claims(
            ctx, manager, success, chunk["cams"], chunk["pl_id"],
            chunk["seg"], chunk["t"],
            meta[:, _M_FSEG].astype(np.int64), meta[:, _M_FT],
            meta[:, _M_BSEG].astype(np.int64), meta[:, _M_BT])
        gid = np.arange(lo, hi) + seed_id_offset
        zeros = np.zeros(n, np.int64)
        ones = np.ones(n, np.int64)
        collect_rows(rows, chunk, gid, accept, ones, zeros, zeros)
        # the seed points themselves (order 0)
        ks = np.flatnonzero(accept)
        if len(ks):
            all_X.append(chunk["X"][ks])
            all_obs3.append(chunk["xy"][ks])
            all_cams3.append(chunk["cams"][ks])
            all_ref.append(chunk["_ref"][ks])
            all_seed.append(gid[ks])
            all_order.append(np.zeros(len(ks), np.int64))
        queue_continuations(pending, chunk, meta, accept, gid,
                            zeros, zeros, first_round=True)

    # ---- continuation rounds (direction pinned, start check skipped:
    # the chain's own claim covers its final position)
    rnd = 0
    while pending and rnd < max_continuation_rounds:
        rnd += 1
        manager.counters["continuation_rounds"] = max(
            manager.counters["continuation_rounds"], rnd)
        entries, pending = pending, []
        for lo in range(0, len(entries), seed_chunk):
            batch = entries[lo:lo + seed_chunk]
            n = len(batch)
            chunk = {k: np.stack([e[k] for e in batch])
                     for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
            chunk["_ref"] = np.asarray([e["ref"] for e in batch])
            perm = np.stack([e["perm"] for e in batch])
            dirs = np.stack([e["dirs"] for e in batch])
            gid = np.asarray([e["gid"] for e in batch])
            sign_map = np.asarray([e["sign"] for e in batch])
            base = np.asarray([e["base"] for e in batch])
            rows, meta = run_follow(chunk, np.ones(n, bool),
                                    fixed_perm=perm, fixed_dirs=dirs,
                                    min_steps=1)
            success = meta[:, _M_TOTAL] >= 1
            accept = _resolve_claims(
                ctx, manager, success, chunk["cams"], chunk["pl_id"],
                chunk["seg"], chunk["t"],
                meta[:, _M_FSEG].astype(np.int64), meta[:, _M_FT],
                meta[:, _M_BSEG].astype(np.int64), meta[:, _M_BT],
                skip_start_check=True)
            collect_rows(rows, chunk, gid, accept, sign_map, base,
                         base)
            queue_continuations(pending, chunk, meta, accept, gid,
                                base, base, first_round=False,
                                sign_map=sign_map)

    if not all_X:
        return None

    # emit in one fixed order — by seed id, then by signed position
    # along the seed's chain, backward end first — so the result does not depend on how seeds were
    # chunked (the chunk widths differ by backend and between the
    # single-device and mesh drivers, and the density filter downstream
    # keeps points first-come).  The reference inserts from an OpenMP
    # loop over refpoints, so it fixes no order this one could follow.
    seed = np.concatenate(all_seed)
    order = np.concatenate(all_order)
    perm = np.lexsort((order, seed))
    return (np.concatenate(all_X)[perm], np.concatenate(all_obs3)[perm],
            np.concatenate(all_cams3)[perm], np.concatenate(all_ref)[perm],
            seed[perm], order[perm])


def expand_and_assemble(ctx: MatchingContext, X, obs3, cams3, refs,
                        seed_ids, orders,
                        chain_t: int = 64) -> EdgePoints:
    """Phase C shared by all stages: chain-aware expansion of every
    swept chain to all other views with GN re-validation (parity:
    expand_allpoints_to_other_view_using_plmap, triangulation.cpp:742-919
    + em_add_new_observation_to_3Dpositions re-refinement :347-466 —
    see matching/expansion.py for the batched formulation), then EdgePoints
    assembly.  Point coordinates take the per-view re-refined values."""
    from edgegraph3d_tpu.matching import expansion

    cfg = ctx.config
    V = ctx.P_mats.shape[0]
    Np = len(X)
    if Np == 0:
        return _empty_points(V)
    gather, vld = expansion.group_chains(seed_ids, orders, max_t=chain_t)
    C = len(gather)
    obs_xy = np.zeros((Np, V, 2), dtype=np.float32)
    obs_mask = np.zeros((Np, V), dtype=bool)
    X_out = np.asarray(X, np.float64).copy()
    X32 = np.asarray(X, np.float32)
    obs3_32 = np.asarray(obs3, np.float32)
    # adaptive chunk (see compute_seeds): fewer dispatches, pow2 shapes.
    # 4096 chains/chunk on accelerators: the round-4 full-scale run cut
    # ~50k chains into 1024-chain chunks and the per-chunk fetches
    # ballooned device_fetches to 85 (VERDICT r4 weak #2)
    cap_chunk = 4096 if jax.default_backend() != "cpu" else 256
    chunk = min(cap_chunk, max(256, 1 << max(C - 1, 1).bit_length()))
    chunk = -(-chunk // ctx.n_shards) * ctx.n_shards

    if ctx.mesh is None:
        # compacted fast path, PIPELINED: every chunk's kernel is
        # enqueued before any result is fetched, so device compute and
        # transfers overlap (see expansion.expand_chains_compact
        # for the kernel)
        pend = []
        for lo in range(0, C, chunk):
            hi = min(lo + chunk, C)
            pad = chunk - (hi - lo)
            gi = np.pad(gather[lo:hi], ((0, pad), (0, 0)))
            vl = np.pad(vld[lo:hi], ((0, pad), (0, 0)))
            cm = jnp.asarray(cams3[gi[:, 0]].astype(np.int32))
            kidx = np.flatnonzero(vl.reshape(-1))
            rows = gi.reshape(-1)[kidx]
            n_k = len(kidx)
            K = chunk * chain_t // 4
            if n_k > K:
                K = chunk * chain_t
            pad_k = K - n_k
            # padding rows scatter out of bounds -> dropped by the
            # kernel's mode="drop" scatters
            ci = np.pad((kidx // chain_t).astype(np.int32), (0, pad_k),
                        constant_values=chunk)
            ti = np.pad((kidx % chain_t).astype(np.int32), (0, pad_k),
                        constant_values=chain_t)
            Xr, oxy, ook, _ = expansion.expand_chains_compact(
                ctx.plg_coords, ctx.grids, ctx.P_mats, ctx.F_table,
                ctx.cell,
                jnp.asarray(np.pad(X32[rows], ((0, pad_k), (0, 0)))),
                jnp.asarray(np.pad(obs3_32[rows],
                                   ((0, pad_k), (0, 0), (0, 0)))),
                cm, jnp.asarray(ci), jnp.asarray(ti),
                jnp.asarray(np.arange(K) < n_k), jnp.asarray(vl), cfg,
                chunk, chain_t)
            packed_dev = jnp.concatenate(
                [Xr, oxy.reshape(K, V * 2),
                 ook.astype(Xr.dtype).reshape(K, V)], axis=1)
            pend.append((rows, n_k, packed_dev))
        from edgegraph3d_tpu.ops.compaction import fetch
        for rows, n_k, packed_dev in pend:
            sel = fetch(packed_dev)[:n_k]
            X_out[rows] = sel[:, :3]
            obs_xy[rows] = sel[:, 3:3 + 2 * V].reshape(-1, V, 2)
            obs_mask[rows] = sel[:, 3 + 2 * V:] > 0.5
        return EdgePoints(X=X_out, obs_xy=obs_xy, obs_mask=obs_mask,
                          seed_refpoint=refs, seed_id=seed_ids,
                          chain_order=orders)

    for lo in range(0, C, chunk):
        hi = min(lo + chunk, C)
        pad = chunk - (hi - lo)
        gi = np.pad(gather[lo:hi], ((0, pad), (0, 0)))
        vl = np.pad(vld[lo:hi], ((0, pad), (0, 0)))
        cm = jnp.asarray(cams3[gi[:, 0]].astype(np.int32))
        if ctx.mesh is not None:
            # chains partitioned over devices (contiguous blocks), each
            # device running the same compacted kernel as single-device
            from edgegraph3d_tpu.parallel import sharded
            nd = ctx.n_shards
            Cd = chunk // nd
            vl_dev = vl.reshape(nd, Cd, chain_t)
            kidx_dev = [np.flatnonzero(vl_dev[d].reshape(-1))
                        for d in range(nd)]
            Kd = Cd * chain_t // 4
            if max((len(k) for k in kidx_dev), default=0) > Kd:
                Kd = Cd * chain_t
            Xd = np.zeros((nd, Kd, 3), np.float32)
            o3d = np.zeros((nd, Kd, 3, 2), np.float32)
            cid = np.full((nd, Kd), Cd, np.int32)      # pads OOB
            tid = np.full((nd, Kd), chain_t, np.int32)
            iok = np.zeros((nd, Kd), bool)
            rows_dev = []
            gi_flat = gi.reshape(nd, Cd * chain_t)
            for d in range(nd):
                k = kidx_dev[d]
                nk = len(k)
                rd = gi_flat[d][k]
                Xd[d, :nk] = X32[rd]
                o3d[d, :nk] = obs3_32[rd]
                cid[d, :nk] = (k // chain_t).astype(np.int32)
                tid[d, :nk] = (k % chain_t).astype(np.int32)
                iok[d, :nk] = True
                rows_dev.append(rd)
            Xr, oxy, ook, _ = sharded.sharded_expand_compact(
                ctx.mesh, ctx.plg_coords, ctx.grids, ctx.P_mats,
                ctx.F_table, ctx.cell, jnp.asarray(Xd.reshape(nd * Kd, 3)),
                jnp.asarray(o3d.reshape(nd * Kd, 3, 2)), cm,
                jnp.asarray(cid.reshape(-1)),
                jnp.asarray(tid.reshape(-1)),
                jnp.asarray(iok.reshape(-1)), jnp.asarray(vl), cfg,
                Cd, chain_t)
            from edgegraph3d_tpu.ops.compaction import fetch_global
            packed = fetch_global(jnp.concatenate(
                [Xr, oxy.reshape(nd * Kd, V * 2),
                 ook.astype(Xr.dtype).reshape(nd * Kd, V)],
                axis=1)).reshape(nd, Kd, 3 + 3 * V)
            rows = np.concatenate(rows_dev) if rows_dev else \
                np.zeros(0, np.int64)
            sel = np.concatenate(
                [packed[d, : len(kidx_dev[d])] for d in range(nd)]) \
                if rows_dev else packed.reshape(0, 3 + 3 * V)
        X_out[rows] = sel[:, :3]
        obs_xy[rows] = sel[:, 3:3 + 2 * V].reshape(-1, V, 2)
        obs_mask[rows] = sel[:, 3 + 2 * V:] > 0.5

    return EdgePoints(X=X_out, obs_xy=obs_xy, obs_mask=obs_mask,
                      seed_refpoint=refs, seed_id=seed_ids,
                      chain_order=orders)


# ----------------------------------------------------------------------
# Chain extension from the expanded view set
# ----------------------------------------------------------------------

@jax.jit
def _locate_on_polylines(plg_coords, plg_length, grids, cell, xy_ev,
                         dir_ev, reanchor_tol):
    """Per (end, view): closest polyline position plus the REMAINING
    arc length of that polyline in the image-space direction (the xy
    are known polyline points; cfg.extension_reanchor_px re-anchors
    them).  xy_ev/dir_ev are [E, V, 2]; iteration is VIEW-major
    (lax.map over concrete per-view grid slices) — vmapping `grids[v]`
    over flat queries materializes a per-query copy of the whole grid
    ([Q, GH, GW, K, 2]), an allocation no device holds at full scale
    (3.2M queries -> 1.6 TB).
    Returns packed [E, V, 6] f32 rows [pl, seg, t, ok, dist, remaining].
    """
    E, V = xy_ev.shape[:2]
    Vc, P_cnt, L, _ = plg_coords.shape
    # flat [V*P, 2L] layout (x block then y block): the nested
    # [E, L, 2] per-view gather tiles its (L, 2) minor dims to
    # (L, 128) — measured ~1 GB of padded temp PER VIEW at full scale,
    # the dominant slice of the 224 s chain-extension wall; the packed
    # rows tile exactly (see following.follow_seeds)
    packed = jnp.concatenate(
        [plg_coords[..., 0], plg_coords[..., 1]],
        axis=-1).reshape(Vc * P_cnt, 2 * L)

    def per_view(v):
        def q(pt):
            return detection.detect_starting_intersections(
                grids[v], pt, cell, reanchor_tol, 1)
        cand = jax.vmap(q)(xy_ev[:, v])
        pl = jnp.maximum(cand.pl_id[:, 0], 0)
        seg = jnp.maximum(cand.seg[:, 0], 0).astype(jnp.int32)
        rows = packed[v * P_cnt + pl]                      # [E,2L]
        px, py = rows[:, :L], rows[:, L:]
        n_pts = plg_length[v, pl]                          # [E]
        dx = px[:, 1:] - px[:, :-1]                        # [E,L-1]
        dy = py[:, 1:] - py[:, :-1]
        seg_len = jnp.sqrt(dx * dx + dy * dy)
        seg_ok = jnp.arange(L - 1)[None, :] < (n_pts[:, None] - 1)
        seg_len = jnp.where(seg_ok, seg_len, 0.0)
        tx = jnp.take_along_axis(dx, seg[:, None], axis=1)[:, 0]
        ty = jnp.take_along_axis(dy, seg[:, None], axis=1)[:, 0]
        fwd = tx * dir_ev[:, v, 0] + ty * dir_ev[:, v, 1] >= 0
        cum = jnp.cumsum(seg_len, axis=1)
        total = cum[:, -1]
        done = jnp.take_along_axis(cum, seg[:, None], axis=1)[:, 0] \
            - (1.0 - cand.t[:, 0]) * jnp.take_along_axis(
                seg_len, seg[:, None], axis=1)[:, 0]
        remaining = jnp.where(fwd, total - done, done)
        f = xy_ev.dtype
        return jnp.stack([
            cand.pl_id[:, 0].astype(f), cand.seg[:, 0].astype(f),
            cand.t[:, 0], cand.valid[:, 0].astype(f),
            jnp.minimum(cand.dist[:, 0], 1e18), remaining], axis=1)

    out = jax.lax.map(per_view, jnp.arange(V))             # [V,E,6]
    return jnp.moveaxis(out, 0, 1)


@partial(jax.jit, static_argnames=("cfg", "Ep", "cap", "gn_full"))
def _extension_locate_follow(plg_coords, plg_length, grids, P_mats,
                             F_table, cell: float, X_end, X_prev,
                             end_obs_xy, m, valid_e,
                             cfg: EdgeGraphConfig, Ep: int, cap: int,
                             gn_full: bool = False):
    """Extension megakernel: per chain end, reprojection-consistency
    gating + polyline re-anchoring + remaining-arc view ranking +
    bidirectional follow + packed emission in ONE device program (the
    fused form of the former _locate_on_polylines -> host top-3 ->
    follow sequence; 1 blocking fetch instead of 2).

    X_end/X_prev [Ep,3], end_obs_xy [Ep,V,2], m [Ep,V] (observed at
    both end and neighbour), valid_e [Ep].  Returns (rows, n_emit,
    extra = flat[meta (Ep*40), tv (Ep*3), loc_sel (Ep*18)]) — the
    host loop infers per-end validity from meta/rows, so ok_e is not
    part of the fetched payload.  `gn_full` forces the exact
    full-width post-walk GN (the redo path when meta reports
    gn_overflow > 0)."""
    from edgegraph3d_tpu.matching import following

    V = P_mats.shape[0]
    f = plg_coords.dtype
    away = X_end - X_prev
    # HIGHEST precision: at default precision an f32 einsum may run on
    # a reduced-precision path (TF32 on NVIDIA tensor cores) — at P
    # entries ~2e3 and 1600 px frames that is multi-PIXEL projection
    # error, silently failing the consistency gate (observed on a
    # bf16-pass backend: 353 vs 2203 extension points on one scene)
    hi = jax.lax.Precision.HIGHEST
    Xh = jnp.concatenate([X_end, jnp.ones((Ep, 1), X_end.dtype)],
                         axis=1)
    proj = jnp.einsum("vij,ej->evi", P_mats, Xh, precision=hi)
    proj = proj[..., :2] / jnp.maximum(proj[..., 2:3], 1e-9)
    resid = jnp.linalg.norm(proj - end_obs_xy, axis=-1)        # [E,V]
    X2h = jnp.concatenate([X_end + 0.5 * away,
                           jnp.ones((Ep, 1), X_end.dtype)], axis=1)
    proj2 = jnp.einsum("vij,ej->evi", P_mats, X2h, precision=hi)
    proj2 = proj2[..., :2] / jnp.maximum(proj2[..., 2:3], 1e-9)
    dir2 = (proj2 - proj).astype(f)                            # [E,V,2]

    loc = _locate_on_polylines(
        plg_coords, plg_length, grids, cell, end_obs_xy.astype(f),
        dir2, cfg.extension_reanchor_px)                   # [E,V,6]

    eligible = m & (loc[..., 3] > 0.5) \
        & (resid < cfg.extension_consistency_px)
    remaining = jnp.where(eligible, loc[..., 5], -1.0)
    vids = jnp.broadcast_to(jnp.arange(V), (Ep, V))
    rank = jnp.lexsort((vids, -remaining), axis=1)
    tv = jnp.sort(rank[:, :3], axis=1).astype(jnp.int32)       # [E,3]
    ok_e = (jnp.sum(eligible, axis=1) >= 3) & valid_e
    loc_sel = jnp.take_along_axis(loc, tv[:, :, None], axis=1)  # [E,3,6]
    end_xy = jnp.take_along_axis(end_obs_xy, tv[:, :, None], axis=1)

    seeds = following.SeedTuple(
        cams=tv, pl_id=loc_sel[..., 0].astype(jnp.int32),
        seg=loc_sel[..., 1].astype(jnp.int32),
        t=loc_sel[..., 2].astype(f), xy=end_xy.astype(f),
        X=X_end.astype(f), valid=ok_e)
    fwd, bwd, _ = following.follow_seeds_bidirectional(
        seeds, plg_coords, plg_length, P_mats, F_table, cfg,
        cfg.max_follow_steps,
        gn_cap=2 * Ep * cfg.max_follow_steps if gn_full else None)
    rows, n_emit, meta = following.pack_follow_outputs(
        fwd, bwd, seeds.valid, 1, cap)
    extra = jnp.concatenate([
        jnp.ravel(meta).astype(f), jnp.ravel(tv).astype(f),
        jnp.ravel(loc_sel).astype(f)])
    return rows, n_emit, extra


def extend_chains(ctx: MatchingContext, pts: EdgePoints,
                  manager: "matches_mod.MatchesManager",
                  stats=None) -> EdgePoints:
    """Grow chains outward from their ends using the EXPANDED view set
    (parity: the reference's follow_direction tail inside
    add_view_to_3dpoint_and_sides_plgp_matches_vector,
    plg_matching.cpp:1393-1412 — once a new view matches through a
    chain end, following continues past the end and appends brand-new
    3D points).  Batched formulation: after expansion, every chain end
    whose expanded observation set still has >= 3 views seeds a fresh
    bidirectional follow from the end position; only the direction
    moving AWAY from the chain (first new point on the far side of the
    end w.r.t. its neighbour) is kept — the equivalent of the
    reference's per-view direction discovery against the known 3D
    chain (plg_matching.cpp:933-1058).  New points are expanded to all
    views and appended with continuing chain orders; rounds repeat
    while points are added (cfg.max_extension_rounds)."""
    for _ in range(ctx.config.max_extension_rounds):
        added = _extend_once(ctx, pts, manager, stats=stats)
        if added is None:
            break
        pts = added
    return pts


def _extend_once(ctx: MatchingContext, pts: EdgePoints, manager,
                 stats=None):
    import time as _time

    def _log(name, t0, count=None):
        if stats is not None:
            stats.timings[name] = stats.timings.get(name, 0.0) \
                + (_time.time() - t0)
            if count is not None:
                stats.counts[name] = stats.counts.get(name, 0) + count

    cfg = ctx.config
    V = ctx.P_mats.shape[0]
    n = len(pts.X)
    if n == 0:
        return None
    order = np.lexsort((pts.chain_order, pts.seed_id))
    sid = pts.seed_id[order]
    bounds = np.concatenate(
        [[0], np.flatnonzero(np.diff(sid)) + 1, [n]])
    ends = []                                   # (end_row, prev_row, sign)
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a < 2:
            continue
        ends.append((order[b - 1], order[b - 2], 1))
        ends.append((order[a], order[a + 1], -1))
    if not ends:
        return None
    e = np.asarray(ends, np.int64)
    E = len(e)
    _t0 = _time.time()

    # tuple views: observed at BOTH the end and its neighbour (so the
    # away-from-chain test is defined), consistent at the end point
    # (reprojection residual < extension_consistency_px — a marginal
    # observation like a decoy edge inside the MSE gate must not steer
    # new geometry), and ranked by REMAINING polyline arc in the away
    # direction — the fixed-tuple stand-in for the reference's per-view
    # dropout (compatible(), plg_matching.cpp:633-759, silently drops
    # views whose polylines end and follows with the survivors; a
    # fixed 3-tuple must instead pick the views whose edges continue).
    # Gating + ranking + follow run FUSED on device
    # (_extension_locate_follow): one dispatch, one fetch.
    from edgegraph3d_tpu.ops.compaction import to_host_with_extra
    fdt = ctx.plg_coords.dtype
    m = pts.obs_mask[e[:, 0]] & pts.obs_mask[e[:, 1]]       # [E,V]
    X_end = pts.X[e[:, 0]]
    X_prev = pts.X[e[:, 1]]
    away_dir = X_end - X_prev                                # [E,3]
    end_xy = pts.obs_xy[e[:, 0]]

    # chunk the ends: one unbounded dispatch needed 18 GB of device
    # memory at reference scale (the follow-walk carry buffers scale
    # with Ep); chunks are enqueued before any fetch so transfers
    # overlap compute.  The 32768-end width was sized for a 16 GB card
    # and is unmeasured on larger ones (ROADMAP speed item 5).
    cap_e = 32768 if jax.default_backend() != "cpu" else 4096
    Ec = min(cap_e, 1 << max(int(np.ceil(np.log2(max(E, 256)))), 0))
    if jax.default_backend() != "cpu" and Ec > 4096:
        # two stable buckets on accelerators (<=4096 pow2, else the
        # cap): scene-size-dependent in-between shapes would each pay
        # a cold compile of the extension megakernel
        Ec = cap_e
    pend = []
    for lo in range(0, E, Ec):
        hi = min(lo + Ec, E)
        pad = Ec - (hi - lo)

        def padded(a, dt):
            return jnp.asarray(np.pad(
                a[lo:hi],
                ((0, pad),) + ((0, 0),) * (a.ndim - 1)).astype(dt))

        cap = 32 * Ec
        args = (ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
                ctx.F_table, ctx.cell, padded(X_end, fdt),
                padded(X_prev, fdt), padded(end_xy, fdt),
                padded(m, bool), jnp.asarray(np.arange(Ec) < hi - lo))
        out = _extension_locate_follow(*args, cfg, Ec, cap)
        pend.append((lo, hi, args, cap, out))

    rows_l, meta_l, tv_l, loc_l = [], [], [], []
    for lo, hi, args_c, cap, (rows_d, n_emit, extra) in pend:
        rows_c, n_int, extra_np = to_host_with_extra(rows_d, n_emit,
                                                     extra)
        if extra_np[_M_GNOVF] > 0:     # meta row 0, col _M_GNOVF
            # compacted-GN overflow: redo this chunk with the exact
            # full-width GN (counted, never silent)
            rows_d, n_emit, extra = _extension_locate_follow(
                *args_c, cfg, Ec, cap, gn_full=True)
            rows_c, n_int, extra_np = to_host_with_extra(rows_d, n_emit,
                                                         extra)
        if n_int > cap:
            cap = 2 * Ec * cfg.max_follow_steps
            rows_d, n_emit, extra = _extension_locate_follow(
                *args_c, cfg, Ec, cap)
            rows_c, n_int, extra_np = to_host_with_extra(rows_d, n_emit,
                                                         extra)
        if len(rows_c):
            rows_c = rows_c.copy()
            rows_c[:, 9] += lo            # seed idx -> global end idx
            rows_l.append(rows_c)
        meta_l.append(extra_np[: Ec * 40].reshape(Ec, 40)[: hi - lo])
        tv_l.append(extra_np[Ec * 40: Ec * 43].reshape(Ec, 3)[: hi - lo])
        loc_l.append(extra_np[Ec * 43: Ec * 61].reshape(Ec, 3, 6)
                     [: hi - lo])
    meta = np.concatenate(meta_l)
    tv = np.concatenate(tv_l).astype(np.int32)
    loc = np.concatenate(loc_l)
    _log("ext_locate_follow", _t0, E)
    _t0 = _time.time()
    if not rows_l:
        return None
    rows = np.concatenate(rows_l)

    # away-from-chain direction filter: the first new 3D point of the
    # kept direction must lie on the far side of the end point
    sidx = rows[:, 9].astype(np.int64)
    rord = rows[:, 10].astype(np.int64)
    dots = np.full((E, 2), -np.inf)                          # [E, fwd/bwd]
    first = np.abs(rord) == 1
    for drow in np.flatnonzero(first):
        s = sidx[drow]
        d = 0 if rord[drow] > 0 else 1
        dots[s, d] = np.dot(rows[drow, 0:3] - X_end[s], away_dir[s])
    keep_dir = dots > 0
    # at most ONE direction continues a chain end (a tie would emit
    # duplicate chain orders); keep the one reaching farther out
    bidx = np.flatnonzero(keep_dir.all(axis=1))
    keep_dir[bidx, np.argmin(dots[bidx], axis=1)] = False
    keep_rows = np.where(rord > 0, keep_dir[sidx, 0], keep_dir[sidx, 1])
    if not keep_rows.any():
        return None

    # claim the kept arcs (zero-span finals for the dropped direction).
    # skip_start_check=True is DELIBERATE, matching the continuation
    # rounds' semantics: extension walks may overlap already-claimed
    # arcs, exactly like the reference's add-view walks (which never
    # interval-check mid-walk, SWITCH_DISABLE_INTERVAL) — overlap
    # points are collapsed by the density filter.  The alternative
    # (rejecting an extension whose far end lands in a claimed bucket)
    # was measured on the bench workload: it drops curve coverage
    # 0.997 -> 0.985 (640 points) with no accuracy gain, because it
    # also kills legitimate gap-filling extensions between chains.
    # The claims registered here still suppress FUTURE seeds/rounds.
    success = keep_dir.any(axis=1)
    f_seg = np.where(keep_dir[:, 0:1], meta[:, _M_FSEG].astype(np.int64),
                     loc[..., 1].astype(np.int64))
    f_t = np.where(keep_dir[:, 0:1], meta[:, _M_FT], loc[..., 2])
    b_seg = np.where(keep_dir[:, 1:2], meta[:, _M_BSEG].astype(np.int64),
                     loc[..., 1].astype(np.int64))
    b_t = np.where(keep_dir[:, 1:2], meta[:, _M_BT], loc[..., 2])
    accept = manager.resolve_and_claim(
        success, tv, loc[..., 0].astype(np.int64),
        loc[..., 1].astype(np.int64), loc[..., 2],
        f_seg, f_t, b_seg, b_t, skip_start_check=True)
    keep_rows &= accept[sidx]
    if not keep_rows.any():
        return None
    rows = rows[keep_rows]
    sidx = sidx[keep_rows]
    rord = rord[keep_rows]

    _log("ext_claims", _t0)
    _t0 = _time.time()
    # expand the new points to all views (fresh short chains per end)
    sign_e = e[:, 2]
    parent_order = pts.chain_order[e[:, 0]]
    new_pts = expand_and_assemble(
        ctx, rows[:, 0:3].astype(np.float64),
        rows[:, 3:9].reshape(-1, 3, 2), tv[sidx],
        pts.seed_refpoint[e[sidx, 0]], sidx, np.abs(rord))
    # graft onto the parent chains: parent seed ids, continuing orders.
    # Compute BOTH before assigning — new_pts.seed_id aliases the sidx
    # array passed into expand_and_assemble.
    parent_sid = pts.seed_id[e[sidx, 0]]
    new_order = parent_order[sidx] + sign_e[sidx] * np.abs(rord)
    new_pts.seed_id[:] = parent_sid
    new_pts.chain_order[:] = new_order
    _log("ext_expand", _t0, len(new_pts.X))
    manager.counters["extension_points"] = \
        manager.counters.get("extension_points", 0) + len(new_pts.X)
    manager.counters["extension_rounds"] = \
        manager.counters.get("extension_rounds", 0) + 1

    return EdgePoints(
        X=np.concatenate([pts.X, new_pts.X]),
        obs_xy=np.concatenate([pts.obs_xy, new_pts.obs_xy]),
        obs_mask=np.concatenate([pts.obs_mask, new_pts.obs_mask]),
        seed_refpoint=np.concatenate([pts.seed_refpoint,
                                      new_pts.seed_refpoint]),
        seed_id=np.concatenate([pts.seed_id, new_pts.seed_id]),
        chain_order=np.concatenate([pts.chain_order,
                                    new_pts.chain_order]))


def reconstruct_from_refpoints(
    sfmd: SfMData, ctx: MatchingContext,
    refpoint_chunk: int = 256, seed_chunk: int = 2048,
    max_starting_views: int | None = None,
    manager: "matches_mod.MatchesManager | None" = None,
    seed_id_offset: int = 0,
) -> EdgePoints:
    """Run stage 3 over all refpoints (parity:
    plg_matching_from_refpoints_parallel, plg_matching_from_refpoints.cpp:83-165).
    """
    V = ctx.P_mats.shape[0]
    if manager is None:
        manager = matches_mod.MatchesManager(np.asarray(ctx.plg_length))
    if ctx.mesh is None:
        # fused megakernel path (one dispatch + one fetch per chunk)
        round0, _ = compute_and_follow_seeds(sfmd, ctx, refpoint_chunk,
                                             max_starting_views)
        if round0 is None:
            return _empty_points(V)
        res = sweep_seeds(None, None, ctx, manager, seed_chunk,
                          seed_id_offset, precomputed=round0)
    else:
        seeds_np, seed_ref = compute_seeds(sfmd, ctx, refpoint_chunk,
                                           max_starting_views)
        if seeds_np is None:
            return _empty_points(V)
        res = sweep_seeds(seeds_np, seed_ref, ctx, manager, seed_chunk,
                          seed_id_offset)
    if res is None:
        return _empty_points(V)
    pts = expand_and_assemble(ctx, *res)
    return extend_chains(ctx, pts, manager)
