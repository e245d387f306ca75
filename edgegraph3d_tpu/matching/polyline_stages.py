"""Stages 1-2: polyline-to-polyline matching across views.

JAX-native redesign of the reference's first two reconstruction stages
(reference: src/edgegraph3d/matching/plg_matching/pipelines.cpp:68-158,
src/edgegraph3d/matching/polyline_matching/polyline_matcher.cpp,
src/edgegraph3d/matching/plg_matching/polyline_matching.cpp:45-248):

  stage 1 (similarity graph):  nodes are (view, polyline) pairs; an edge
      links two polylines that lie within 10 px of a common refpoint's
      projections, weighted by a refpoint-weighted Jaccard of their
      close-refpoint sets (parity: polyline_matching_similarity_graph,
      polyline_matcher.cpp:222-336, compute_compatibility :171-199);
      communities come from device-side label propagation
      (communities.py — the grappolo replacement)

  stage 2 (closeness):  refpoints whose every viewing cam has <= 1
      close polyline, with >= 70% view coverage and min/max close-
      distance ratio <= 3, form connected components of (view, polyline)
      pairs (parity: polyline_matching_closeness_to_refpoints,
      polyline_matcher.cpp:75-168)

  driver:  every polyline of a match set is swept at 20 px intervals;
      each unmatched sample seeds a 3-view tuple via epipolar
      intersections with the other set members and is followed with the
      shared following machinery (parity:
      find_new_3d_points_from_compatible_polylines_expandallviews,
      polyline_matching.cpp:45-248, SPLIT_INTERVAL_DISTANCE 20)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core.sfm import SfMData
from edgegraph3d_tpu.matching import communities as comm_mod
from edgegraph3d_tpu.matching import detection
from edgegraph3d_tpu.matching.refpoints import MatchingContext, \
    dense_observations
from edgegraph3d_tpu.ops import polyline_ops as po
from edgegraph3d_tpu.ops.triangulation import gauss_newton_batched, \
    triangulate_dlt


# ----------------------------------------------------------------------
# Close-polyline detection per (refpoint, view)
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("M",))
def _close_polylines_chunk(plg_coords, grids, cell: float, obs_xy,
                           M: int, within_dist: float):
    """For every (refpoint, view): top-M distinct polylines within
    `within_dist` of the observation.  obs_xy [N,V,2].  Returns ONE
    packed [N,V,M,7] f32 tensor [pl_id, seg, t, xy(2), dist, valid] —
    a single device->host transfer per chunk (each transfer is a host
    sync)."""
    N, V = obs_xy.shape[:2]

    def per_view(v):
        def q(pt):
            return detection.detect_starting_intersections(
                grids[v], pt, cell, within_dist, M)
        return jax.vmap(q)(obs_xy[:, v])
    cand = jax.lax.map(per_view, jnp.arange(V))
    cand = jax.tree.map(lambda a: jnp.moveaxis(a, 0, 1), cand)  # [N,V,M]
    f = obs_xy.dtype
    return jnp.concatenate([
        cand.pl_id.astype(f)[..., None], cand.seg.astype(f)[..., None],
        cand.t[..., None], cand.xy,
        jnp.minimum(cand.dist, 1e18)[..., None],
        cand.valid.astype(f)[..., None]], axis=-1)


def _close_polylines(plg_coords, grids, cell: float, obs_xy, M: int,
                     within_dist: float, chunk: int = 256):
    """Pow2-bucketed chunks over refpoints (compile reuse across runs;
    one dispatch when the scene fits — each chunk costs a blocking
    fetch).  Returns a Candidates tree of numpy arrays [N,V,M]."""
    obs_np = np.asarray(obs_xy)
    N = len(obs_np)
    cap = 1024 if jax.default_backend() != "cpu" else chunk
    chunk = min(cap, max(chunk, 1 << max(N - 1, 1).bit_length()))
    # enqueue every chunk before fetching any (async dispatch): the
    # device works through chunk k+1 while chunk k's result is fetched
    pend = []
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        pad = chunk - (hi - lo)
        ox = jnp.asarray(np.pad(obs_np[lo:hi],
                                ((0, pad), (0, 0), (0, 0))))
        pend.append((hi - lo, _close_polylines_chunk(
            plg_coords, grids, cell, ox, M, within_dist)))
    from edgegraph3d_tpu.ops.compaction import fetch
    packed = np.concatenate([fetch(res)[:n] for n, res in pend])
    return detection.Candidates(
        pl_id=packed[..., 0].astype(np.int32),
        seg=packed[..., 1].astype(np.int32),
        t=packed[..., 2], xy=packed[..., 3:5], dist=packed[..., 5],
        valid=packed[..., 6] > 0.5)


def _close_polylines_cached(sfmd, ctx, M: int, within_dist: float):
    """Per-(scene, context) memo: stage 2's close set (M=2) is a PREFIX
    of stage 1's (the top-M lists are nested by construction), so one
    device sweep serves both stages.  The cache lives on the CONTEXT
    object (so it dies with the context, never outliving the polylines
    it was computed from) and each entry pins a weakref to the scene it
    served — a rebuilt context or a different SfMData can never reuse
    stale candidates, and entries cannot accumulate across contexts."""
    import weakref
    cache = ctx.__dict__.setdefault("_close_polyline_cache", {})
    for (m2, d), (scene_ref, val) in cache.items():
        if scene_ref() is sfmd and d == within_dist and m2 >= M:
            return detection.Candidates(*[a[:, :, :M] for a in val])
    obs_xy, _ = dense_observations(sfmd)
    cand = _close_polylines(ctx.plg_coords, ctx.grids, ctx.cell,
                            jnp.asarray(obs_xy), M, within_dist)
    # drop entries for dead or different scenes (one scene per context)
    for k in [k for k, (ref, _) in cache.items() if ref() is not sfmd]:
        del cache[k]
    cache[(M, within_dist)] = (weakref.ref(sfmd), cand)
    return cand


# ----------------------------------------------------------------------
# Stage 2: closeness match sets
# ----------------------------------------------------------------------

def closeness_match_sets(sfmd: SfMData, ctx: MatchingContext,
                         max_sets: int | None = None) -> list[np.ndarray]:
    """Connected components of (view, polyline) pairs from unambiguous
    refpoints.  Returns a list of [k,2] arrays (view, polyline)."""
    cfg = ctx.config
    obs_xy, obs_mask = dense_observations(sfmd)
    cand = _close_polylines_cached(sfmd, ctx, 2, cfg.find_within_dist_px)
    valid = np.asarray(cand.valid) & obs_mask[..., None]   # [N,V,2]
    pl = np.asarray(cand.pl_id)
    dist = np.asarray(cand.dist)

    n_close = valid.sum(axis=2)                            # [N,V]
    unambiguous = (n_close <= 1) | ~obs_mask
    one = (n_close == 1) & obs_mask
    N, V = obs_mask.shape

    # union-find over (view, polyline) nodes
    parent: dict = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for n in range(N):
        if not unambiguous[n].all():
            continue
        views = np.flatnonzero(one[n])
        if len(views) < max(2, int(np.ceil(
                cfg.closeness_min_view_coverage * obs_mask[n].sum()))):
            continue
        d = dist[n, views, 0]
        if d.max() > cfg.closeness_max_dist_ratio * max(d.min(), 1e-6):
            continue
        nodes = [(int(v), int(pl[n, v, 0])) for v in views]
        for other in nodes[1:]:
            union(nodes[0], other)

    groups: dict = {}
    for node in list(parent):
        groups.setdefault(find(node), []).append(node)
    out = [np.asarray(sorted(g), dtype=np.int64)
           for g in groups.values() if len(g) >= 3]
    out.sort(key=lambda g: (-len(g), g[0][0], g[0][1]))
    return out[:max_sets] if max_sets else out


# ----------------------------------------------------------------------
# Stage 1: similarity graph + communities
# ----------------------------------------------------------------------

#: device similarity-graph kernel limits: above U_CAP_MAX nodes the
#: dense [U, U] intersection matrix would exceed ~4 GB and the host
#: path takes over (at the reference's full scale U ~ 12k)
_U_CAP_MAX = 32768


@partial(jax.jit, static_argnames=("N_pad", "U_cap", "E_cap"))
def _similarity_edges_device(nn, u_idx, slot_ok, w_ref, obs_mask_f,
                             view_of_u, N_pad: int, U_cap: int,
                             E_cap: int):
    """Similarity-graph edges as DENSE matmuls.

    The clique-pair semantics (polyline_matcher.cpp:244-327) factor
    exactly: with B [N, U] the refpoint-x-node close-incidence matrix,
      inter_w[a, b] = sum_n w_ref[n] B[n,a] B[n,b]  =  (B^T diag(w) B)
      SA[a, v]      = sum_n w_ref[n] B[n,a] obs[n,v] = (B^T diag(w) Obs)
      union_w[a,b]  = SA[a, view(b)] + SA[b, view(a)] - inter_w[a,b]
      w_edge        = inter_w / union_w            (weighted Jaccard)
    — the ~32M-pair host group-by at full scale becomes two matmuls of
    ~2 TFLOP each, the engine's only matmul-shaped hot spot.
    Upper-triangle positive
    entries are stream-compacted to [E_cap, 3] rows (ia, ib, w_edge);
    n_edges > E_cap is reported for the (counted) host fallback.

    nn/u_idx [nnz_cap] padded scatter coordinates of B's ones,
    slot_ok their validity, w_ref [N_pad], obs_mask_f [N_pad, V],
    view_of_u [U_cap]."""
    from edgegraph3d_tpu.ops.compaction import compact_rows
    B = jnp.zeros((N_pad, U_cap), jnp.float32)
    B = B.at[jnp.where(slot_ok, nn, N_pad),
             jnp.where(slot_ok, u_idx, 0)].set(1.0, mode="drop")
    Bw = B * w_ref[:, None]
    # DEFAULT precision is deliberate here, overriding the package-wide
    # HIGHEST pin: on a GPU these products run in TF32 on the tensor
    # cores.  The 0/1 incidences are exact in TF32; only the refpoint
    # weights round to a 10-bit mantissa (~5e-4 relative), the result
    # only ranks community edges, and that error is far below the
    # Jaccard weights' own modelling noise (the device-vs-host test
    # bounds it at 2%).
    fast = jax.lax.Precision.DEFAULT
    inter = jax.lax.dot(B.T, Bw, precision=fast)        # [U, U]
    SA = jax.lax.dot(Bw.T, obs_mask_f, precision=fast)  # [U, V]
    SA_vb = SA[:, view_of_u]                           # SA[a, view(b)]
    union = SA_vb + SA_vb.T - inter
    w_edge = jnp.where(union > 0, inter / jnp.maximum(union, 1e-12),
                       0.0)
    iu = jnp.arange(U_cap)
    keep = (iu[:, None] < iu[None, :]) & (inter > 0) & (w_edge > 0)
    payload = jnp.stack(
        [jnp.broadcast_to(iu[:, None].astype(jnp.float32),
                          (U_cap, U_cap)),
         jnp.broadcast_to(iu[None, :].astype(jnp.float32),
                          (U_cap, U_cap)),
         w_edge.astype(jnp.float32)], axis=-1).reshape(-1, 3)
    return compact_rows(keep.reshape(-1), payload, E_cap)


def _similarity_edges_host(node, valid, w_ref, obs_mask, used, nn, vv,
                           mm, u_idx, V: int, P_cnt: int):
    """Host (numpy) similarity-edge build — the CPU-backend path and
    the overflow/oversize fallback of _similarity_edges_device (same
    semantics; clique pairs per refpoint then weighted-Jaccard, see
    similarity_match_sets docstring).  Returns (edges, weights) or
    None."""
    N = valid.shape[0]
    M = valid.shape[2]
    U = len(used)
    # per-(node, view) weight sums restricted by visibility:
    # SA[u, v2] = sum of w_ref over refpoints close to u, visible on v2
    SA = np.zeros((U, V), dtype=np.float64)
    np.add.at(SA, u_idx, w_ref[nn, None] * obs_mask[nn])

    # clique edges per refpoint, chunked over refpoints
    K = V * M
    slots_i, slots_j = np.triu_indices(K, k=1)
    node_flat = node.reshape(N, K)
    valid_flat = valid.reshape(N, K)
    keys_acc, inter_acc = [], []
    chunk = 512
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        a = node_flat[lo:hi, slots_i]
        b = node_flat[lo:hi, slots_j]
        ok = valid_flat[lo:hi, slots_i] & valid_flat[lo:hi, slots_j]
        sel = np.nonzero(ok)
        if len(sel[0]) == 0:
            continue
        aa, bb = a[sel], b[sel]
        lo_n, hi_n = np.minimum(aa, bb), np.maximum(aa, bb)
        keys_acc.append(lo_n.astype(np.int64) * (V * P_cnt) + hi_n)
        inter_acc.append(w_ref[lo + sel[0]])
    if not keys_acc:
        return None
    keys = np.concatenate(keys_acc)
    contrib = np.concatenate(inter_acc)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    inter_w = np.bincount(inv, weights=contrib)             # [E]
    ea = (uniq_keys // (V * P_cnt)).astype(np.int64)
    eb = (uniq_keys % (V * P_cnt)).astype(np.int64)
    ia = np.searchsorted(used, ea)
    ib = np.searchsorted(used, eb)
    va = (ea // P_cnt).astype(np.int64)
    vb = (eb // P_cnt).astype(np.int64)
    union_w = SA[ia, vb] + SA[ib, va] - inter_w
    w_edge = np.where(union_w > 0, inter_w / np.maximum(union_w, 1e-12),
                      0.0)
    keep = w_edge > 0.0
    if not keep.any():
        return None
    return (np.stack([ia[keep], ib[keep]], axis=1).astype(np.int32),
            w_edge[keep].astype(np.float32))


def similarity_inputs(sfmd: SfMData, ctx: MatchingContext):
    """Stage-1 graph inputs (the keyword arguments of
    _similarity_edges_host), or None when no polyline is close to any
    refpoint: the close (view, polyline) nodes per refpoint, refpoint
    weights, and the dense reindex of the used nodes."""
    cfg = ctx.config
    _, obs_mask = dense_observations(sfmd)
    cand = _close_polylines_cached(sfmd, ctx, cfg.similarity_close_cap,
                                   cfg.find_within_dist_px)
    valid = np.asarray(cand.valid) & obs_mask[..., None]   # [N,V,M]
    pl = np.asarray(cand.pl_id)
    V = obs_mask.shape[1]
    P_cnt = ctx.plg_coords.shape[1]
    node = np.where(valid, np.arange(V)[None, :, None] * P_cnt + pl, -1)

    # refpoint weights (compute_refpoint_weight)
    n_close = valid.sum(axis=(1, 2)).astype(np.float64)       # [N]
    n_views = np.any(valid, axis=2).sum(axis=1).astype(np.float64)
    w_ref = np.where(n_close > 0, n_views / np.maximum(n_close, 1), 0.0)

    # node ids (dense reindex of the used (view, polyline) pairs);
    # `used` is sorted, so searchsorted IS the remap (no Python loops)
    used = np.unique(node[valid])
    if len(used) == 0:
        return None
    nn, vv, mm = np.nonzero(valid)
    u_idx = np.searchsorted(used, node[nn, vv, mm])
    return dict(node=node, valid=valid, w_ref=w_ref, obs_mask=obs_mask,
                used=used, nn=nn, vv=vv, mm=mm, u_idx=u_idx, V=V,
                P_cnt=P_cnt)


def similarity_edges_device(inp: dict, E_cap: int = 1 << 22):
    """_similarity_edges_device on `similarity_inputs` output: pad to
    pow2 buckets, run, fetch.  Returns (edges, weights), or None when
    more than E_cap edges overflow the buffer (the caller falls back to
    the host build)."""
    from edgegraph3d_tpu.ops.compaction import to_host
    nn, u_idx, w_ref = inp["nn"], inp["u_idx"], inp["w_ref"]
    obs_mask, used, P_cnt = inp["obs_mask"], inp["used"], inp["P_cnt"]
    N, V = obs_mask.shape
    U = len(used)
    N_pad = 1 << max(N - 1, 1).bit_length()
    U_cap = max(1024, 1 << max(U - 1, 1).bit_length())
    nnz = len(nn)
    nnz_cap = 1 << max(nnz - 1, 1).bit_length()
    w_ref_p = np.zeros(N_pad, np.float32)
    w_ref_p[:N] = w_ref
    obs_f = np.zeros((N_pad, V), np.float32)
    obs_f[:N] = obs_mask
    view_of_u = np.zeros(U_cap, np.int32)
    view_of_u[:U] = (used // P_cnt).astype(np.int32)
    buf, n_e = _similarity_edges_device(
        jnp.asarray(np.pad(nn.astype(np.int32), (0, nnz_cap - nnz))),
        jnp.asarray(np.pad(u_idx.astype(np.int32), (0, nnz_cap - nnz))),
        jnp.asarray(np.arange(nnz_cap) < nnz),
        jnp.asarray(w_ref_p), jnp.asarray(obs_f),
        jnp.asarray(view_of_u), N_pad, U_cap, E_cap)
    rows, n_int = to_host(buf, n_e)
    if n_int > E_cap:
        return None
    return rows[:, 0:2].astype(np.int32), rows[:, 2].astype(np.float32)


def similarity_match_sets(sfmd: SfMData, ctx: MatchingContext,
                          max_sets: int | None = None,
                          stats=None) -> list[np.ndarray]:
    """Polyline-compatibility communities (parity:
    polyline_matching_similarity_graph + grappolo,
    polyline_matcher.cpp:222-336).  With `stats` (a PipelineStats) the
    sub-phases are logged as stage1_close/graph/communities.

    Faithful semantics, vectorized on host (no per-refpoint Python
    loops):
      * node = (view, polyline) close (<= 10 px) to a refpoint's
        projection on a viewing cam (top similarity_close_cap distinct
        polylines per view; the reference's close set is unbounded, and
        the cap's saturation is measured by
        tests/test_polyline_stages.py::test_similarity_close_cap_saturates)
      * refpoint weight = non_empty_views / total_close_polylines
        (compute_refpoint_weight, :191-199)
      * edge weight = visibility-restricted weighted Jaccard
        (compute_compatibility, :171-189): for nodes a=(va,pa),
        b=(vb,pb), intersection = refpoints close to both (those
        generated the edge), union = (close to a AND visible on vb) +
        (close to b AND visible on va) - intersection, each summed by
        refpoint weight
    """
    import time
    cfg = ctx.config
    t0 = time.time()
    _close_polylines_cached(sfmd, ctx, cfg.similarity_close_cap,
                            cfg.find_within_dist_px)
    if stats is not None:
        stats.log("stage1_close", t0)
    t0 = time.time()
    inp = similarity_inputs(sfmd, ctx)   # the close set comes memoised
    if inp is None:
        return []
    used, P_cnt = inp["used"], inp["P_cnt"]

    res = None
    if jax.default_backend() != "cpu" and len(used) <= _U_CAP_MAX:
        # device path: the whole pair/Jaccard build as two matmuls
        # (see _similarity_edges_device); host only sees the compacted
        # unique edge list
        res = similarity_edges_device(inp)
    if res is None:
        res = _similarity_edges_host(**inp)
        if res is None:
            return []
    edges, weights = res
    if len(edges) == 0:
        return []
    if stats is not None:
        stats.log("stage1_graph", t0, len(edges))
    t0 = time.time()

    comms = comm_mod.communities_from_edges(
        edges, weights, len(used), min_size=3,
        method=cfg.community_method)
    if stats is not None:
        stats.log("stage1_communities", t0, len(comms))
    out = []
    for c in comms:
        uc = used[np.asarray(c)]
        pairs = np.stack([uc // P_cnt, uc % P_cnt], axis=1)
        # need >= 3 distinct views for seeding
        if len(np.unique(pairs[:, 0])) >= 3:
            out.append(pairs)
    out.sort(key=lambda g: (-len(g), g[0][0], g[0][1]))
    return out[:max_sets] if max_sets else out


# ----------------------------------------------------------------------
# Match-set sweep driver
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_samples", "cfg"))
def _group_seed_sweep(plg_coords, plg_length, P_mats, F_table,
                      grp_cam, grp_pl, grp_mask, n_samples: int,
                      cfg: EdgeGraphConfig):
    """Seeds from interval samples of match-set polylines.

    grp_cam/grp_pl/grp_mask: [G,K].  Returns seed fields
    [G,K,n_samples,...] with `valid`.
    """
    G, K = grp_cam.shape
    cam_safe = jnp.maximum(grp_cam, 0)
    pl_safe = jnp.maximum(grp_pl, 0)
    coords = plg_coords[cam_safe, pl_safe]                 # [G,K,L,2]
    lengths = jnp.where(grp_mask, plg_length[cam_safe, pl_safe], 0)

    # interval samples along every member polyline (20 px)
    samp = jax.vmap(jax.vmap(
        lambda c, l: po.sample_interval_points(
            c, l, cfg.split_interval_distance_px, n_samples)))(
        coords, lengths)
    s_xy, s_seg, s_t, s_valid = samp                      # [G,K,S,...]
    s_valid = s_valid & grp_mask[..., None]

    # epipolar lines from each sample into every other member's view
    xyh = jnp.concatenate([s_xy, jnp.ones(s_xy.shape[:-1] + (1,),
                                          s_xy.dtype)], axis=-1)
    F_pair = F_table[cam_safe[:, :, None], cam_safe[:, None, :]]  # [G,K,K,3,3]
    lines = jnp.einsum("gkjab,gksb->gksja", F_pair, xyh,
                       precision=jax.lax.Precision.HIGHEST)  # [G,K,S,K,3]
    ln = jnp.sqrt(lines[..., 0] ** 2 + lines[..., 1] ** 2)
    lines = lines / jnp.maximum(ln, 1e-20)[..., None]

    # intersections of each line with the other member's polyline
    def isect(c, l, line):
        xy, seg, t, ok = po.polyline_line_intersections(c, l, line, 2)
        return xy, seg, t, ok
    coords_b = jnp.broadcast_to(coords[:, None, None],
                                (G, K, n_samples) + coords.shape[1:])
    lens_b = jnp.broadcast_to(lengths[:, None, None],
                              (G, K, n_samples, K))
    flat = jax.vmap(isect)(
        coords_b.reshape((-1,) + coords.shape[2:]),
        lens_b.reshape(-1),
        lines.reshape(-1, 3))
    i_xy, i_seg, i_t, i_ok = jax.tree.map(
        lambda a: a.reshape((G, K, n_samples, K) + a.shape[1:]), flat)
    # member j usable for sample (k, s): valid member on a different cam
    diff_cam = grp_cam[:, :, None] != grp_cam[:, None, :]   # [G,K(k),K(j)]
    usable = (grp_mask[:, None, None, :]
              & diff_cam[:, :, None, :])[..., None]         # [G,K,1,K,1]
    i_ok = i_ok & usable & s_valid[..., None, None]         # [G,K,S,K,2]

    # choose 2 members on distinct cams: (min cam, max cam) among usable
    memb_has = jnp.any(i_ok, axis=-1)                      # [G,K,S,K]
    cam_b = jnp.broadcast_to(grp_cam[:, None, None, :], memb_has.shape)
    big = jnp.int32(10 ** 6)
    j1 = jnp.argmin(jnp.where(memb_has, cam_b, big), axis=-1)
    j2 = jnp.argmax(jnp.where(memb_has, cam_b, -1), axis=-1)
    cam_j1 = jnp.take_along_axis(cam_b, j1[..., None], axis=-1)[..., 0]
    cam_j2 = jnp.take_along_axis(cam_b, j2[..., None], axis=-1)[..., 0]
    ok2 = (jnp.sum(memb_has, axis=-1) >= 2) & (cam_j1 != cam_j2)

    def take_member(arr, j):
        return jnp.take_along_axis(
            arr, j[..., None].reshape(j.shape + (1,) * (arr.ndim - j.ndim)),
            axis=3).squeeze(3)

    c1 = [take_member(a, j1) for a in (i_xy, i_seg, i_t, i_ok)]
    c2 = [take_member(a, j2) for a in (i_xy, i_seg, i_t, i_ok)]
    pl_j1 = take_member(jnp.broadcast_to(grp_pl[:, None, None, :],
                                         memb_has.shape), j1)
    pl_j2 = take_member(jnp.broadcast_to(grp_pl[:, None, None, :],
                                         memb_has.shape), j2)

    # triangulate 2x2 candidate pairs; unique valid required
    cam_s = jnp.broadcast_to(grp_cam[:, :, None], (G, K, n_samples))
    cams3 = jnp.stack([cam_s, cam_j1, cam_j2], axis=-1)    # [G,K,S,3]
    P3 = P_mats[jnp.maximum(cams3, 0)]
    Mc = 2
    pair_xy = jnp.stack([
        jnp.broadcast_to(s_xy[..., None, None, :],
                         (G, K, n_samples, Mc, Mc, 2)),
        jnp.broadcast_to(c1[0][..., :, None, :],
                         (G, K, n_samples, Mc, Mc, 2)),
        jnp.broadcast_to(c2[0][..., None, :, :],
                         (G, K, n_samples, Mc, Mc, 2)),
    ], axis=-2)
    P_b = jnp.broadcast_to(P3[..., None, None, :, :, :],
                           (G, K, n_samples, Mc, Mc, 3, 3, 4))
    flat_xy = pair_xy.reshape(-1, 3, 2)
    flat_P = P_b.reshape(-1, 3, 3, 4)
    m3 = jnp.ones(flat_xy.shape[:2], bool)
    X0 = triangulate_dlt(flat_P, flat_xy, m3)
    X, mse, okt = gauss_newton_batched(flat_P, flat_xy, m3, X0,
                                       max_iters=cfg.gn_max_iters,
                                       accept_mse=cfg.match_gn_max_mse,
                                       epsilon=cfg.gn_epsilon)
    X = X.reshape(G, K, n_samples, Mc, Mc, 3)
    okt = okt.reshape(G, K, n_samples, Mc, Mc)
    okt = okt & c1[3][..., :, None] & c2[3][..., None, :] \
        & ok2[..., None, None]
    n_valid = jnp.sum(okt.reshape(G, K, n_samples, -1), axis=-1)
    unique = n_valid == 1
    pick = jnp.argmax(okt.reshape(G, K, n_samples, -1), axis=-1)
    i1 = pick // Mc
    i2 = pick % Mc

    def pick_c(arr, i):
        return jnp.take_along_axis(
            arr, i[..., None].reshape(i.shape + (1,) * (arr.ndim - i.ndim)),
            axis=3).squeeze(3)

    seed_X = jnp.take_along_axis(
        X.reshape(G, K, n_samples, -1, 3), pick[..., None, None],
        axis=3).squeeze(3)
    seed_valid = unique & s_valid & ok2

    sel1 = [pick_c(a, i1) for a in c1[:3]]
    sel2 = [pick_c(a, i2) for a in c2[:3]]
    pl3 = jnp.stack([jnp.broadcast_to(grp_pl[:, :, None], cam_s.shape),
                     pl_j1, pl_j2], axis=-1)
    seg3 = jnp.stack([s_seg, sel1[1], sel2[1]], axis=-1)
    t3 = jnp.stack([s_t, sel1[2], sel2[2]], axis=-1)
    xy3 = jnp.stack([s_xy, sel1[0], sel2[0]], axis=-2)

    return dict(cams=cams3, pl_id=pl3, seg=seg3, t=t3, xy=xy3,
                X=seed_X, valid=seed_valid)


@partial(jax.jit, static_argnames=("n_samples", "cfg", "cap_s",
                                   "cap_rows"))
def _group_seed_follow_fused(plg_coords, plg_length, P_mats, F_table,
                             grp_cam, grp_pl, grp_mask,
                             n_samples: int, cfg: EdgeGraphConfig,
                             cap_s: int, cap_rows: int):
    """Stage-1/2 megakernel: interval-sample seeding over the match
    sets + bidirectional follow + packed emission in ONE device
    program (the group analog of refpoints._seed_follow_fused; same
    dispatch-latency rationale).  Returns (rows, n_rows, extra =
    flat[meta (cap_s*40), seed_buf (cap_s*22), n_seeds])."""
    from edgegraph3d_tpu.matching import following
    from edgegraph3d_tpu.matching.refpoints import _pack_seed_outputs

    out = _group_seed_sweep(plg_coords, plg_length, P_mats, F_table,
                            grp_cam, grp_pl, grp_mask, n_samples, cfg)
    buf, n_seeds = _pack_seed_outputs(out, cap_s)
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
        jnp.reshape(n_seeds, (1,)).astype(f)])
    return rows, n_emit, extra


def group_seeds_and_follow(groups: list[np.ndarray],
                           ctx: MatchingContext,
                           n_samples: int = 24, max_members: int = 8,
                           group_chunk: int = 64):
    """Pipelined fused stage-1/2 phase A+B: enqueue every group chunk's
    megakernel, then fetch — one blocking round trip per chunk (see
    refpoints.compute_and_follow_seeds).  Returns (round0 list for
    sweep_seeds(precomputed=...), n_seeds_total)."""
    from edgegraph3d_tpu.matching.refpoints import _M_GNOVF, \
        _chunk_from_seed_buf
    from edgegraph3d_tpu.ops.compaction import to_host, \
        to_host_with_extra

    if not groups:
        return None, 0
    cfg = ctx.config
    G_total = len(groups)
    cam = np.full((G_total, max_members), -1, dtype=np.int32)
    pl = np.full((G_total, max_members), 0, dtype=np.int32)
    msk = np.zeros((G_total, max_members), dtype=bool)
    for g, pairs in enumerate(groups):
        k = min(len(pairs), max_members)
        cam[g, :k] = pairs[:k, 0]
        pl[g, :k] = pairs[:k, 1]
        msk[g, :k] = True

    cap_s = 16 * group_chunk
    cap_rows = 32 * cap_s
    pend = []
    for lo in range(0, G_total, group_chunk):
        hi = min(lo + group_chunk, G_total)
        pad = group_chunk - (hi - lo)
        gc = jnp.asarray(np.pad(cam[lo:hi], ((0, pad), (0, 0)),
                                constant_values=-1))
        gp = jnp.asarray(np.pad(pl[lo:hi], ((0, pad), (0, 0))))
        gm = jnp.asarray(np.pad(msk[lo:hi], ((0, pad), (0, 0))))
        out = _group_seed_follow_fused(
            ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table,
            gc, gp, gm, n_samples, cfg, cap_s, cap_rows)
        pend.append((lo, gc, gp, gm, out))

    round0 = []
    seed_lo = 0
    for lo, gc, gp, gm, (rows_buf, n_emit, extra) in pend:
        rows, n_rows, extra_np = to_host_with_extra(rows_buf, n_emit,
                                                    extra)
        meta = extra_np[: cap_s * 40].reshape(cap_s, 40)
        sbuf = extra_np[cap_s * 40: cap_s * 62].reshape(cap_s, 22)
        n_seeds = int(extra_np[cap_s * 62])
        if n_seeds > cap_s or n_rows > cap_rows \
                or meta[0, _M_GNOVF] > 0:
            # rare dense chunk: full-width two-phase fallback
            from edgegraph3d_tpu.matching.refpoints import \
                _follow_seed_rows, _pack_seed_outputs
            out_full = _group_seed_sweep(
                ctx.plg_coords, ctx.plg_length, ctx.P_mats,
                ctx.F_table, gc, gp, gm, n_samples, cfg)
            buf_d, n_d = _pack_seed_outputs(
                out_full, int(np.prod(
                    np.asarray(out_full["valid"].shape))))
            sbuf, n_seeds = to_host(buf_d, n_d)
            if n_seeds == 0:
                continue
            rows, meta = _follow_seed_rows(ctx, sbuf, n_seeds)
        if n_seeds == 0:
            continue
        chunk = _chunk_from_seed_buf(np.asarray(sbuf[:n_seeds]), lo)
        round0.append((seed_lo, chunk, rows, meta[:n_seeds]))
        seed_lo += n_seeds
    return (round0 if round0 else None), seed_lo


def seeds_from_match_sets(groups: list[np.ndarray], ctx: MatchingContext,
                          n_samples: int = 24, max_members: int = 8,
                          group_chunk: int = 64):
    """Run the group sweep over all match sets; returns (seeds_np dict,
    group ids) with host compaction."""
    if not groups:
        return None, None
    cfg = ctx.config
    G_total = len(groups)
    cam = np.full((G_total, max_members), -1, dtype=np.int32)
    pl = np.full((G_total, max_members), 0, dtype=np.int32)
    msk = np.zeros((G_total, max_members), dtype=bool)
    for g, pairs in enumerate(groups):
        k = min(len(pairs), max_members)
        cam[g, :k] = pairs[:k, 0]
        pl[g, :k] = pairs[:k, 1]
        msk[g, :k] = True

    acc = {k: [] for k in ("cams", "pl_id", "seg", "t", "xy", "X")}
    grp_ids = []
    for lo in range(0, G_total, group_chunk):
        hi = min(lo + group_chunk, G_total)
        pad = group_chunk - (hi - lo)
        out = _group_seed_sweep(
            ctx.plg_coords, ctx.plg_length, ctx.P_mats, ctx.F_table,
            jnp.asarray(np.pad(cam[lo:hi], ((0, pad), (0, 0)),
                               constant_values=-1)),
            jnp.asarray(np.pad(pl[lo:hi], ((0, pad), (0, 0)))),
            jnp.asarray(np.pad(msk[lo:hi], ((0, pad), (0, 0)))),
            n_samples, cfg)
        # device-side compaction: 2 transfers per chunk (see
        # ops/compaction.py)
        from edgegraph3d_tpu.matching.refpoints import _pack_seed_outputs
        from edgegraph3d_tpu.ops.compaction import to_host
        cap = 16 * group_chunk
        buf, n = _pack_seed_outputs(out, cap)
        rows, n_int = to_host(buf, n)
        if n_int > cap:    # dense chunk: repack at full width
            buf, n = _pack_seed_outputs(
                out, int(np.prod(out["valid"].shape)))
            rows, n_int = to_host(buf, n)
        if n_int == 0:
            continue
        acc["cams"].append(rows[:, 0:3].astype(np.int32))
        acc["pl_id"].append(rows[:, 3:6].astype(np.int32))
        acc["seg"].append(rows[:, 6:9].astype(np.int32))
        acc["t"].append(rows[:, 9:12])
        acc["xy"].append(rows[:, 12:18].reshape(-1, 3, 2))
        acc["X"].append(rows[:, 18:21])
        grp_ids.append(lo + rows[:, 21].astype(np.int64))
    if not grp_ids:
        return None, None
    return ({k: np.concatenate(v) for k, v in acc.items()},
            np.concatenate(grp_ids))
