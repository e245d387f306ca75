"""Nearby-polyline and epipolar-correspondence detection.

JAX-native replacement for the reference's `PLGEdgeManager`
(reference: src/edgegraph3d/edge_managers/plg_edge_manager.cpp:46-300):

  * detect_starting_intersections — closest points of nearby polylines
    to a refpoint's 2D observation, within `starting_dist`
    (parity: detect_nearby_intersections_and_correspondences_plgp
     :261-300, starting radius 10 px)
  * detect_epipolar_correspondences — intersections of an epipolar line
    with polylines near the observation, within the correspondence
    radius (= starting distance x 3, capped by the grid reach; parity:
    radius logic :169-182 and epipolar intersection collection :208-259)

Both are single-query functions vmapped over (refpoint, view) batches;
candidates come from the segment grid (grid.py), geometry is dense and
masked.  Results are fixed-width top-M lists of *distinct* polylines.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edgegraph3d_tpu.matching.grid import (BIG, gather_neighborhood,
                                           point_segment_distance)

#: queries per lax.map block when batching detection queries: the
#: neighborhood gather materializes [Q*cells, K, ENTRY_COLS] whose
#: minor (K, 6) dims tile at ~21x padding — unbounded Q means
#: multi-GB HLO temps (measured 9 GB at Q=262k; compile-time OOM)
QUERY_BLOCK = 32768


def map_query_blocks(fn, args, Q: int, block: int = QUERY_BLOCK):
    """Run a vmapped per-query `fn` over [Q, ...] tensors in
    `block`-sized lax.map blocks (pads Q up; output sliced back).
    Bounds the padded neighborhood-gather temps on any query width."""
    if Q <= block:
        return fn(*args)
    nb = -(-Q // block)
    pad = nb * block - Q

    def blocked(a):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)) \
            .reshape((nb, block) + a.shape[1:])

    out = jax.lax.map(lambda xs: fn(*xs),
                      tuple(blocked(a) for a in args))
    return jax.tree.map(
        lambda a: a.reshape((nb * block,) + a.shape[2:])[:Q], out)


class Candidates(NamedTuple):
    """Fixed-width per-query candidate list (padded with valid=False)."""
    pl_id: jnp.ndarray    # [M] int32
    seg: jnp.ndarray      # [M] int32
    t: jnp.ndarray        # [M] float
    xy: jnp.ndarray       # [M,2]
    dist: jnp.ndarray     # [M] distance to the query point
    valid: jnp.ndarray    # [M] bool


def _topm_distinct(pl_ids: jnp.ndarray, dist: jnp.ndarray, seg: jnp.ndarray,
                   t: jnp.ndarray, xy: jnp.ndarray, M: int) -> Candidates:
    """Select the M closest candidates with distinct polyline ids.

    M successive masked argmins (O(M*C) per query) — each round takes
    the closest remaining candidate and suppresses its whole polyline.
    """
    sel_pl, sel_seg, sel_t, sel_xy, sel_d, sel_ok = [], [], [], [], [], []
    d = dist
    for _ in range(M):
        i = jnp.argmin(d)
        di = d[i]
        sel_pl.append(pl_ids[i])
        sel_seg.append(seg[i])
        sel_t.append(t[i])
        sel_xy.append(xy[i])
        sel_d.append(di)
        sel_ok.append((di < BIG / 2) & (pl_ids[i] >= 0))
        d = jnp.where(pl_ids == pl_ids[i], BIG, d)
    ok = jnp.stack(sel_ok)
    return Candidates(
        pl_id=jnp.where(ok, jnp.stack(sel_pl), -1),
        seg=jnp.where(ok, jnp.stack(sel_seg), 0),
        t=jnp.where(ok, jnp.stack(sel_t), 0.0),
        xy=jnp.where(ok[:, None], jnp.stack(sel_xy), 0.0),
        dist=jnp.where(ok, jnp.stack(sel_d), BIG),
        valid=ok,
    )


def detect_starting_intersections(grid: jnp.ndarray, pt: jnp.ndarray,
                                  cell: float,
                                  starting_dist: float, M: int,
                                  radius_cells: int = 1) -> Candidates:
    """Top-M distinct polylines whose closest point to `pt` is within
    `starting_dist`.  grid [GH,GW,K,ENTRY_COLS] (segment endpoints live
    IN the grid entries — one contiguous gather per query, see
    grid.ENTRY_COLS).
    """
    entries = gather_neighborhood(grid, pt, cell, radius_cells)   # [C,6]
    pl = entries[:, 0].astype(jnp.int32)
    sg = entries[:, 1].astype(jnp.int32)
    ok = pl >= 0
    a = entries[:, 2:4]
    b = entries[:, 4:6]
    d, t, proj = point_segment_distance(pt, a, b)
    d = jnp.where(ok & (d <= starting_dist), d, BIG)
    return _topm_distinct(pl, d, sg, t, proj, M)


def detect_epipolar_correspondences(grid: jnp.ndarray,
                                    obs_pt: jnp.ndarray, line: jnp.ndarray,
                                    cell: float, radius: jnp.ndarray,
                                    M: int, radius_cells: int = 2,
                                    exclude_parallel_cos: float | None = None
                                    ) -> Candidates:
    """Top-M distinct polylines intersecting the epipolar `line` within
    `radius` of `obs_pt` (the refpoint's observation in this view).

    With `exclude_parallel_cos`, intersections on segments quasi-parallel
    to the epipolar line (|cos| above the threshold) are dropped — the
    closest-only edge-manager behavior (parity: PLGEdgeManagerClosestOnly
    exclude-parallel variants, plg_edge_manager_closest_only.cpp:199-300;
    M=1 gives its closest-only selection)."""
    entries = gather_neighborhood(grid, obs_pt, cell, radius_cells)
    pl = entries[:, 0].astype(jnp.int32)
    sg = entries[:, 1].astype(jnp.int32)
    ok = pl >= 0
    a = entries[:, 2:4]
    b = entries[:, 4:6]
    # segment x line intersection
    sa = a[:, 0] * line[0] + a[:, 1] * line[1] + line[2]
    sb = b[:, 0] * line[0] + b[:, 1] * line[1] + line[2]
    diff = sa - sb
    parallel = jnp.abs(diff) < 1e-9
    s = jnp.where(parallel, 0.0, sa / jnp.where(parallel, 1.0, diff))
    crosses = ((sa * sb) <= 0.0) & ~parallel & (s >= 0.0) & (s <= 1.0)
    if exclude_parallel_cos is not None:
        # |cos(segment, line direction)|: line (a,b,c) is normalized, its
        # direction is (-b, a)
        ab = b - a
        seg_len = jnp.maximum(jnp.linalg.norm(ab, axis=-1), 1e-12)
        cos = jnp.abs(ab[:, 0] * (-line[1]) + ab[:, 1] * line[0]) / seg_len
        crosses = crosses & (cos < exclude_parallel_cos)
    xy = a + s[:, None] * (b - a)
    d = jnp.linalg.norm(xy - obs_pt, axis=-1)
    d = jnp.where(ok & crosses & (d <= radius), d, BIG)
    return _topm_distinct(pl, d, sg, s, xy, M)
