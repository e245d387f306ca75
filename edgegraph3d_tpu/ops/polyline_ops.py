"""Polyline walk primitives as vectorized masked-array ops.

JAX-native replacement for the reference's sequential per-segment walks
(reference: src/edgegraph3d/plgs/polyline_graph_2d.cpp:560-790 —
next_pl_point_by_distance, next_pl_point_by_line_intersection[_bounded_
distance], split_equal_size_intervals; and the segment/line intersection
primitive src/edgegraph3d/utils/geometry/geometric_utilities.cpp:272-430).

A position on a polyline is (seg_idx, t, xy): point = lerp(coords[seg],
coords[seg+1], t).  Direction is +1 (towards the end) or -1 (towards the
start).  Every function below is written for ONE polyline [L,2] with a
valid-count and is vmapped by callers over seeds/views; "first event
along the walk" scans become masked argmin reductions over the L axis.

Matches the reference's event semantics: the first segment in walk order
carrying a quasi-parallel line or an intersection decides the outcome;
bounded-distance violation is checked on that first intersection only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

BIG = 1e30


class PLPoint(NamedTuple):
    seg: jnp.ndarray      # int32 segment index
    t: jnp.ndarray        # float in [0,1] within segment
    xy: jnp.ndarray       # [2] coordinates


def plp_coords(coords: jnp.ndarray, seg: jnp.ndarray,
               t: jnp.ndarray) -> jnp.ndarray:
    a = coords[seg]
    b = coords[jnp.minimum(seg + 1, coords.shape[0] - 1)]
    return a + t[..., None] * (b - a)


# ----------------------------------------------------------------------
# Closest point on a polyline
# ----------------------------------------------------------------------

def closest_point_on_polyline(coords: jnp.ndarray, length: jnp.ndarray,
                              pt: jnp.ndarray):
    """(dist, PLPoint) of the closest point on the polyline to `pt`.

    coords [L,2], length scalar int, pt [2].  Invalid slots -> +inf.
    """
    L = coords.shape[0]
    px = coords[:, 0]
    py = coords[:, 1]
    ax, bx = px[:-1], px[1:]
    ay, by = py[:-1], py[1:]
    seg_valid = jnp.arange(L - 1) < (length - 1)
    ux = bx - ax
    uy = by - ay
    denom = jnp.maximum(ux * ux + uy * uy, 1e-12)
    t = jnp.clip(((pt[0] - ax) * ux + (pt[1] - ay) * uy) / denom, 0.0, 1.0)
    qx = ax + t * ux
    qy = ay + t * uy
    d2 = (pt[0] - qx) ** 2 + (pt[1] - qy) ** 2
    d2 = jnp.where(seg_valid, d2, BIG)
    k = jnp.argmin(d2)
    dist = jnp.sqrt(d2[k])
    return dist, PLPoint(seg=k.astype(jnp.int32), t=t[k],
                         xy=jnp.stack([qx[k], qy[k]]))


# ----------------------------------------------------------------------
# Advance by euclidean radius
# ----------------------------------------------------------------------

class AdvanceResult(NamedTuple):
    plp: PLPoint
    reached_extreme: jnp.ndarray   # bool
    found: jnp.ndarray             # bool


def advance_by_distance(coords: jnp.ndarray, length: jnp.ndarray,
                        plp: PLPoint, direction: jnp.ndarray,
                        radius: float) -> AdvanceResult:
    """[L,2]-coords wrapper over advance_by_distance_xy."""
    return advance_by_distance_xy(coords[:, 0], coords[:, 1], length,
                                  plp, direction, radius)


def advance_by_distance_xy(px: jnp.ndarray, py: jnp.ndarray,
                           length: jnp.ndarray,
                           plp: PLPoint, direction: jnp.ndarray,
                           radius: float) -> AdvanceResult:
    """Next point along the walk at euclidean distance `radius` from the
    current point (parity: next_pl_point_by_distance — the first circle
    crossing in walk order; reaching the extreme first -> flag).

    Component (x/y) math on [L] vectors rather than a trailing
    coordinate dim of 2 (see gauss_newton_batched).  The px/py
    interface lets hot callers gather polylines in the flat [row, 2L]
    layout (x block then y block) — contiguous rows instead of the
    stride-2 nested [L,2] form.  A layout choice, unmeasured on a GPU."""
    L = px.shape[0]
    cx, cy = plp.xy[0], plp.xy[1]
    d2 = (px - cx) ** 2 + (py - cy) ** 2                       # [L]
    idx = jnp.arange(L - 1)
    r2 = radius * radius

    fwd = direction > 0
    # segment k spans coords[k] -> coords[k+1]; in walk order the "far"
    # endpoint is k+1 (fwd) or k (bwd)
    far_d2 = jnp.where(fwd, d2[1:], d2[:-1])
    ahead = jnp.where(fwd, idx >= plp.seg, idx <= plp.seg)
    seg_valid = idx < (length - 1)
    hit = ahead & seg_valid & (far_d2 >= r2)
    any_hit = jnp.any(hit)
    # first hit in walk order
    walk_pos = jnp.where(fwd, idx, -idx)
    k = jnp.argmin(jnp.where(hit, walk_pos, BIG))
    k = k.astype(jnp.int32)

    ax, ay = px[k], py[k]
    ux = px[k + 1] - ax
    uy = py[k + 1] - ay
    fx = ax - cx
    fy = ay - cy
    A = jnp.maximum(ux * ux + uy * uy, 1e-12)
    B = 2.0 * (ux * fx + uy * fy)
    C = fx * fx + fy * fy - r2
    disc = jnp.maximum(B * B - 4 * A * C, 0.0)
    sq = jnp.sqrt(disc)
    # forward root in walk direction: larger s for fwd, smaller for bwd
    s = jnp.where(fwd, (-B + sq) / (2 * A), (-B - sq) / (2 * A))
    s = jnp.clip(s, 0.0, 1.0)
    xy = jnp.stack([ax + s * ux, ay + s * uy])
    new = PLPoint(seg=k, t=s, xy=xy)
    return AdvanceResult(plp=new, reached_extreme=~any_hit, found=any_hit)


# ----------------------------------------------------------------------
# Segment x line intersection (batched over segments)
# ----------------------------------------------------------------------

def _segments_line_intersection_xy(ax, ay, bx, by, line, quasi_cos,
                                   quasi_dist):
    """For segments (ax,ay)->(bx,by) [K] and a normalized line [3],
    return (has_int [K], s [K], quasi [K]) (parity:
    intersect_segment_line_no_quasiparallel,
    geometric_utilities.cpp:272-430).  Component [K]-vector math."""
    sa = ax * line[0] + ay * line[1] + line[2]
    sb = bx * line[0] + by * line[1] + line[2]
    diff = sa - sb
    crosses = (sa * sb) <= 0.0
    parallel = jnp.abs(diff) < 1e-9
    s = jnp.where(parallel, 0.0, sa / jnp.where(parallel, 1.0, diff))
    ux = bx - ax
    uy = by - ay
    ulen = jnp.maximum(jnp.sqrt(ux * ux + uy * uy), 1e-12)
    # line direction is (-line[1], line[0]); cos of angle to segment
    cos = jnp.abs(-ux * line[1] + uy * line[0]) / ulen
    near = jnp.minimum(jnp.abs(sa), jnp.abs(sb)) <= quasi_dist
    quasi = (cos > quasi_cos) & near
    has = crosses & ~parallel & ~quasi
    return has, s, quasi


def _segments_line_intersection(a, b, line, quasi_cos, quasi_dist):
    """[K,2]-endpoint wrapper around _segments_line_intersection_xy."""
    return _segments_line_intersection_xy(
        a[:, 0], a[:, 1], b[:, 0], b[:, 1], line, quasi_cos, quasi_dist)


class IntersectResult(NamedTuple):
    plp: PLPoint
    found: jnp.ndarray
    reached_extreme: jnp.ndarray
    quasiparallel: jnp.ndarray
    bounded_violation: jnp.ndarray


def next_intersection_bounded(coords: jnp.ndarray, length: jnp.ndarray,
                              plp: PLPoint, direction: jnp.ndarray,
                              line: jnp.ndarray,
                              min_dist: float, max_dist: float,
                              quasi_cos: float = 0.965,
                              quasi_dist: float = 5.0) -> IntersectResult:
    """[L,2]-coords wrapper over next_intersection_bounded_xy."""
    return next_intersection_bounded_xy(
        coords[:, 0], coords[:, 1], length, plp, direction, line,
        min_dist, max_dist, quasi_cos, quasi_dist)


def next_intersection_bounded_xy(px: jnp.ndarray, py: jnp.ndarray,
                                 length: jnp.ndarray,
                                 plp: PLPoint, direction: jnp.ndarray,
                                 line: jnp.ndarray,
                                 min_dist: float, max_dist: float,
                                 quasi_cos: float = 0.965,
                                 quasi_dist: float = 5.0
                                 ) -> IntersectResult:
    """First intersection of the walk with an epipolar line; euclidean
    distance from the current point must land in [min_dist, max_dist]
    (parity: next_pl_point_by_line_intersection_bounded_distance,
    polyline_graph_2d.cpp:666-790).  Pass max_dist=inf for the unbounded
    variant (:579-664).  px/py interface: see advance_by_distance_xy."""
    L = px.shape[0]
    idx = jnp.arange(L - 1)
    ax, bx = px[:-1], px[1:]
    ay, by = py[:-1], py[1:]
    has, s, quasi = _segments_line_intersection_xy(
        ax, ay, bx, by, line, quasi_cos, quasi_dist)
    fwd = direction > 0
    seg_valid = idx < (length - 1)
    ahead = jnp.where(fwd, idx >= plp.seg, idx <= plp.seg)
    # the current segment participates only partially: s beyond t
    on_cur = idx == plp.seg
    s_ok = jnp.where(on_cur, jnp.where(fwd, s >= plp.t, s <= plp.t), True)

    event_i = has & ahead & seg_valid & s_ok
    event_q = quasi & ahead & seg_valid
    event = event_i | event_q
    walk_pos = jnp.where(fwd, idx, -idx)
    first = jnp.argmin(jnp.where(event, walk_pos, BIG)).astype(jnp.int32)
    any_event = jnp.any(event)
    is_quasi = event_q[first] & any_event

    sx = ax[first] + s[first] * (bx[first] - ax[first])
    sy = ay[first] + s[first] * (by[first] - ay[first])
    dsq = (sx - plp.xy[0]) ** 2 + (sy - plp.xy[1]) ** 2
    in_bounds = (dsq >= min_dist * min_dist) & (dsq <= max_dist * max_dist)
    found = any_event & ~is_quasi & in_bounds
    violated = any_event & ~is_quasi & ~in_bounds
    return IntersectResult(
        plp=PLPoint(seg=first, t=s[first], xy=jnp.stack([sx, sy])),
        found=found,
        reached_extreme=~any_event,
        quasiparallel=is_quasi,
        bounded_violation=violated,
    )


def polyline_line_intersections(coords: jnp.ndarray, length: jnp.ndarray,
                                line: jnp.ndarray, max_out: int,
                                quasi_cos: float = 0.965,
                                quasi_dist: float = 5.0):
    """All intersections of a polyline with a line, up to `max_out`
    (used by the edge manager's epipolar correspondence detection,
    parity: SegmentEdgeManager-style epipolar intersection collection,
    plg_edge_manager.cpp:208-259).

    Returns (xy [max_out,2], seg [max_out], t [max_out], valid [max_out]).
    """
    L = coords.shape[0]
    idx = jnp.arange(L - 1)
    a = coords[:-1]
    b = coords[1:]
    has, s, _ = _segments_line_intersection(a, b, line, quasi_cos,
                                            quasi_dist)
    seg_valid = idx < (length - 1)
    ok = has & seg_valid
    xy = a + s[:, None] * (b - a)
    # stable-compact the first max_out hits
    order = jnp.argsort(jnp.where(ok, idx, L * 2))[:max_out]
    valid = ok[order]
    return xy[order], order.astype(jnp.int32), s[order], valid


# ----------------------------------------------------------------------
# Interval sampling
# ----------------------------------------------------------------------

def sample_interval_points(coords: jnp.ndarray, length: jnp.ndarray,
                           spacing: float, max_samples: int):
    """Points along the polyline at euclidean `spacing` from each other,
    starting at the first coord (parity: split_equal_size_intervals,
    polyline_graph_2d.cpp:568-577 — repeated next_pl_point_by_distance).

    Returns (xy [max_samples,2], seg [max_samples], t [max_samples],
    valid [max_samples]).  Implemented as a bounded scan of
    advance_by_distance.
    """
    def step(carry, _):
        plp, alive = carry
        res = advance_by_distance(coords, length, plp, jnp.int32(1), spacing)
        alive_new = alive & res.found
        plp_new = PLPoint(
            seg=jnp.where(alive_new, res.plp.seg, plp.seg),
            t=jnp.where(alive_new, res.plp.t, plp.t),
            xy=jnp.where(alive_new, res.plp.xy, plp.xy))
        return (plp_new, alive_new), (plp_new, alive_new)

    first = PLPoint(seg=jnp.int32(0), t=jnp.float32(0.0), xy=coords[0])
    (_, _), (plps, alive) = jax.lax.scan(
        step, (first, length >= 2), None, length=max_samples - 1)
    xy = jnp.concatenate([first.xy[None], plps.xy], axis=0)
    seg = jnp.concatenate([first.seg[None], plps.seg], axis=0)
    t = jnp.concatenate([first.t[None], plps.t], axis=0)
    valid = jnp.concatenate([(length >= 2)[None], alive], axis=0)
    return xy, seg, t, valid
