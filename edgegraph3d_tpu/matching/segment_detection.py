"""Segment-soup edge detection (the legacy edge-manager family).

JAX-native replacement for the reference's segment-based edge managers
(reference: include/edgegraph3d/edge_managers/segment_edge_manager.hpp:56-91
and src/edgegraph3d/edge_managers/{segment_edge_manager.cpp,
input_segments_edge_manager.cpp, segmented_edge_images_edge_manager.cpp,
segment_edge_manager_detect_non_intersections.cpp}).  Where the
production `PLGEdgeManager` works on polyline graphs, this family works
on a flat per-view "segment soup":

  * `SegmentSoup`             — padded [V, S, 4] segment tensor + mask
                                (reference: `all_segments`,
                                 segment_edge_manager.hpp:76)
  * `soup_from_plg_stack`     — segments from extracted edge images via
                                the PLG decomposition (parity:
                                SegmentedEdgeImagesEdgeManager, whose
                                detect_edges derives segments from the
                                edge images)
  * `soup_from_segment_lists` — caller-provided segments (parity:
                                InputSegmentsEdgeManager,
                                input_segments_edge_manager.cpp:9-13)
  * `nearby_segment_points`   — closest projections on segments within a
                                starting radius (parity:
                                find_closest_segment_projection /
                                detect_nearby_edge_intersections)
  * `epipolar_segment_intersections` — segment x epipolar-line crossings
                                with a closest-approach fallback within
                                MAX_CLOSE_POINT_DISTANCE = 1 px (parity:
                                SEGMENT_EDGE_MANAGER_SELECT_CLOSE_POINTS_ENABLED,
                                segment_edge_manager.hpp:23-27)
  * `circle_segment_intersections` — points where segments cross the
                                detection circle (parity: the
                                DetectNonIntersections variant's nearby
                                detection, which collects
                                detect_circle_segment_intersections over
                                all segments,
                                segment_edge_manager_detect_non_intersections.cpp:79-96)

Everything is dense and fixed-shape: one query is a [S]-wide masked
reduction over the view's whole soup (no grid needed — soups are small),
and callers vmap over (refpoint, view) batches exactly as with
`matching.detection`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from edgegraph3d_tpu.matching.grid import BIG
from edgegraph3d_tpu.plgs.polyline_graph import PLGStack


class SegmentSoup(NamedTuple):
    """Per-view flat segment lists, padded to a common S."""
    seg: np.ndarray     # [V, S, 4] float32 — x1, y1, x2, y2
    valid: np.ndarray   # [V, S] bool


def soup_from_segment_lists(segments: Sequence[np.ndarray],
                            max_segments: int | None = None) -> SegmentSoup:
    """Build a soup from per-view [S_v, 4] arrays (InputSegments parity)."""
    n_views = len(segments)
    S = max_segments or max((len(s) for s in segments), default=1)
    S = max(S, 1)
    seg = np.zeros((n_views, S, 4), np.float32)
    valid = np.zeros((n_views, S), bool)
    for v, s in enumerate(segments):
        s = np.asarray(s, np.float32).reshape(-1, 4)[:S]
        seg[v, : len(s)] = s
        valid[v, : len(s)] = True
    return SegmentSoup(seg=seg, valid=valid)


def soup_from_plg_stack(stack: PLGStack,
                        max_segments: int | None = None) -> SegmentSoup:
    """Decompose each view's polylines into their segments
    (SegmentedEdgeImagesEdgeManager parity — edge images -> segments,
    here via the already-extracted PLGs)."""
    a = stack.coords[:, :, :-1, :]                      # [V,P,L-1,2]
    b = stack.coords[:, :, 1:, :]
    idx = np.arange(a.shape[2])[None, None, :]
    mask = idx < (stack.length[:, :, None] - 1)         # [V,P,L-1]
    segs, V = [], stack.coords.shape[0]
    for v in range(V):
        m = mask[v]
        segs.append(np.concatenate([a[v][m], b[v][m]], axis=-1))
    return soup_from_segment_lists(segs, max_segments=max_segments)


class SegmentHits(NamedTuple):
    """Fixed-width per-query hit list on a segment soup."""
    xy: jnp.ndarray       # [M, 2] hit coordinates
    seg_idx: jnp.ndarray  # [M] int32 index into the soup, -1 if invalid
    extremes: jnp.ndarray  # [M, 4] the hit segment's endpoints
    dist: jnp.ndarray     # [M] distance to the query point
    valid: jnp.ndarray    # [M] bool


def _top_m(dist: jnp.ndarray, xy: jnp.ndarray, seg: jnp.ndarray,
           M: int) -> SegmentHits:
    """M closest hits (distinct segments) by successive masked argmin."""
    idx_all = jnp.arange(dist.shape[0], dtype=jnp.int32)
    out_xy, out_i, out_d, out_ok = [], [], [], []
    d = dist
    for _ in range(M):
        i = jnp.argmin(d)
        di = d[i]
        ok = di < BIG / 2
        out_xy.append(xy[i])
        out_i.append(jnp.where(ok, idx_all[i], -1))
        out_d.append(di)
        out_ok.append(ok)
        d = d.at[i].set(BIG)
    ok = jnp.stack(out_ok)
    ii = jnp.stack(out_i)
    return SegmentHits(
        xy=jnp.where(ok[:, None], jnp.stack(out_xy), 0.0),
        seg_idx=ii,
        extremes=jnp.where(ok[:, None], seg[jnp.maximum(ii, 0)], 0.0),
        dist=jnp.where(ok, jnp.stack(out_d), BIG),
        valid=ok,
    )


def nearby_segment_points(seg: jnp.ndarray, valid: jnp.ndarray,
                          pt: jnp.ndarray, starting_dist: float,
                          M: int = 4) -> SegmentHits:
    """Closest projections of `pt` onto nearby segments, within
    `starting_dist` (parity: detect_nearby_edge_intersections +
    find_closest_segment_projection, segment_edge_manager.hpp:46,53).

    seg [S,4], valid [S], pt [2] -> top-M hits.
    """
    a, b = seg[:, :2], seg[:, 2:]
    ab = b - a
    den = jnp.maximum(jnp.sum(ab * ab, axis=-1), 1e-12)
    t = jnp.clip(jnp.sum((pt - a) * ab, axis=-1) / den, 0.0, 1.0)
    proj = a + t[:, None] * ab
    d = jnp.linalg.norm(proj - pt, axis=-1)
    d = jnp.where(valid & (d <= starting_dist), d, BIG)
    return _top_m(d, proj, seg, M)


def epipolar_segment_intersections(seg: jnp.ndarray, valid: jnp.ndarray,
                                   obs_pt: jnp.ndarray, line: jnp.ndarray,
                                   radius: jnp.ndarray | float,
                                   M: int = 4,
                                   close_point_dist: float = 1.0
                                   ) -> SegmentHits:
    """Segment x epipolar-line intersections within `radius` of `obs_pt`.

    When a segment does not cross the line but approaches it within
    `close_point_dist`, its closest point to the line is reported
    instead (parity: the SELECT_CLOSE_POINTS behavior with
    MAX_CLOSE_POINT_DISTANCE 1, segment_edge_manager.hpp:23-27) — the
    key recall trick for segments nearly parallel to the epipolar line.

    seg [S,4], valid [S], obs_pt [2], line [3] normalized (a,b,c).
    """
    a, b = seg[:, :2], seg[:, 2:]
    sa = a[:, 0] * line[0] + a[:, 1] * line[1] + line[2]   # signed dists
    sb = b[:, 0] * line[0] + b[:, 1] * line[1] + line[2]
    diff = sa - sb
    parallel = jnp.abs(diff) < 1e-9
    t = jnp.where(parallel, 0.0, sa / jnp.where(parallel, 1.0, diff))
    crosses = (sa * sb <= 0.0) & ~parallel & (t >= 0.0) & (t <= 1.0)
    hit_cross = a + jnp.clip(t, 0.0, 1.0)[:, None] * (b - a)
    # closest-approach fallback: endpoint with the smaller |signed dist|
    use_a = jnp.abs(sa) <= jnp.abs(sb)
    close_d = jnp.where(use_a, jnp.abs(sa), jnp.abs(sb))
    hit_close = jnp.where(use_a[:, None], a, b)
    near = ~crosses & (close_d <= close_point_dist)
    hit = jnp.where(crosses[:, None], hit_cross, hit_close)
    ok = valid & (crosses | near)
    d = jnp.linalg.norm(hit - obs_pt, axis=-1)
    d = jnp.where(ok & (d <= radius), d, BIG)
    return _top_m(d, hit, seg, M)


def circle_segment_intersections(seg: jnp.ndarray, valid: jnp.ndarray,
                                 center: jnp.ndarray, radius: float,
                                 M: int = 8) -> SegmentHits:
    """Points where segments cross the circle (center, radius) — the
    DetectNonIntersections variant's nearby detection (parity:
    detect_circle_segment_intersections collected over all segments,
    segment_edge_manager_detect_non_intersections.cpp:79-96; circle
    geometry: geometric_utilities.cpp:124-271).

    Each segment yields up to 2 crossings; both are candidate hits.
    """
    a, b = seg[:, :2], seg[:, 2:]
    d = b - a                                            # [S,2]
    f = a - center
    A = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
    B = 2.0 * jnp.sum(f * d, axis=-1)
    C = jnp.sum(f * f, axis=-1) - radius * radius
    disc = B * B - 4.0 * A * C
    has = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-B - sq) / (2.0 * A)
    t2 = (-B + sq) / (2.0 * A)
    hits, dists = [], []
    for t in (t1, t2):
        in_seg = has & (t >= 0.0) & (t <= 1.0) & valid
        p = a + t[:, None] * d
        dist = jnp.where(in_seg, jnp.linalg.norm(p - center, axis=-1), BIG)
        hits.append(p)
        dists.append(dist)
    xy = jnp.concatenate(hits, axis=0)                   # [2S,2]
    dd = jnp.concatenate(dists, axis=0)
    seg2 = jnp.concatenate([seg, seg], axis=0)
    res = _top_m(dd, xy, seg2, M)
    # the duplicated [2S] array puts second crossings at S + i; fold the
    # index back so seg_idx really indexes the soup (extremes already
    # resolved via the duplicated array)
    S = seg.shape[0]
    folded = jnp.where(res.seg_idx >= 0, res.seg_idx % S, res.seg_idx)
    return SegmentHits(xy=res.xy, seg_idx=folded, extremes=res.extremes,
                       dist=res.dist, valid=res.valid)
