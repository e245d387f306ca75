"""Debug-image rendering.

Equivalent of the reference's drawing utilities
(reference: src/edgegraph3d/utils/drawing_utilities.cpp:53-1191,
include/edgegraph3d/utils/drawing_utilities.hpp:185-259), saved under
the working folder when `-i` is passed (edge_matcher.cpp:89-96,138-143;
pipelines.cpp:84-89,128-135):

  plgs_imgs_*        PLGs colored per polyline        (draw_plgs)
  plgs_comp_*        PLGs colored per component       (draw_plgs by comp)
  pmsg_* / pmctr_*   stage-1 / stage-2 match sets     (pipelines.cpp:84,128)
  output_on_imgs_*   reprojected output points on RGB (edge_matcher.cpp:138)
  output_on_plgs_*   reprojected output over the PLGs (edge_matcher.cpp:141)
  epipolar_*         refpoint + epipolar-line process (draw_*epipolar*)

All rasterization is plain numpy on host — these are offline debug
artifacts, not a compute path.
"""

from __future__ import annotations

import os

import numpy as np

from edgegraph3d_tpu.core.sfm import SfMData
from edgegraph3d_tpu.io.png import write_png
from edgegraph3d_tpu.plgs.polyline_graph import PLGStack

_PALETTE = np.asarray([
    [230, 80, 80], [80, 200, 90], [90, 120, 240], [240, 200, 70],
    [200, 90, 220], [80, 210, 210], [240, 140, 60], [150, 230, 90],
    [240, 90, 150], [110, 110, 240], [90, 230, 160], [230, 230, 110],
], dtype=np.uint8)


def _color(i: int) -> np.ndarray:
    return _PALETTE[int(i) % len(_PALETTE)]


def _draw_line(img: np.ndarray, a, b, color) -> None:
    h, w = img.shape[:2]
    n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(a[0] + (b[0] - a[0]) * t).astype(int)
    ys = np.round(a[1] + (b[1] - a[1]) * t).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _draw_cross(img: np.ndarray, xy, color, r: int = 2) -> None:
    h, w = img.shape[:2]
    x, y = int(round(xy[0])), int(round(xy[1]))
    for d in range(-r, r + 1):
        if 0 <= y + d < h and 0 <= x < w:
            img[y + d, x] = color
        if 0 <= y < h and 0 <= x + d < w:
            img[y, x + d] = color


def _draw_circle(img: np.ndarray, xy, radius: float, color) -> None:
    h, w = img.shape[:2]
    n = max(int(2 * np.pi * radius), 8)
    ang = np.linspace(0, 2 * np.pi, n)
    xs = np.round(xy[0] + radius * np.cos(ang)).astype(int)
    ys = np.round(xy[1] + radius * np.sin(ang)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _draw_infinite_line(img: np.ndarray, line, color) -> None:
    """line = (a, b, c) with ax + by + c = 0, clipped to the image."""
    h, w = img.shape[:2]
    a, b, c = float(line[0]), float(line[1]), float(line[2])
    pts = []
    if abs(b) > 1e-12:
        for x in (0.0, w - 1.0):
            y = -(a * x + c) / b
            if -1 <= y <= h:
                pts.append((x, y))
    if abs(a) > 1e-12:
        for y in (0.0, h - 1.0):
            x = -(b * y + c) / a
            if -1 <= x <= w:
                pts.append((x, y))
    if len(pts) >= 2:
        _draw_line(img, pts[0], pts[-1], color)


def _draw_polyline(img: np.ndarray, coords: np.ndarray, color) -> None:
    for k in range(len(coords) - 1):
        _draw_line(img, coords[k], coords[k + 1], color)


def _base_images(sfmd: SfMData, rgb_images: np.ndarray | None,
                 width: int, height: int) -> np.ndarray:
    V = sfmd.n_cameras
    if rgb_images is not None:
        imgs = np.asarray(rgb_images)
        if imgs.ndim == 3:          # grayscale / binary stack
            imgs = np.repeat(imgs[..., None], 3, axis=-1)
        if imgs.dtype != np.uint8:
            imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        return imgs.copy()
    return np.zeros((V, height, width, 3), dtype=np.uint8)


def draw_plgs(stack: PLGStack, width: int, height: int,
              color_by: str = "polyline") -> np.ndarray:
    """[V,H,W,3] images of the polyline graphs, colored per polyline,
    per connected component, or per individual segment (parity:
    draw_plgs / draw_MultiColorPolyLines_PolyLineGraph_simplified /
    draw_MultiColorComponents_PolyLineGraph_simplified /
    draw_MultiColorSegments_PolyLineGraph_simplified,
    drawing_utilities.cpp:989-1078)."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    comp = None
    if color_by == "component":
        comp = [stack.view(v).components() for v in range(V)]
    for v in range(V):
        for p in np.flatnonzero(stack.valid[v]):
            c = stack.coords[v, p, : stack.length[v, p]]
            if color_by == "segment":
                for k in range(len(c) - 1):
                    _draw_line(out[v], c[k], c[k + 1],
                               _color(p * 131 + k))
            else:
                key = comp[v][p] if comp is not None else p
                _draw_polyline(out[v], c, _color(key))
    return out


def draw_sfmd_points(sfmd: SfMData, width: int, height: int,
                     first_point: int = 0,
                     rgb_images: np.ndarray | None = None) -> np.ndarray:
    """Reprojections of points [first_point:] on every view (parity:
    draw_sfmd_points*, drawing_utilities.hpp:251)."""
    out = _base_images(sfmd, rgb_images, width, height)
    for i in range(first_point, sfmd.n_points):
        color = _color(i)
        for c, xy in zip(sfmd.obs_cam[i],
                         np.asarray(sfmd.obs_xy[i]).reshape(-1, 2)):
            _draw_cross(out[int(c)], xy, color)
    return out


def draw_match_sets(groups, stack: PLGStack, width: int,
                    height: int) -> np.ndarray:
    """Stage-1/2 match visualization: every (view, polyline) of a match
    set shares one color across views (parity: the pmsg_* / pmctr_*
    images, pipelines.cpp:84-89,128-135)."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    for g, pairs in enumerate(groups):
        color = _color(g)
        for v, p in np.asarray(pairs):
            if p < stack.coords.shape[1] and stack.valid[int(v), int(p)]:
                c = stack.coords[int(v), int(p),
                                 : stack.length[int(v), int(p)]]
                _draw_polyline(out[int(v)], c, color)
    return out


def draw_epipolar_process(sfmd: SfMData, F_table: np.ndarray,
                          refpoint: int, width: int, height: int,
                          starting_dist: float = 10.0,
                          stack: PLGStack | None = None) -> np.ndarray:
    """One refpoint's detection geometry on every viewing cam: the
    observation (cross), the search radius (circle), and the epipolar
    lines induced by the other views' observations (parity: the
    draw_*epipolar* family, drawing_utilities.hpp:200-240)."""
    V = sfmd.n_cameras
    base = (draw_plgs(stack, width, height) if stack is not None
            else np.zeros((V, height, width, 3), dtype=np.uint8))
    cams = [int(c) for c in sfmd.obs_cam[refpoint]]
    obs = {int(c): np.asarray(xy) for c, xy in
           zip(sfmd.obs_cam[refpoint],
               np.asarray(sfmd.obs_xy[refpoint]).reshape(-1, 2))}
    white = np.asarray([255, 255, 255], np.uint8)
    for v in cams:
        for u in cams:
            if u == v:
                continue
            xh = np.asarray([obs[u][0], obs[u][1], 1.0])
            line = F_table[u, v] @ xh
            _draw_infinite_line(base[v], line, _color(u))
    for v in cams:   # query markers on top (epipolar lines pass through)
        _draw_cross(base[v], obs[v], white, r=4)
        _draw_circle(base[v], obs[v], starting_dist, white)
    return base


_JIT_STARTS = None
_JIT_CORR = None


def draw_detection_process(sfmd: SfMData, ctx, refpoint: int,
                           width: int, height: int,
                           stack: PLGStack | None = None) -> np.ndarray:
    """One refpoint's DETECTED candidates on every viewing cam: starting
    intersections (yellow crosses inside the 10 px circle) and epipolar
    correspondence candidates (magenta crosses on the candidates'
    polylines) — the stage-3 detection state the reference renders with
    its epipolar-process image family (parity:
    drawing_utilities.hpp:200-240 detected-intersections variants,
    fed by PLGEdgeManager::detect_nearby_intersections_and_
    correspondences_plgp, plg_edge_manager.cpp:261-300)."""
    import jax
    import jax.numpy as jnp

    from edgegraph3d_tpu.matching import detection
    global _JIT_STARTS, _JIT_CORR
    if _JIT_STARTS is None:
        # jitted ONCE — a fresh jax.jit wrapper per loop iteration would
        # retrace O(cams^2 x candidates) times per image suite
        _JIT_STARTS = jax.jit(detection.detect_starting_intersections,
                              static_argnames=("M",))
        _JIT_CORR = jax.jit(detection.detect_epipolar_correspondences,
                            static_argnames=("M",))
    cfg = ctx.config
    V = sfmd.n_cameras
    base = (draw_plgs(stack, width, height) if stack is not None
            else np.zeros((V, height, width, 3), dtype=np.uint8))
    cams = [int(c) for c in sfmd.obs_cam[refpoint]]
    obs = {int(c): np.asarray(xy) for c, xy in
           zip(sfmd.obs_cam[refpoint],
               np.asarray(sfmd.obs_xy[refpoint]).reshape(-1, 2))}
    yellow = np.asarray([250, 220, 60], np.uint8)
    magenta = np.asarray([240, 80, 240], np.uint8)
    white = np.asarray([255, 255, 255], np.uint8)
    F = np.asarray(ctx.F_table)
    for v in cams:
        pt = jnp.asarray(obs[v], jnp.float32)
        starts = _JIT_STARTS(
            ctx.grids[v], pt, ctx.cell,
            cfg.detection_starting_dist_px, 4)
        s_xy = np.asarray(starts.xy)
        s_ok = np.asarray(starts.valid)
        s_dist = np.asarray(starts.dist)
        for k in np.flatnonzero(s_ok):
            _draw_cross(base[v], s_xy[k], yellow, r=3)
            # correspondence candidates on the other cams
            radius = min(s_dist[k] * cfg.detection_correspondence_factor,
                         3.0 * cfg.detection_starting_dist_px)
            xh = np.asarray([s_xy[k][0], s_xy[k][1], 1.0])
            for u in cams:
                if u == v:
                    continue
                line = F[v, u] @ xh
                n = np.hypot(line[0], line[1])
                if n < 1e-12:
                    continue
                line = line / n
                corr = _JIT_CORR(
                    ctx.grids[u],
                    jnp.asarray(obs[u], jnp.float32),
                    jnp.asarray(line, jnp.float32), ctx.cell,
                    jnp.float32(max(radius,
                                    cfg.detection_starting_dist_px * 0.3)),
                    4)
                c_xy = np.asarray(corr.xy)
                for j in np.flatnonzero(np.asarray(corr.valid)):
                    _draw_cross(base[u], c_xy[j], magenta, r=2)
    for v in cams:
        _draw_cross(base[v], obs[v], white, r=4)
        _draw_circle(base[v], obs[v], cfg.detection_starting_dist_px,
                     white)
    return base


def draw_claimed_intervals(manager, stack: PLGStack, width: int,
                           height: int) -> np.ndarray:
    """Claimed-interval overlay: every polyline in dim gray, claimed
    arc buckets (the MatchesManager raster) in red (parity: the
    matched-interval state the reference inspects through
    PLGMatchesManager — the single most diagnostic view of the dedup /
    suppression machinery, plg_matches_manager.cpp:54-93)."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    gray = np.asarray([90, 90, 90], np.uint8)
    red = np.asarray([255, 60, 60], np.uint8)
    B = manager.B
    for v in range(V):
        for p in np.flatnonzero(stack.valid[v]):
            n = int(stack.length[v, p])
            c = stack.coords[v, p, :n]
            _draw_polyline(out[v], c, gray)
            claimed = manager.raster[v, p]
            if not claimed.any():
                continue
            # map claimed buckets back to coord positions
            for k in range(n - 1):
                b0 = int(k * B / max(n - 1, 1))
                b1 = int((k + 1) * B / max(n - 1, 1))
                if claimed[b0: max(b1, b0 + 1)].any():
                    _draw_line(out[v], c[k], c[k + 1], red)
    return out


def draw_plgs_by_community(stack: PLGStack, groups, width: int,
                           height: int) -> np.ndarray:
    """Every view's polylines colored by stage-1 COMMUNITY id; dim gray
    = in no community (parity: the reference's community-colored match
    images used to debug stage-1 recall,
    drawing_utilities.cpp:53-1191 draw_* family + pipelines.cpp:84-89).
    A gray edge that should be reconstructed marks a similarity-graph
    or community-detection miss."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    gray = np.asarray([70, 70, 70], np.uint8)
    for v in range(V):
        for p in np.flatnonzero(stack.valid[v]):
            c = stack.coords[v, p, : stack.length[v, p]]
            _draw_polyline(out[v], c, gray)
    for g, pairs in enumerate(groups or []):
        color = _color(g)
        for v, p in np.asarray(pairs):
            v, p = int(v), int(p)
            if p < stack.coords.shape[1] and stack.valid[v, p]:
                c = stack.coords[v, p, : stack.length[v, p]]
                _draw_polyline(out[v], c, color)
    return out


def _arc_samples(coords: np.ndarray, spacing: float) -> np.ndarray:
    """Points every `spacing` px of arc length along a polyline."""
    if len(coords) < 2:
        return coords
    seg = np.linalg.norm(np.diff(coords, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    targets = np.arange(0.0, cum[-1] + 1e-6, spacing)
    idx = np.searchsorted(cum, targets, side="right") - 1
    idx = np.clip(idx, 0, len(seg) - 1)
    t = (targets - cum[idx]) / np.maximum(seg[idx], 1e-9)
    return coords[idx] + t[:, None] * (coords[idx + 1] - coords[idx])


def draw_match_set_epipolars(F_table: np.ndarray, stack: PLGStack,
                             match_set, width: int, height: int,
                             interval_px: float = 20.0) -> np.ndarray:
    """Per-polyline-match epipolar overlay for ONE stage-1/2 match set:
    each matched polyline's 20 px interval points (the stage driver's
    actual seeds, polyline_matching.hpp:51) send their epipolar lines
    into every other view of the set, colored by SOURCE view; the
    set's own polylines are white.  The reference's key stage-1 recall
    oracle (drawing_utilities.cpp epipolar match visualizations +
    find_epipolar_correspondences, polyline_matching.cpp:45): a white
    polyline missed by all incoming colored lines explains a seed
    failure."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    pairs = np.asarray(match_set)
    views = sorted(set(int(v) for v, _ in pairs))
    white = np.asarray([255, 255, 255], np.uint8)
    for v, p in pairs:
        v, p = int(v), int(p)
        if p >= stack.coords.shape[1] or not stack.valid[v, p]:
            continue
        coords = stack.coords[v, p, : stack.length[v, p]]
        for q in _arc_samples(coords, interval_px):
            xh = np.asarray([q[0], q[1], 1.0])
            for u in views:
                if u == v:
                    continue
                _draw_infinite_line(out[u], F_table[v, u] @ xh,
                                    _color(v))
    for v, p in pairs:
        v, p = int(v), int(p)
        if p < stack.coords.shape[1] and stack.valid[v, p]:
            coords = stack.coords[v, p, : stack.length[v, p]]
            _draw_polyline(out[v], coords, white)
    return out


def draw_chains(pts, P_mats: np.ndarray, width: int,
                height: int) -> np.ndarray:
    """Reconstructed 3D chains reprojected per view, one color per
    seed chain (diagnoses following / continuation / extension: breaks
    or color changes mid-edge are truncated or duplicated chains)."""
    V = len(P_mats)
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    if len(pts.X) == 0:
        return out
    order = np.lexsort((pts.chain_order, pts.seed_id))
    Xh = np.concatenate([pts.X, np.ones((len(pts.X), 1))], axis=1)
    for v in range(V):
        pr = Xh @ np.asarray(P_mats[v]).T
        pr = pr[:, :2] / np.maximum(pr[:, 2:3], 1e-9)
        for a, b in zip(order[:-1], order[1:]):
            if pts.seed_id[a] != pts.seed_id[b]:
                continue
            if not (pts.obs_mask[a, v] and pts.obs_mask[b, v]):
                continue
            _draw_line(out[v], pr[a], pr[b], _color(pts.seed_id[a]))
    return out


# ---------------------------------------------------------------------
# Reference primitive + long-tail drawing API.  Thin compositions of the
# rasterizer above, one per reference `draw_*` family
# (drawing_utilities.cpp:53-1191, drawing_utilities.hpp:58-259).  All
# colors are RGB uint8 triples; `img` arguments are [H,W,3] uint8 arrays
# mutated in place, matching the reference's cv::Mat& convention.

WHITE = np.asarray([255, 255, 255], np.uint8)

# DRAW_REFERENCE_POINT_RADIUS / DRAW_INTERSECTION_POINT_RADIUS /
# DRAW_NEW_MATCHED_POINT_RADIUS (drawing_utilities.hpp:58-60)
DRAW_REFERENCE_POINT_RADIUS = 2
DRAW_INTERSECTION_POINT_RADIUS = 2
DRAW_NEW_MATCHED_POINT_RADIUS = DRAW_INTERSECTION_POINT_RADIUS + 1


def _draw_disk(img: np.ndarray, xy, radius: int, color) -> None:
    h, w = img.shape[:2]
    x, y = int(round(xy[0])), int(round(xy[1]))
    r = int(radius)
    y0, y1 = max(y - r, 0), min(y + r + 1, h)
    x0, x1 = max(x - r, 0), min(x + r + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def draw_point(img: np.ndarray, xy, color=WHITE,
               radius: int = DRAW_REFERENCE_POINT_RADIUS) -> None:
    """Filled dot (parity: draw_point/draw_point_glm,
    drawing_utilities.cpp:53-74)."""
    _draw_disk(img, xy, radius, color)


def draw_points(img: np.ndarray, pts, colors=None,
                radius: int = DRAW_REFERENCE_POINT_RADIUS) -> None:
    """Many dots, one shared or per-point color (parity:
    draw_points_glm overloads, drawing_utilities.cpp:76-92)."""
    pts = np.asarray(pts).reshape(-1, 2)
    for i, p in enumerate(pts):
        if colors is None:
            c = _color(i)
        elif np.ndim(colors) == 2:
            c = colors[i]
        else:
            c = colors
        _draw_disk(img, p, radius, c)


def draw_reference_point(img: np.ndarray, xy, color) -> None:
    """(parity: draw_reference_point_glm, drawing_utilities.cpp:94)."""
    _draw_disk(img, xy, DRAW_REFERENCE_POINT_RADIUS, color)


def draw_intersection_point(img: np.ndarray, xy, color) -> None:
    """(parity: draw_intersection_point_glm,
    drawing_utilities.cpp:102)."""
    _draw_disk(img, xy, DRAW_INTERSECTION_POINT_RADIUS, color)


def draw_segment_on_img(img: np.ndarray, segm, color) -> None:
    """segm = (x1, y1, x2, y2) (parity: draw_segment_on_img,
    drawing_utilities.cpp:106-112)."""
    _draw_line(img, segm[:2], segm[2:4], color)


def draw_segments_on_image(img: np.ndarray, segments,
                           colors=None) -> None:
    """colors: None = deterministic per-segment palette (the rnd_colors
    variant), a single RGB triple, or one triple per segment (parity:
    draw_segments_on_image* family, drawing_utilities.cpp:785-843)."""
    segments = np.asarray(segments).reshape(-1, 4)
    for i, s in enumerate(segments):
        if colors is None:
            c = _color(i)
        elif np.ndim(colors) == 2:
            c = colors[i]
        else:
            c = colors
        _draw_line(img, s[:2], s[2:4], c)


def draw_segments_on_newimage(size, segments, colorbg,
                              colorlines) -> np.ndarray:
    """size = (height, width) (parity: draw_segments_on_newimage,
    drawing_utilities.cpp:789)."""
    h, w = size
    img = np.empty((h, w, 3), np.uint8)
    img[:] = colorbg
    draw_segments_on_image(img, segments, colorlines)
    return img


def draw_segments_on_newimage_with_extremes(
        size, segments, colorbg, colorlines, colorstart,
        colorend) -> np.ndarray:
    """Segments plus their start/end extremes as dots (parity:
    draw_segments_on_newimage_with_extremes,
    drawing_utilities.cpp:800)."""
    img = draw_segments_on_newimage(size, segments, colorbg, colorlines)
    for s in np.asarray(segments).reshape(-1, 4):
        _draw_disk(img, s[:2], DRAW_REFERENCE_POINT_RADIUS, colorstart)
        _draw_disk(img, s[2:4], DRAW_REFERENCE_POINT_RADIUS, colorend)
    return img


def draw_line(img: np.ndarray, line, color) -> None:
    """Infinite line (a,b,c): ax+by+c=0, clipped (parity:
    draw_line_glm, drawing_utilities.cpp:114)."""
    _draw_infinite_line(img, line, color)


def draw_lines(img: np.ndarray, lines, colors=None) -> None:
    """(parity: draw_lines_glm, drawing_utilities.cpp:126)."""
    for i, ln in enumerate(np.asarray(lines).reshape(-1, 3)):
        c = _color(i) if colors is None else (
            colors[i] if np.ndim(colors) == 2 else colors)
        _draw_infinite_line(img, ln, c)


def draw_circle(img: np.ndarray, center, radius, color) -> None:
    """(parity: draw_circle_glm, drawing_utilities.cpp:131)."""
    _draw_circle(img, center, radius, color)


def draw_refpoints_on_imgs(sfmd: SfMData, width: int, height: int,
                           point_ids=None, colors=None,
                           radius: float | None = None,
                           radius2: float | None = None,
                           rgb_images: np.ndarray | None = None
                           ) -> np.ndarray:
    """Refpoint observations on every viewing cam; optional one or two
    concentric highlight circles (parity: draw_refpoint[s]_on_imgs /
    _with_circle[s]_on_imgs / draw_setofrefpoints_on_imgs,
    drawing_utilities.cpp:465-535,592-643)."""
    out = _base_images(sfmd, rgb_images, width, height)
    ids = range(sfmd.n_points) if point_ids is None else point_ids
    for i in ids:
        c = _color(i) if colors is None else (
            colors[i] if np.ndim(colors) == 2 else colors)
        for cam, xy in zip(sfmd.obs_cam[i],
                           np.asarray(sfmd.obs_xy[i]).reshape(-1, 2)):
            _draw_disk(out[int(cam)], xy, DRAW_REFERENCE_POINT_RADIUS, c)
            if radius is not None:
                _draw_circle(out[int(cam)], xy, radius, c)
            if radius2 is not None:
                _draw_circle(out[int(cam)], xy, radius2, c)
    return out


def draw_img_pair_refpoints(sfmd: SfMData, i: int, j: int, width: int,
                            height: int,
                            rgb_images: np.ndarray | None = None
                            ) -> np.ndarray:
    """[2,H,W,3]: the refpoints visible in BOTH cams i and j, same color
    in both (parity: draw_img_pair_refpoints,
    drawing_utilities.cpp:646)."""
    out = _base_images(sfmd, rgb_images, width, height)[[i, j]]
    for pid in _common_refpoints(sfmd, i, j):
        c = _color(pid)
        for k, cam in enumerate((i, j)):
            xy = _obs_in_cam(sfmd, pid, cam)
            _draw_disk(out[k], xy, DRAW_REFERENCE_POINT_RADIUS, c)
    return out


def _common_refpoints(sfmd: SfMData, i: int, j: int):
    return [p for p in range(sfmd.n_points)
            if i in set(map(int, sfmd.obs_cam[p]))
            and j in set(map(int, sfmd.obs_cam[p]))]


def _obs_in_cam(sfmd: SfMData, pid: int, cam: int) -> np.ndarray:
    xys = np.asarray(sfmd.obs_xy[pid]).reshape(-1, 2)
    for c, xy in zip(sfmd.obs_cam[pid], xys):
        if int(c) == cam:
            return xy
    raise KeyError((pid, cam))


def draw_img_pair_epipolars_refpoints(
        sfmd: SfMData, F_table: np.ndarray, i: int, j: int, width: int,
        height: int, rgb_images: np.ndarray | None = None) -> np.ndarray:
    """[2,H,W,3]: common refpoints of cams (i, j) plus each point's
    epipolar line in the OTHER image, matching colors (parity:
    draw_img_pair_epipolars_refpoints, drawing_utilities.cpp:660)."""
    out = draw_img_pair_refpoints(sfmd, i, j, width, height, rgb_images)
    for pid in _common_refpoints(sfmd, i, j):
        c = _color(pid)
        xi, xj = _obs_in_cam(sfmd, pid, i), _obs_in_cam(sfmd, pid, j)
        _draw_infinite_line(
            out[1], F_table[i, j] @ np.asarray([xi[0], xi[1], 1.0]), c)
        _draw_infinite_line(
            out[0], F_table[j, i] @ np.asarray([xj[0], xj[1], 1.0]), c)
    return out


def draw_point_epipolars_on_imgs(sfmd: SfMData, F_table: np.ndarray,
                                 xy, starting_img: int, width: int,
                                 height: int, color=WHITE,
                                 rgb_images: np.ndarray | None = None
                                 ) -> np.ndarray:
    """A 2D point in `starting_img` and its epipolar line in every other
    view (parity: draw_point_epipolars_on_imgs /
    draw_refpoint_epipolars_on_imgs, drawing_utilities.cpp:610-628)."""
    out = _base_images(sfmd, rgb_images, width, height)
    _draw_disk(out[starting_img], xy, DRAW_REFERENCE_POINT_RADIUS, color)
    xh = np.asarray([xy[0], xy[1], 1.0])
    for v in range(sfmd.n_cameras):
        if v != starting_img:
            _draw_infinite_line(out[v], F_table[starting_img, v] @ xh,
                                color)
    return out


def draw_point_projections(imgs: np.ndarray, coords, cameras,
                           color=None) -> None:
    """2D coords onto their cameras' images, in place (parity:
    draw_point_projections, drawing_utilities.cpp:540-577)."""
    coords = np.asarray(coords, float).reshape(-1, 2)
    for k, (xy, cam) in enumerate(zip(coords, cameras)):
        _draw_disk(imgs[int(cam)], xy, DRAW_NEW_MATCHED_POINT_RADIUS,
                   _color(k) if color is None else color)


def draw_3dpoints_on_imgs(imgs: np.ndarray, p3ds,
                          color=None) -> None:
    """p3ds: iterable of (X, coords_2d, cam_ids) observation tuples —
    the reference's new-point triple (parity: draw_3dpoint[s]_on_imgs /
    draw_new_consensus_points / draw_consensus_matched_points,
    drawing_utilities.cpp:553-587,460-463,759-783)."""
    for k, (_, coords, cams) in enumerate(p3ds):
        draw_point_projections(
            imgs, coords, cams, _color(k) if color is None else color)


def draw_plgs_bw(stack: PLGStack, width: int, height: int) -> np.ndarray:
    """White polylines on black (parity: draw_plgs_bw,
    drawing_utilities.cpp:1162)."""
    V = stack.n_views
    out = np.zeros((V, height, width, 3), dtype=np.uint8)
    for v in range(V):
        for p in np.flatnonzero(stack.valid[v]):
            c = stack.coords[v, p, : stack.length[v, p]]
            _draw_polyline(out[v], c, WHITE)
    return out


def draw_polyline_graph_simplified(img: np.ndarray, stack: PLGStack,
                                   view: int, color) -> None:
    """Single-color overlay of one view's PLG onto `img`, in place
    (parity: draw_polyline_graph_simplified /
    draw_PolyLineGraph_simplified_overlay,
    drawing_utilities.cpp:1080-1114)."""
    for p in np.flatnonzero(stack.valid[view]):
        c = stack.coords[view, p, : stack.length[view, p]]
        _draw_polyline(img, c, color)


def draw_colored_components_and_edge_refpoints(
        stack: PLGStack, sfmd: SfMData, width: int, height: int,
        first_edgepoint: int = 0) -> np.ndarray:
    """Component-colored PLGs with the edge refpoints' observations
    overlaid white (parity: draw_colored_components_and_edge_refpoints,
    drawing_utilities.cpp:1123)."""
    out = draw_plgs(stack, width, height, color_by="component")
    for i in range(first_edgepoint, sfmd.n_points):
        for cam, xy in zip(sfmd.obs_cam[i],
                           np.asarray(sfmd.obs_xy[i]).reshape(-1, 2)):
            _draw_disk(out[int(cam)], xy, DRAW_REFERENCE_POINT_RADIUS,
                       WHITE)
    return out


# The reference's stage-1 output renderer takes the same
# (view, polyline)-set structure as our match sets
# (parity: draw_polyline_matches, drawing_utilities.cpp:1136).
draw_polyline_matches = draw_match_sets


def draw_and_write_focus_image(sfmd: SfMData, F_table: np.ndarray,
                               refpoint: int, starting_img: int,
                               counter: int, folder: str, width: int,
                               height: int,
                               stack: PLGStack | None = None) -> str:
    """One refpoint's epipolar process written as the reference's
    numbered focus image (parity: draw_and_write_focus_image,
    drawing_utilities.cpp:1147-1153)."""
    os.makedirs(folder, exist_ok=True)
    imgs = draw_epipolar_process(sfmd, F_table, refpoint, width, height,
                                 stack=stack)
    path = os.path.join(
        folder, f"focus_{counter:06d}_p{refpoint}_s{starting_img}.png")
    write_png(path, imgs[starting_img])
    return path


def save_debug_images(sfmd: SfMData, folder: str,
                      stack: PLGStack | None = None,
                      first_edgepoint: int = 0,
                      rgb_images: np.ndarray | None = None,
                      groups_stage1=None, groups_stage2=None,
                      F_table: np.ndarray | None = None,
                      epipolar_refpoints=(), manager=None,
                      edge_points=None,
                      P_mats: np.ndarray | None = None,
                      ctx=None) -> None:
    """Write the full `-i` debug-image suite into `folder`."""
    os.makedirs(folder, exist_ok=True)
    W = int(sfmd.widths.max())
    H = int(sfmd.heights.max())

    def save(prefix, imgs):
        for v, img in enumerate(imgs):
            write_png(os.path.join(folder, f"{prefix}_{v:04d}.png"), img)

    if stack is not None:
        save("plgs_imgs", draw_plgs(stack, W, H))
        save("plgs_comp", draw_plgs(stack, W, H, color_by="component"))
        out_on_plgs = draw_plgs(stack, W, H)
        for i in range(first_edgepoint, sfmd.n_points):
            for c, xy in zip(sfmd.obs_cam[i],
                             np.asarray(sfmd.obs_xy[i]).reshape(-1, 2)):
                _draw_cross(out_on_plgs[int(c)], xy, [255, 255, 255])
        save("output_on_plgs", out_on_plgs)
    save("output_on_imgs",
         draw_sfmd_points(sfmd, W, H, first_edgepoint, rgb_images))
    if groups_stage1 and stack is not None:
        save("pmsg", draw_match_sets(groups_stage1, stack, W, H))
        save("pmsg_comm",
             draw_plgs_by_community(stack, groups_stage1, W, H))
        if F_table is not None:
            for g, ms in enumerate(groups_stage1[:3]):
                imgs = draw_match_set_epipolars(
                    np.asarray(F_table), stack, ms, W, H)
                for v, img in enumerate(imgs):
                    write_png(os.path.join(
                        folder, f"pmsg_epi_{g:03d}_{v:04d}.png"), img)
    if groups_stage2 and stack is not None:
        save("pmctr", draw_match_sets(groups_stage2, stack, W, H))
    if manager is not None and stack is not None:
        save("claimed_intervals",
             draw_claimed_intervals(manager, stack, W, H))
    if edge_points is not None and P_mats is not None:
        save("chains", draw_chains(edge_points, P_mats, W, H))
    if F_table is not None and stack is not None:
        for r in epipolar_refpoints:
            imgs = draw_epipolar_process(sfmd, np.asarray(F_table), r,
                                         W, H, stack=stack)
            for v, img in enumerate(imgs):
                write_png(os.path.join(
                    folder, f"epipolar_{r:05d}_{v:04d}.png"), img)
    if ctx is not None and stack is not None:
        for r in epipolar_refpoints:
            imgs = draw_detection_process(sfmd, ctx, r, W, H,
                                          stack=stack)
            for v, img in enumerate(imgs):
                write_png(os.path.join(
                    folder, f"detection_{r:05d}_{v:04d}.png"), img)
