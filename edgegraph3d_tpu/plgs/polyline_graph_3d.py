"""3D polyline graphs: assembly, fragmentation, serialization.

JAX-native replacement for the reference's `PolyLineGraph3D[HMapImpl]`
(reference: include/edgegraph3d/plgs/polyline_graph_3d.hpp:66-252,
src/edgegraph3d/plgs/polyline_graph_3d.cpp, polyline_graph_3d_hmap_impl.cpp:47-193):
same padded struct-of-arrays layout as the 2D graphs but with vec3
coords and per-point 2D observations; chains come straight from the
follow sweeps (EdgePoints.seed_id / chain_order) instead of incremental
`add_direct_connection` node-map updates.  Serialized as npz
("outgraph.3dg" equivalent, reference: pipelines.cpp:233,
global_defines.hpp:44 PLG3D_OUTNAME).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PLG3D:
    """Padded 3D polyline graph with per-point observations."""

    coords: np.ndarray       # [P, L, 3] float32
    length: np.ndarray       # [P] int32
    obs_mask: np.ndarray     # [P, L, V] bool — observing views per point
    obs_xy: np.ndarray       # [P, L, V, 2] float32

    @property
    def n_polylines(self) -> int:
        return int((self.length >= 2).sum())

    @property
    def valid(self) -> np.ndarray:
        return self.length >= 2

    def polyline(self, p: int) -> np.ndarray:
        return self.coords[p, : self.length[p]]

    def total_lengths(self) -> np.ndarray:
        d = np.linalg.norm(np.diff(self.coords, axis=1), axis=-1)
        idx = np.arange(self.coords.shape[1] - 1)[None, :]
        d = d * (idx < (self.length[:, None] - 1))
        return d.sum(axis=1)

    # ------------------------------------------------------------------
    def fragment(self, max_len: float) -> "PLG3D":
        """Resample each polyline at `max_len` arc-length steps
        (parity: PolyLineGraph3D::polyline::fragment,
        polyline_graph_3d.cpp:99-122 — original interior points are
        dropped and replaced by interpolated samples spaced maxlen
        apart along the walk; first/last points are retained).
        Deviation: the reference's ratio = (maxlen-curlen)/(nextlen-
        curlen) blend divides by zero when a sample lands exactly on a
        vertex and extrapolates past the vertex when a step spans
        several segments; we use the well-defined arc-length
        interpolation that walk evidently intends.  Interpolated points
        carry no observations; the retained extremes keep theirs."""
        out_chains, out_obs = [], []
        Vn = self.obs_mask.shape[2]
        no_obs = (np.zeros(Vn, bool), np.zeros((Vn, 2), np.float32))
        for p in np.flatnonzero(self.valid):
            n = int(self.length[p])
            c = self.coords[p, :n].astype(np.float64)
            seg_len = np.linalg.norm(np.diff(c, axis=0), axis=1)
            cum = np.concatenate([[0.0], np.cumsum(seg_len)])
            total = cum[-1]
            n_samp = max(int(np.floor(total / max_len - 1e-9)), 0)
            s = (np.arange(1, n_samp + 1) * max_len)
            s = s[s < total - 1e-12]
            pts = np.concatenate([
                c[:1],
                np.stack([np.interp(s, cum, c[:, k])
                          for k in range(3)], axis=1)
                if len(s) else np.zeros((0, 3)),
                c[-1:]])
            obs = ([(self.obs_mask[p, 0], self.obs_xy[p, 0])]
                   + [no_obs] * len(s)
                   + [(self.obs_mask[p, n - 1], self.obs_xy[p, n - 1])])
            out_chains.append(pts)
            out_obs.append(obs)
        return from_chain_list(out_chains, out_obs, n_views=Vn)

    # ------------------------------------------------------------------
    def simplify(self, max_linearizability_dist: float = 0.01) -> "PLG3D":
        """Two-ended greedy linearization of every polyline (parity:
        PolyLineGraph3D::simplify + simplify_polyline,
        polyline_graph_3d.cpp:147-258; MAXIMUM_LINEARIZABILITY_DISTANCE
        0.01, polyline_graph_3d.hpp:65).  From each end, keep the
        farthest split index whose interval stays within
        `max_linearizability_dist` of its chord; iterate inward until
        the remaining interval is linearizable.  Dropped interior points
        lose their observations (the reference stores none per interior
        coord either)."""
        d2max = max_linearizability_dist ** 2
        out_chains, out_obs = [], []
        for p in np.flatnonzero(self.valid):
            c = self.coords[p, : self.length[p]].astype(np.float64)
            keep = _simplify_keep_indices(c, d2max)
            out_chains.append(c[keep])
            out_obs.append([(self.obs_mask[p, i], self.obs_xy[p, i])
                            for i in keep])
        return from_chain_list(out_chains, out_obs,
                               n_views=self.obs_mask.shape[2])

    # ------------------------------------------------------------------
    def filter_nodes(self, inliers: np.ndarray,
                     tol: float = 0.0) -> "PLG3D":
        """Invalidate polylines whose extreme nodes are not in the
        inlier point set (parity: PolyLineGraph3DHMapImpl::filter_nodes
        + remove_invalid_polylines,
        polyline_graph_3d_hmap_impl.cpp:156-178 — a node outside
        `inliers` is invalidated, and is_valid_polyline then drops every
        polyline touching it).  The reference matches coords exactly
        via its vec3 hash map; `tol` > 0 relaxes to a nearest-inlier
        distance check for float round-trips."""
        inl = np.asarray(inliers, np.float64).reshape(-1, 3)
        ok = self.valid.copy()
        for p in np.flatnonzero(self.valid):
            for i in (0, self.length[p] - 1):
                q = self.coords[p, i].astype(np.float64)
                if len(inl) == 0:
                    ok[p] = False
                elif tol == 0.0:
                    if not np.any(np.all(inl == q, axis=1)):
                        ok[p] = False
                elif np.min(np.linalg.norm(inl - q, axis=1)) > tol:
                    ok[p] = False
        return self.select(ok)

    # ------------------------------------------------------------------
    def remove_polylines_with_longsegments(
            self, toplength_ratio: float = 0.9) -> "PLG3D":
        """Drop polylines whose longest segment reaches the
        `toplength_ratio` quantile of all max segment lengths (parity:
        PolyLineGraph3DHMapImpl::remove_polylines_with_longsegments,
        polyline_graph_3d_hmap_impl.cpp:143-156 — nth_element at
        index n*ratio, then remove maxlength >= that value)."""
        ids = np.flatnonzero(self.valid)
        if len(ids) == 0:
            return self
        ml = self.max_segment_lengths()[ids]
        k = min(int(len(ml) * toplength_ratio), len(ml) - 1)
        thresh = np.partition(ml, k)[k]
        ok = self.valid.copy()
        ok[ids[ml >= thresh]] = False
        return self.select(ok)

    def max_segment_lengths(self) -> np.ndarray:
        """Per-polyline longest segment (parity: polyline::get_maxlength,
        polyline_graph_3d.cpp:89-97)."""
        d = np.linalg.norm(np.diff(self.coords.astype(np.float64),
                                   axis=1), axis=-1)
        idx = np.arange(self.coords.shape[1] - 1)[None, :]
        d = np.where(idx < (self.length[:, None] - 1), d, 0.0)
        return d.max(axis=1)

    def select(self, keep: np.ndarray) -> "PLG3D":
        """Keep only the flagged polylines (compacted)."""
        return PLG3D(coords=self.coords[keep], length=self.length[keep],
                     obs_mask=self.obs_mask[keep],
                     obs_xy=self.obs_xy[keep])

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(path, coords=self.coords, length=self.length,
                            obs_mask=self.obs_mask, obs_xy=self.obs_xy)

    @staticmethod
    def load(path: str) -> "PLG3D":
        z = np.load(path)
        return PLG3D(coords=z["coords"], length=z["length"],
                     obs_mask=z["obs_mask"], obs_xy=z["obs_xy"])


def _linearizable(c: np.ndarray, start: int, end: int,
                  d2max: float) -> bool:
    """All interior points of c[start:end+1] within sqrt(d2max) of the
    3D line through the interval ends (parity: linearizable_polyline,
    polyline_graph_3d.cpp:147-158 — note the reference measures distance
    to the infinite LINE, not the chord)."""
    if end - start < 2:
        return True
    a, b = c[start], c[end]
    ab = b - a
    nrm2 = float(ab @ ab)
    mid = c[start + 1: end] - a
    if nrm2 == 0.0:
        return bool((np.einsum("ij,ij->i", mid, mid) <= d2max).all())
    t = (mid @ ab) / nrm2
    perp = mid - t[:, None] * ab
    return bool((np.einsum("ij,ij->i", perp, perp) <= d2max).all())


def _simplify_keep_indices(c: np.ndarray, d2max: float) -> list[int]:
    """Index set kept by the reference's two-ended greedy simplification
    (parity: find_max_se / find_min_eb / find_compatible_se_eb /
    simplify_polyline, polyline_graph_3d.cpp:159-250): from the front,
    the farthest split `se` with [start, se] linearizable; from the
    back, the nearest `eb` with [eb, end] linearizable; shrink the
    search window until se <= eb, then recurse on [se, eb]."""
    def find_max_se(start: int, max_se: int) -> int:
        if max_se <= start:
            return start
        for cur in range(max_se, start + 1, -1):
            if _linearizable(c, start, cur, d2max):
                return cur
        return start + 1

    def find_min_eb(end: int, min_eb: int) -> int:
        if min_eb >= end:
            return end
        for cur in range(min_eb, end - 1):
            if _linearizable(c, cur, end, d2max):
                return cur
        return end - 1

    n = len(c)
    start, end = 0, n - 1
    front, back = [start], [end]
    while end > start + 1:
        max_se, min_eb = end, start
        while True:
            se = find_max_se(start, max_se)
            if se == end:
                break
            eb = find_min_eb(end, min_eb)
            max_se -= 1
            min_eb += 1
            if eb >= se:
                break
        if se == end:
            break
        front.append(se)
        if se != eb:
            back.append(eb)
        start, end = se, eb
    return front + back[::-1]


def from_chain_list(chains, obs=None, n_views: int = 0,
                    max_len: int | None = None) -> PLG3D:
    """chains: list of [n_i,3]; obs: list of [(mask [V], xy [V,2])]."""
    if max_len is None:
        max_len = max((len(c) for c in chains), default=2)
    P = max(len(chains), 1)
    coords = np.zeros((P, max_len, 3), dtype=np.float32)
    length = np.zeros(P, dtype=np.int32)
    om = np.zeros((P, max_len, n_views), dtype=bool)
    oxy = np.zeros((P, max_len, n_views, 2), dtype=np.float32)
    for i, c in enumerate(chains):
        k = min(len(c), max_len)
        coords[i, :k] = c[:k]
        length[i] = k
        if obs is not None:
            for j in range(k):
                m, xy = obs[i][j]
                om[i, j] = m
                oxy[i, j] = xy
    return PLG3D(coords=coords, length=length, obs_mask=om, obs_xy=oxy)


def assemble_from_edge_points(pts, n_views: int,
                              max_len: int = 512) -> PLG3D:
    """Build the 3D graph from the follow-sweep output: points of each
    seed, ordered by chain_order, form one 3D polyline (parity with the
    reference's incremental PLG3D build during following,
    plg_matches_manager.cpp:110-180)."""
    if len(pts.X) == 0:
        return from_chain_list([], n_views=n_views)
    order = np.lexsort((pts.chain_order, pts.seed_id))
    sid = pts.seed_id[order]
    bounds = np.flatnonzero(np.diff(sid)) + 1
    groups = np.split(order, bounds)
    chains, obs = [], []
    for g in groups:
        if len(g) < 2:
            continue
        chains.append(pts.X[g])
        obs.append([(pts.obs_mask[i], pts.obs_xy[i]) for i in g])
    return from_chain_list(chains, obs, n_views=n_views, max_len=max_len)
