"""Polyline graphs as fixed-shape padded struct-of-arrays.

JAX-native replacement for the reference's pointer-based
`PolyLineGraph2D[HMapImpl]` (reference: include/edgegraph3d/plgs/
polyline_graph_2d.hpp:82-449, src/edgegraph3d/plgs/polyline_graph_2d.cpp).
A 2D PLG here is:

    coords  [P, L, 2] float32   padded polyline coordinate chains
    length  [P]       int32     valid coords per polyline (0 = invalid)
    start_node/end_node [P] int32  shared-endpoint node ids (hubs)

All per-view PLGs are padded to common (P, L) budgets and stacked to
[V, P, L, 2] (`PLGStack`) so every matching kernel can vmap/shard over
the view axis.  Graph questions (components, degree) are answered with
union-find over the node ids on host; geometric questions (arc length,
interval sampling, point-to-polyline distance) are dense masked array
ops that run on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PLG2D:
    """One view's polyline graph (host-side, padded)."""

    coords: np.ndarray        # [P, L, 2] float32
    length: np.ndarray        # [P] int32, 0 for invalid slots
    start_node: np.ndarray    # [P] int32, -1 for invalid
    end_node: np.ndarray      # [P] int32, -1 for invalid
    n_nodes: int = 0
    #: polylines dropped because the padding budget overflowed ("no
    #: silent caps": surfaced through PipelineStats.counters)
    overflow_dropped: int = 0

    @property
    def n_polylines(self) -> int:
        return int((self.length >= 2).sum())

    @property
    def valid(self) -> np.ndarray:
        return self.length >= 2

    def polyline(self, p: int) -> np.ndarray:
        return self.coords[p, : self.length[p]]

    # ------------------------------------------------------------------
    def segment_mask(self) -> np.ndarray:
        """[P, L-1] bool: segment i connects coords i, i+1."""
        idx = np.arange(self.coords.shape[1] - 1)[None, :]
        return idx < (self.length[:, None] - 1)

    def arc_lengths(self) -> np.ndarray:
        """[P, L] cumulative arc length along each polyline (0 at coord 0)."""
        d = np.linalg.norm(np.diff(self.coords, axis=1), axis=-1)
        d = d * self.segment_mask()
        out = np.zeros(self.coords.shape[:2], dtype=self.coords.dtype)
        out[:, 1:] = np.cumsum(d, axis=1)
        return out

    def total_lengths(self) -> np.ndarray:
        """[P] arc length of each polyline."""
        al = self.arc_lengths()
        idx = np.clip(self.length - 1, 0, al.shape[1] - 1)
        return al[np.arange(al.shape[0]), idx] * self.valid

    # ------------------------------------------------------------------
    def max_smooth_lengths(self, cos_min: float = 0.707) -> np.ndarray:
        """[P] longest arc length of a run of consecutive segments whose
        turn cosine stays >= cos_min (parity:
        PolyLineGraph2D::compute_max_smooth_length, polyline_graph_2d.hpp:64-65).
        """
        P, L, _ = self.coords.shape
        seg = np.diff(self.coords, axis=1)                     # [P,L-1,2]
        seg_len = np.linalg.norm(seg, axis=-1)
        smask = self.segment_mask()
        if L < 3:
            return self.total_lengths()
        dots = np.sum(seg[:, :-1] * seg[:, 1:], axis=-1)
        denom = np.maximum(seg_len[:, :-1] * seg_len[:, 1:], 1e-12)
        cos = dots / denom                                     # [P,L-2]
        joint_ok = (cos >= cos_min) & smask[:, :-1] & smask[:, 1:]
        # run-max of smooth arc length: sequential scan over the (small,
        # padded) L axis
        best = np.where(smask[:, 0], seg_len[:, 0], 0.0)
        run = best.copy()
        for i in range(1, L - 1):
            sl = np.where(smask[:, i], seg_len[:, i], 0.0)
            run = np.where(joint_ok[:, i - 1], run + sl, sl)
            best = np.maximum(best, run)
        return best * self.valid

    # ------------------------------------------------------------------
    def components(self) -> np.ndarray:
        """[P] component id per polyline via union-find on shared node ids
        (parity: PolyLineGraph2D DFS components, polyline_graph_2d.cpp:1869-1986).
        Invalid polylines get -1."""
        parent = np.arange(max(self.n_nodes, 1), dtype=np.int64)

        def find(x):
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        for p in np.flatnonzero(self.valid):
            a, b = int(self.start_node[p]), int(self.end_node[p])
            if a >= 0 and b >= 0:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[rb] = ra
        comp = np.full(self.coords.shape[0], -1, dtype=np.int64)
        for p in np.flatnonzero(self.valid):
            comp[p] = find(int(self.start_node[p]))
        # relabel densely
        uniq, inv = np.unique(comp[comp >= 0], return_inverse=True)
        out = np.full_like(comp, -1)
        out[comp >= 0] = inv
        return out

    def filter_components_by_smooth_length(
            self, top_fraction_keep: float = 0.82,
            cos_min: float = 0.707) -> "PLG2D":
        """Keep components owning >=1 polyline whose max smooth length is
        in the top (1 - top_fraction_keep) fraction (parity:
        filter_components_by_polylinesmoothlength,
        polyline_graph_2d.cpp:2011-2052, TOP_FILTER 0.82)."""
        smooth = self.max_smooth_lengths(cos_min)
        v = self.valid
        if not v.any():
            return self
        thresh = np.quantile(smooth[v], top_fraction_keep)
        comp = self.components()
        good_comps = set(comp[v & (smooth >= thresh)].tolist())
        keep = v & np.isin(comp, list(good_comps))
        return self.keep_polylines(keep)

    # ------------------------------------------------------------------
    def keep_polylines(self, keep: np.ndarray) -> "PLG2D":
        """Zero-out polylines not in `keep` (shapes preserved)."""
        out_len = np.where(keep, self.length, 0).astype(np.int32)
        sn = np.where(keep, self.start_node, -1).astype(np.int32)
        en = np.where(keep, self.end_node, -1).astype(np.int32)
        coords = np.where(keep[:, None, None], self.coords, 0.0)
        return PLG2D(coords=coords.astype(self.coords.dtype), length=out_len,
                     start_node=sn, end_node=en, n_nodes=self.n_nodes)

    def compact(self) -> "PLG2D":
        """Drop invalid slots (shrinks P)."""
        keep = np.flatnonzero(self.valid)
        return PLG2D(coords=self.coords[keep], length=self.length[keep],
                     start_node=self.start_node[keep],
                     end_node=self.end_node[keep], n_nodes=self.n_nodes)


def from_polyline_list(polylines: list[np.ndarray],
                       max_polylines: int | None = None,
                       max_len: int | None = None,
                       node_quant: float = 0.25) -> PLG2D:
    """Build a padded PLG2D from a list of [n_i, 2] float arrays.

    Node ids are assigned by quantizing endpoint coords (replaces the
    reference's unordered_map<vec2,id> node dedup,
    polyline_graph_2d_hmap_impl.hpp:60-76).  Polylines longer than
    `max_len` are split into consecutive chains sharing a node at the cut.
    """
    # split over-long chains
    if max_len is not None:
        split = []
        for pl in polylines:
            while len(pl) > max_len:
                split.append(pl[:max_len])
                pl = pl[max_len - 1:]       # share the cut coordinate
            split.append(pl)
        polylines = split
    polylines = [np.asarray(p, dtype=np.float32) for p in polylines
                 if len(p) >= 2]
    overflow_dropped = 0
    if max_polylines is not None and len(polylines) > max_polylines:
        # keep the longest chains if over budget — counted, never silent
        overflow_dropped = len(polylines) - max_polylines
        order = np.argsort([-len(p) for p in polylines], kind="stable")
        polylines = [polylines[i] for i in order[:max_polylines]]

    # size the arrays to the data (max_polylines is the DROP cap, not
    # the storage shape — stack_plgs re-pads to the shared pow2 bucket)
    P = max(len(polylines), 1)
    L = max_len if max_len is not None else max(
        (len(p) for p in polylines), default=2)
    coords = np.zeros((P, L, 2), dtype=np.float32)
    length = np.zeros(P, dtype=np.int32)
    start_node = np.full(P, -1, dtype=np.int32)
    end_node = np.full(P, -1, dtype=np.int32)

    node_map: dict[tuple[int, int], int] = {}

    def node_id(xy) -> int:
        key = (int(round(xy[0] / node_quant)), int(round(xy[1] / node_quant)))
        if key not in node_map:
            node_map[key] = len(node_map)
        return node_map[key]

    for i, pl in enumerate(polylines):
        coords[i, : len(pl)] = pl
        length[i] = len(pl)
        start_node[i] = node_id(pl[0])
        end_node[i] = node_id(pl[-1])

    return PLG2D(coords=coords, length=length, start_node=start_node,
                 end_node=end_node, n_nodes=len(node_map),
                 overflow_dropped=overflow_dropped)


@dataclass
class PLGStack:
    """All views' PLGs stacked for device kernels."""

    coords: np.ndarray   # [V, P, L, 2] float32
    length: np.ndarray   # [V, P] int32
    start_node: np.ndarray  # [V, P] int32
    end_node: np.ndarray    # [V, P] int32
    #: total polylines dropped to padding-budget overflow across views
    overflow_dropped: int = 0

    @property
    def n_views(self) -> int:
        return self.coords.shape[0]

    @property
    def valid(self) -> np.ndarray:
        return self.length >= 2

    def view(self, v: int) -> PLG2D:
        return PLG2D(coords=self.coords[v], length=self.length[v],
                     start_node=self.start_node[v],
                     end_node=self.end_node[v],
                     n_nodes=int(max(self.start_node[v].max(initial=-1),
                                     self.end_node[v].max(initial=-1)) + 1))


def _pow2_bucket(need: int, floor: int, cap: int) -> int:
    """Smallest power-of-two >= max(need, floor), clamped to cap.

    Shapes are DATA-DERIVED: a scene pays for the capacity it uses
    (rounded to a pow2 bucket so similar scenes reuse compiled
    programs), while `cap` remains the audited real-data budget
    (tools/capacity_audit.py) and the overflow-drop threshold."""
    b = 1 << max(int(np.ceil(np.log2(max(need, floor, 1)))), 0)
    return min(max(b, floor), cap)


def stack_plgs(plgs: list[PLG2D], max_polylines: int,
               max_len: int) -> PLGStack:
    """Pad every view's PLG to a shared pow2-bucketed (P, L) shape and
    stack.  `max_polylines`/`max_len` are caps: chains beyond them are
    dropped (counted in overflow_dropped) / truncated, but a scene that
    needs less gets a smaller bucket — fixed worst-case shapes would
    make every device program pay dtu006-scale cost on every scene."""
    V = len(plgs)
    compacted, dropped = [], 0
    for plg in plgs:
        dropped += plg.overflow_dropped
        g = plg.compact()
        if g.coords.shape[0] > max_polylines:
            dropped += g.coords.shape[0] - max_polylines
            order = np.argsort(-g.length, kind="stable")[:max_polylines]
            g = PLG2D(coords=g.coords[order], length=g.length[order],
                      start_node=g.start_node[order],
                      end_node=g.end_node[order], n_nodes=g.n_nodes)
        compacted.append(g)
    need_P = max((g.coords.shape[0] for g in compacted), default=1)
    need_L = max((int(g.length.max(initial=2)) for g in compacted),
                 default=2)
    P_pad = _pow2_bucket(need_P, 256, max_polylines)
    L_pad = _pow2_bucket(need_L, 16, max_len)
    coords = np.zeros((V, P_pad, L_pad, 2), dtype=np.float32)
    length = np.zeros((V, P_pad), dtype=np.int32)
    sn = np.full((V, P_pad), -1, dtype=np.int32)
    en = np.full((V, P_pad), -1, dtype=np.int32)
    for v, g in enumerate(compacted):
        P = min(g.coords.shape[0], P_pad)
        L = min(g.coords.shape[1], L_pad)
        coords[v, :P, :L] = g.coords[:P, :L]
        length[v, :P] = np.minimum(g.length[:P], L)
        sn[v, :P] = g.start_node[:P]
        en[v, :P] = g.end_node[:P]
    return PLGStack(coords=coords, length=length, start_node=sn,
                    end_node=en, overflow_dropped=dropped)
