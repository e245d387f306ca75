"""2D density filter: one edge-point per 3 px cell per view.

JAX-native equivalent of the reference's sequential occupancy-bitmap
pass (reference: src/edgegraph3d/filtering/filtering_close_plgps.cpp:75-124):
a point is kept iff >= 1 of its 2D observations lands in a cell not yet
occupied by an earlier kept point; kept points mark all their cells.

The sequential first-claim semantics are reproduced exactly with
deterministic iterative claim rounds (propose -> min-index claim ->
commit), which also parallelizes across devices later: each round is a
scatter-min plus a gather.
"""

from __future__ import annotations

import numpy as np


#: below this point count the exact sequential pass runs; above it the
#: round-based parallel claim path (same outcome, proven by
#: tests/test_pipeline.py::test_density_round_path_matches_sequential)
SEQUENTIAL_MAX_N = 50_000


def density_filter(obs_xy: np.ndarray, obs_mask: np.ndarray,
                   width: int, height: int, cell: int = 3,
                   max_rounds: int = 64,
                   sequential_threshold: int | None = None) -> np.ndarray:
    """obs_xy [N,V,2], obs_mask [N,V] -> keep [N] bool.

    Points are processed in index order (parity: the reference's
    insertion order)."""
    if sequential_threshold is None:
        sequential_threshold = SEQUENTIAL_MAX_N
    N, V, _ = obs_xy.shape
    GW = int(np.ceil(width / cell)) + 1
    GH = int(np.ceil(height / cell)) + 1
    if N == 0:
        return np.zeros(0, dtype=bool)

    cx = np.clip((obs_xy[..., 0] / cell).astype(np.int64), 0, GW - 1)
    cy = np.clip((obs_xy[..., 1] / cell).astype(np.int64), 0, GH - 1)
    flat = (np.arange(V)[None, :] * (GH * GW) + cy * GW + cx)   # [N,V]

    if N <= sequential_threshold:
        # plain sequential pass — BY DEFINITION the semantics being
        # reproduced; at single-host point counts it beats the claim
        # rounds' per-round raster scans by an order of magnitude.
        # The round-based path below remains the formulation that
        # parallelizes (multi-device point sets).
        occ = np.zeros(V * GH * GW, dtype=bool)
        keep = np.zeros(N, dtype=bool)
        for i in range(N):
            cells = flat[i][obs_mask[i]]
            if len(cells) and not occ[cells].all():
                keep[i] = True
                occ[cells] = True
        return keep

    INF = N + 1
    occupied_by = np.full(V * GH * GW, INF, dtype=np.int64)  # first keeper
    undecided = np.ones(N, dtype=bool)
    keep = np.zeros(N, dtype=bool)

    for _ in range(max_rounds):
        idx = np.flatnonzero(undecided)
        if len(idx) == 0:
            break
        cells = flat[idx]                      # [U,V]
        m = obs_mask[idx]
        # a cell is free if no earlier DECIDED keeper owns it
        free = occupied_by[cells] == INF
        has_free = (free & m).any(axis=1)
        # reject points with no free cell (all their cells owned by
        # earlier kept points -> same as sequential outcome)
        owners = occupied_by[cells]
        blocked = ~has_free
        keep_reject = idx[blocked]
        undecided[keep_reject] = False

        cand = idx[has_free]
        if len(cand) == 0:
            continue
        # tentative claim: min point index per free cell this round
        cc = flat[cand]
        mm = obs_mask[cand] & (occupied_by[cc] == INF)
        pts = np.repeat(cand, mm.sum(axis=1))
        cls = cc[mm]
        order = np.lexsort((pts, cls))
        cls_s = pts_s = None
        cls_s, pts_s = cls[order], pts[order]
        first = np.concatenate([[True], cls_s[1:] != cls_s[:-1]])
        winner_cell = cls_s[first]
        winner_pt = pts_s[first]
        win_map = np.full(V * GH * GW, INF, dtype=np.int64)
        win_map[winner_cell] = winner_pt
        # a candidate is definitively kept this round if it WINS one of
        # its free cells AND no undecided earlier point contests... the
        # min-index winner of a cell cannot be blocked by later points,
        # so the smallest undecided index among candidates always
        # resolves -> guaranteed progress.
        wins = (win_map[cc] == cand[:, None]) & mm
        resolved = wins.any(axis=1)
        newly_kept = cand[resolved]
        keep[newly_kept] = True
        undecided[newly_kept] = False
        # mark ALL cells of kept points
        kc = flat[newly_kept]
        km = obs_mask[newly_kept]
        cells_to_mark = kc[km]
        pts_marking = np.repeat(newly_kept, km.sum(axis=1))
        np.minimum.at(occupied_by, cells_to_mark, pts_marking)
    else:
        # safety: resolve any stragglers sequentially
        for i in np.flatnonzero(undecided):
            cells = flat[i][obs_mask[i]]
            if (occupied_by[cells] == INF).any():
                keep[i] = True
                np.minimum.at(occupied_by, cells, i)
    return keep
