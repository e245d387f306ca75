"""Round-5 probe: where do stage 1's ~60 s at full scale go?

Splits similarity_match_sets into its phases and times each on the
full-scale workload (49 views, 6268 refpoints):
  1. close-polyline detection (device sweep, cached)
  2. refpoint weights + node reindex (numpy)
  3. clique-pair edge build (numpy, the N x (V*M choose 2) loop)
  4. Jaccard weights (numpy)
  5. community detection (LP device + host merge / Louvain)
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import os
    if "--gpu" not in sys.argv:
        os.environ["JAX_PLATFORMS"] = "cpu"
    from edgegraph3d_tpu import runtime
    runtime.cli_start()
    import jax
    import jax.numpy as jnp

    from bench import build_full_workload
    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.matching import communities as comm_mod
    from edgegraph3d_tpu.matching import polyline_stages
    from edgegraph3d_tpu.matching.refpoints import (build_context,
                                                    dense_observations)
    from edgegraph3d_tpu.pipeline import PipelineStats
    from edgegraph3d_tpu.plgs.extraction import extract_plgs

    t0 = time.time()
    sfmd, edge_imgs, _ = build_full_workload()
    print(f"workload build: {time.time()-t0:.1f}s", flush=True)
    cfg = EdgeGraphConfig()
    t0 = time.time()
    stack = extract_plgs(edge_imgs, cfg)
    print(f"extraction: {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    ctx = build_context(sfmd, stack, cfg)
    print(f"context: {time.time()-t0:.1f}s", flush=True)

    # ---- phase 1: close-polyline sweep
    t0 = time.time()
    obs_xy, obs_mask = dense_observations(sfmd)
    M = cfg.similarity_close_cap
    cand = polyline_stages._close_polylines_cached(
        sfmd, ctx, M, cfg.find_within_dist_px)
    print(f"close_polylines (device): {time.time()-t0:.1f}s", flush=True)

    valid = np.asarray(cand.valid) & obs_mask[..., None]
    pl = np.asarray(cand.pl_id)
    N, V = obs_mask.shape
    P_cnt = ctx.plg_coords.shape[1]

    t0 = time.time()
    node = np.where(valid, np.arange(V)[None, :, None] * P_cnt + pl, -1)
    n_close = valid.sum(axis=(1, 2)).astype(np.float64)
    n_views = np.any(valid, axis=2).sum(axis=1).astype(np.float64)
    w_ref = np.where(n_close > 0, n_views / np.maximum(n_close, 1), 0.0)
    used = np.unique(node[valid])
    U = len(used)
    nn, vv, mm = np.nonzero(valid)
    u_idx = np.searchsorted(used, node[nn, vv, mm])
    SA = np.zeros((U, V), dtype=np.float64)
    np.add.at(SA, u_idx, w_ref[nn, None] * obs_mask[nn])
    print(f"weights+reindex: {time.time()-t0:.1f}s  (U={U} nodes)",
          flush=True)

    t0 = time.time()
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
    keys = np.concatenate(keys_acc)
    print(f"clique pair build: {time.time()-t0:.1f}s  "
          f"({len(keys)} raw pairs)", flush=True)

    t0 = time.time()
    contrib = np.concatenate(inter_acc)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    inter_w = np.bincount(inv, weights=contrib)
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
    edges = np.stack([ia[keep], ib[keep]], axis=1).astype(np.int32)
    weights = w_edge[keep].astype(np.float32)
    print(f"jaccard dedup+weights: {time.time()-t0:.1f}s  "
          f"({len(edges)} edges)", flush=True)

    t0 = time.time()
    comms = comm_mod.communities_from_edges(
        edges, weights, U, min_size=3, method=cfg.community_method)
    print(f"communities ({cfg.community_method}, U={U}): "
          f"{time.time()-t0:.1f}s  ({len(comms)} communities)",
          flush=True)

    # reference timing of the whole stage for cross-check
    t0 = time.time()
    groups = polyline_stages.similarity_match_sets(sfmd, ctx)
    print(f"similarity_match_sets total (cached cand): "
          f"{time.time()-t0:.1f}s  ({len(groups)} sets)", flush=True)


if __name__ == "__main__":
    main()
