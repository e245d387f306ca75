"""Round-5 probe: per-method community-detection cost on the
full-scale similarity graph (U ~12.3k nodes, ~3M edges).

Usage: python tools/communities_probe.py [--gpu]   (CPU unless --gpu)
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

    from bench import build_full_workload
    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.matching import communities as cm
    from edgegraph3d_tpu.matching import polyline_stages
    from edgegraph3d_tpu.matching.refpoints import (build_context,
                                                    dense_observations)
    from edgegraph3d_tpu.plgs.extraction import extract_plgs

    t0 = time.time()
    sfmd, edge_imgs, _ = build_full_workload()
    cfg = EdgeGraphConfig()
    stack = extract_plgs(edge_imgs, cfg)
    ctx = build_context(sfmd, stack, cfg)
    obs_xy, obs_mask = dense_observations(sfmd)
    M = cfg.similarity_close_cap
    cand = polyline_stages._close_polylines_cached(
        sfmd, ctx, M, cfg.find_within_dist_px)
    valid = np.asarray(cand.valid) & obs_mask[..., None]
    pl = np.asarray(cand.pl_id)
    N, V = obs_mask.shape
    P_cnt = ctx.plg_coords.shape[1]
    node = np.where(valid, np.arange(V)[None, :, None] * P_cnt + pl, -1)
    n_close = valid.sum(axis=(1, 2)).astype(np.float64)
    n_views = np.any(valid, axis=2).sum(axis=1).astype(np.float64)
    w_ref = np.where(n_close > 0, n_views / np.maximum(n_close, 1), 0.0)
    used = np.unique(node[valid])
    U = len(used)
    nn, vv, mm = np.nonzero(valid)
    u_idx = np.searchsorted(used, node[nn, vv, mm])
    e, w = polyline_stages._similarity_edges_host(
        node, valid, w_ref, obs_mask, used, nn, vv, mm, u_idx, V, P_cnt)
    print(f"graph: U={U} E={len(e)}  (setup {time.time()-t0:.0f}s, "
          f"backend={jax.default_backend()})", flush=True)

    for label, fn in [
        ("lp (device LP)           ",
         lambda: cm.communities_from_edges(e, w, U, method="lp")),
        ("louvain parallel         ",
         lambda: cm.louvain_host(e, w, U, parallel=True)),
        ("louvain sequential       ",
         lambda: cm.louvain_host(e, w, U, parallel=False)),
        ("lp+merge                 ",
         lambda: cm.communities_from_edges(e, w, U, method="lp+merge")),
        ("union3 (production auto) ",
         lambda: cm.communities_from_edges(e, w, U, method="union3")),
    ]:
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        if isinstance(out, list):
            extra = f"{len(out)} communities"
            q = ""
        else:
            extra = f"{out.max() + 1} labels"
            q = f"  Q={cm.modularity(e, w, out):.4f}"
        print(f"{label}: {dt:7.1f}s  ({extra}){q}", flush=True)


if __name__ == "__main__":
    main()
