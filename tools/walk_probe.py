"""Round-5 probe: where does a stage-3 chunk's device time go?

Times, on the card at the full-scale chunk geometry (Sb = 65536
follow lanes, T = 128 steps, V = 49, P = 8192, L = 64):

  1. the post-walk batched GN at full [Sb*T] width vs compacted widths
     (the GN runs on every recorded step slot; measured fill is <1%)
  2. the walk while_loop itself, nested [V,P,L,2] vs packed [V*P,2L]
     coordinate layout, inside the real walk structure
  3. the 12-config direction resolve

Usage: python tools/walk_probe.py [--lanes 65536] [--steps 128]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timed(fn, *args, n=3, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn(*args, **kw)
        jax.block_until_ready(out)
    return (time.time() - t0) / n, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--views", type=int, default=49)
    args = ap.parse_args()

    from edgegraph3d_tpu import runtime
    runtime.cli_start()
    import jax
    import jax.numpy as jnp

    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.matching import following
    from edgegraph3d_tpu.ops.triangulation import (gauss_newton_batched,
                                                   triangulate_dlt)

    rng = np.random.default_rng(0)
    Sb, T, V = args.lanes, args.steps, args.views
    P_cnt, L = 8192, 64
    cfg = EdgeGraphConfig().replace(max_follow_steps=T)
    print(f"backend={jax.default_backend()} Sb={Sb} T={T} V={V}",
          file=sys.stderr)

    # --- 1. post-walk GN at several widths -------------------------
    # representative camera ring + real-ish observations
    from edgegraph3d_tpu.core.synthetic import make_cube_scene
    sfmd, _, _ = make_cube_scene(n_cams=V, n_refpoints_per_edge=2,
                                 width=1600, height_px=1200, focal=2200.0)
    P_mats = jnp.asarray(sfmd.P, jnp.float32)

    def make_obs(width):
        cams = rng.integers(0, V, (width, 3)).astype(np.int32)
        Pn = np.asarray(P_mats)[cams]                    # host gather
        X_true = rng.normal(0, 1.0, (width, 3)).astype(np.float32)
        Xh = np.concatenate([X_true, np.ones((width, 1), np.float32)], 1)
        proj = np.einsum("noij,nj->noi", Pn, Xh)
        xy = (proj[..., :2] / proj[..., 2:3]
              + rng.normal(0, 0.5, (width, 3, 2))).astype(np.float32)
        return jnp.asarray(cams), jnp.asarray(xy)

    # Gather camera matrices in TRANSPOSED [3,4,N] layout (batch axis
    # last): a materialized gathered [N,3,4] keeps tiny minor dims that
    # a tiled memory layout pads heavily.
    P_t = jnp.moveaxis(P_mats, 0, -1)                 # [3,4,V]

    def gn_full(cams, xyj):
        # [3,4,N,O] -> [N,O,3,4]; the consumer transposes right back to
        # [O,3,4,N], so XLA composes the transposes without ever
        # materializing the N-major layout
        Pw = jnp.transpose(P_t[:, :, cams], (2, 3, 0, 1))
        m3 = jnp.ones(xyj.shape[:2], bool)
        X0 = triangulate_dlt(Pw, xyj, m3)
        return gauss_newton_batched(Pw, xyj, m3, X0,
                                    max_iters=cfg.gn_max_iters,
                                    epsilon=cfg.gn_epsilon,
                                    accept_mse=cfg.match_gn_max_mse)

    # NOTE: width Sb*T (8.4M) OOMs — the gathered [N,3,4] layout tiles
    # to 51 GB.  The production kernel avoided it only because its
    # per-row P was a BROADCAST (fusible for free); any gather-based
    # compaction must carry P as 36 separate [N] vectors (SoA).  The
    # widths below bracket the planned compacted-GN cap.
    for width in (Sb * T // 8, Sb * T // 32, Sb * T // 64):
        cams, xyj = make_obs(width)
        dt, _ = timed(jax.jit(gn_full), cams, xyj)
        print(f"GN+DLT width={width:>9}: {dt*1e3:8.1f} ms", flush=True)

    # --- 2. the walk loop, nested vs packed layout ------------------
    # random smooth polylines; seeds on them
    steps = rng.normal(0, 3.0, (V, P_cnt, L, 2)).astype(np.float32)
    coords = np.cumsum(steps, axis=2) + rng.uniform(
        100, 1400, (V, P_cnt, 1, 2)).astype(np.float32)
    plg_coords = jnp.asarray(coords)
    plg_length = jnp.asarray(
        rng.integers(8, L, (V, P_cnt)).astype(np.int32))
    F = jnp.asarray(rng.normal(0, 1, (V, V, 3, 3)).astype(np.float32))

    S = Sb
    seeds = following.SeedTuple(
        cams=jnp.asarray(rng.integers(0, V, (S, 3)).astype(np.int32)),
        pl_id=jnp.asarray(rng.integers(0, P_cnt, (S, 3)).astype(np.int32)),
        seg=jnp.asarray(rng.integers(0, 4, (S, 3)).astype(np.int32)),
        t=jnp.asarray(rng.random((S, 3)).astype(np.float32)),
        xy=jnp.asarray(rng.uniform(100, 1400, (S, 3, 2))
                       .astype(np.float32)),
        X=jnp.asarray(rng.normal(0, 1, (S, 3)).astype(np.float32)),
        valid=jnp.ones((S,), bool))
    drive = jnp.ones((S,), jnp.int32)
    perm = jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32), (S, 3))
    dirs = jnp.ones((S, 3), jnp.int32)

    dt, res = timed(following.follow_seeds, seeds, plg_coords,
                    plg_length, P_mats, F, drive, cfg, T,
                    fixed_perm=perm, fixed_dirs=dirs, n=2)
    print(f"follow_seeds fixed-dir S={S} T={T}: {dt*1e3:8.1f} ms")

    dt, _ = timed(following.follow_seeds, seeds, plg_coords,
                  plg_length, P_mats, F, drive, cfg, T, n=2)
    print(f"follow_seeds 12-config resolve  : {dt*1e3:8.1f} ms")


if __name__ == "__main__":
    main()
