"""Width-bound mesh-overhead probe (VERDICT r3 task 5).

The full-pipeline virtual-CPU scaling number is dominated by core
oversubscription (8 virtual devices share this host's 2 cores) and by
trip-count-bound walks serializing; it says nothing about the MESH.
This probe isolates what the mesh itself costs: the SAME global
workload of width-bound kernels (compacted seed formation: detection +
correspondence + batched GN — no unbounded walks) run on a 1-device vs
an 8-virtual-device mesh.  On shared silicon the ideal is EQUAL wall
(same total work); the reported `mesh_overhead_factor` =
wall_8dev / wall_1dev, so 1.0 = free sharding.

Run:  python tools/scaling_width_probe.py    (spawns the two
subprocesses with the right XLA flags; prints one JSON line.)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def worker(n_dev: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    from edgegraph3d_tpu import runtime
    runtime.cli_start()
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.core import synthetic
    from edgegraph3d_tpu.matching import refpoints
    from edgegraph3d_tpu.parallel import mesh as mesh_mod
    from edgegraph3d_tpu.parallel import sharded
    from edgegraph3d_tpu.plgs import extraction

    cfg = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                    max_polyline_len=128)
    sfmd, edge_imgs, _ = synthetic.make_scene(
        n_cams=8, n_refpoints_per_curve=48, width=640, height_px=480,
        focal=800.0, seed=3)
    stack = extraction.extract_plgs(edge_imgs, cfg)
    m = mesh_mod.make_mesh(n_dev)
    ctx = refpoints.build_context(sfmd, stack, cfg, mesh=m)
    obs_xy, obs_mask = refpoints.dense_observations(sfmd)
    N = 1024
    # FIXED global work: 1024 refpoint rows, shard-divisible
    reps = -(-N // len(obs_xy))
    ox = np.tile(obs_xy, (reps, 1, 1))[:N]
    om = np.tile(obs_mask, (reps, 1))[:N]
    M = cfg.max_candidates_per_view
    cap_d = 4 * (N // n_dev)

    def once():
        sbuf, ns = sharded.sharded_start_sweep(
            m, ctx.plg_coords, ctx.grids, ctx.cell, jnp.asarray(ox),
            jnp.asarray(om), cfg.detection_starting_dist_px, M, cap_d)
        buf, n = sharded.sharded_seed_from_starts(
            m, ctx.plg_coords, ctx.plg_length, ctx.grids, ctx.P_mats,
            ctx.F_table, ctx.cell, sbuf, ns, jnp.asarray(ox),
            jnp.asarray(om), M, cfg, cap_d)
        return jax.block_until_ready(buf)

    once()                                     # compile
    t0 = time.time()
    for _ in range(3):
        once()
    print(json.dumps({"n_dev": n_dev, "wall": (time.time() - t0) / 3}))


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
        return
    walls = {}
    for n in (1, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                            + env.get("XLA_FLAGS", ""))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(n)], env=env, capture_output=True, timeout=1200)
        line = [ln for ln in out.stdout.decode().splitlines()
                if ln.startswith("{")][-1]
        walls[n] = json.loads(line)["wall"]
        print(f"{n} device(s): {walls[n]:.3f} s "
              f"(same global work)", file=sys.stderr)
    print(json.dumps({
        "metric": "mesh_overhead_factor_width_bound",
        "value": round(walls[8] / walls[1], 3), "unit": "x (1.0=free)",
        "vs_baseline": round(walls[1] / walls[8], 3),
        "note": "same total width-bound work (compacted seed "
                "formation, no unbounded walks) on 1 vs 8 virtual CPU "
                "devices sharing this host's cores; isolates shard_map "
                "+ collective overhead from core oversubscription"}))


if __name__ == "__main__":
    main()
