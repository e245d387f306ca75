"""Benchmark harness: reference-scale synthetic reconstruction.

Prints ONE stdout JSON line (the headline).  Default workload =
**full scale**: 49 views @1600x1200, 6268 refpoints, reconstruction
from EVERY viewing cam (the reference's all-viewing-cams loop,
plg_matching_from_refpoints.cpp:64-81) — the shape of the reference's
one shipped example (example/dtu006; its input.json is stripped from
the mirror, so the synthetic proxy with ground-truth curves is the
standing fixture).  A secondary `trend:` JSON line on stderr runs the
8-view capped cube workload benched since round 1.

Two baselines are reported:

  * `vs_baseline`      — against the SAME code on the CPU backend
    (`--probe-cpu`).  Self-referential: every algorithmic improvement
    speeds the CPU run too, so this ratio only measures what the
    accelerator adds over the host's cores.
  * `vs_frozen_r1_cpu` — against the FROZEN round-1 CPU measurement
    of this workload (0.2835 views/s, 2026-08-18), the closest
    available stand-in for "the reference's CPU wall-clock": the
    reference binary is not runnable here (dtu input.json stripped
    from the mirror), and the reference would not gain from this
    engine's later optimizations.

The benchmark needs a GPU; without one it exits with a message unless
the CPU is asked for (`--probe-cpu`, or JAX_PLATFORMS=cpu).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# measured with `python bench.py --probe-cpu` on this host (see module
# docstring); update when the workload or pipeline changes materially.
# 2026-08-18: 0.2835 views/s (28.2s steady-state for 8 views @1600x1200
#   after an identical warmup pass)  <- FROZEN_R1 below
# 2026-08-20: 0.3406 views/s (23.5s) — round-2 SoA kernels
# 2026-08-21: 1.7877 views/s (4.5s) — pow2 auto-sized shapes, L=64
#   budgets, threaded extraction, adaptive chunks (same-code CPU gains
#   from every one of these)
# 2026-08-21 (round 4): 1.7588 views/s (4.5s) — union communities +
#   fused megakernels (CPU shares both); uncontended
# 2026-08-21 (round 5): 1.8637 views/s (4.3s) — endpoint grids,
#   compacted GN, packed walk layout, union3 communities (the CPU
#   run shares all of them; union3 does MORE work — 3299 vs 2961
#   edge-points — and the CPU still got faster); uncontended
#   <- CURRENT
CPU_BASELINE_VIEWS_PER_S = 1.8637
FROZEN_R1_CPU_VIEWS_PER_S = 0.2835
# Full-scale workload (49 views @1600x1200, 6268 refpoints, uncapped
# starting views) same-code CPU baseline, measured by the SLICE
# PROTOCOL (`python bench.py --cpu-slices`, round 5): one steady-state
# CPU pass each at two refpoint slices (identical warmup discipline),
# a linear wall-vs-refpoints fit, and extrapolation to 6268 refpoints.  Stage-3/extension work is
# proportional to refpoints (per-refpoint all-viewing-cams loop,
# plg_matching_from_refpoints.cpp:64-81); the fitted intercept captures
# the fixed extraction/context cost.  Round 4 could not even complete
# ONE full CPU pass in its budget (>104 min) — the protocol gives the
# >=10x BASELINE target a real measured denominator.
#
# MEASURED 2026-08-21 (round 5, uncontended): steady CPU walls
# 820.0 s @196 refpoints, 1975.8 s @783 refpoints -> fit wall =
# 434.1 + 1.969 * n_ref -> extrapolated full-scale wall 12,776 s
# (3.55 h) -> 0.00384 views/s.  The linear model is CONSERVATIVE for the ratio: the stage-1 pair build and
# density/claiming costs grow superlinearly in refpoints, so the true
# full CPU wall is >= the fit.  Consistent with round 4's bound (could
# not finish 6268 refpoints in 6240 s).
FULL_CPU_BASELINE_VIEWS_PER_S = 0.00384
FULL_CPU_BASELINE_NOTE = (
    "slice protocol: steady CPU passes at 196 and 783 refpoints "
    "(820.0 s / 1975.8 s), wall = 434.1 + 1.969*n_ref, extrapolated "
    "to 6268 -> 12776 s")


def build_workload(n_views: int, width: int, height: int,
                   n_ref_per_edge: int, seed: int = 0):
    from edgegraph3d_tpu.core import synthetic
    focal = 2.2 * width / 1.6
    return synthetic.make_cube_scene(
        n_cams=n_views, n_refpoints_per_edge=n_ref_per_edge,
        width=width, height_px=height, focal=focal, seed=seed)


def build_full_workload(n_views: int = 49, n_refpoints: int = 6268,
                        width: int = 1600, height: int = 1200):
    """The reference-scale workload (dtu006 shape: 49 views @1600x1200,
    6268 refpoints, reconstruction from EVERY viewing cam — the
    all-viewing-cams loop of plg_matching_from_refpoints.cpp:64-81)."""
    from edgegraph3d_tpu.core import synthetic
    return synthetic.make_dtu_scale_scene(
        n_cams=n_views, n_refpoints=n_refpoints, width=width,
        height_px=height, focal=2.2 * width / 1.6)


def quality_metrics(out_sfmd, in_sfmd, curves):
    """3D accuracy + completeness of the reconstructed edge-points
    against the ground-truth synthetic curves: median distance of
    edge-points to the nearest curve sample, and `coverage` = fraction
    of curve samples with an edge-point within 2x the median sample
    spacing (`coverage_4x` is the looser 4x variant reported through
    round 2 under the name `coverage`; kept for cross-round
    comparability)."""
    import numpy as np
    pts = out_sfmd.points[in_sfmd.n_points:]
    gt = np.concatenate(curves)
    if len(pts) == 0:
        return dict(edge_points=0, med_dist3d=float("inf"),
                    coverage=0.0, coverage_4x=0.0)
    # chunked nearest-neighbour (no scipy dependency)
    d_pt = np.full(len(pts), np.inf)
    d_gt = np.full(len(gt), np.inf)
    for lo in range(0, len(pts), 2048):
        d = np.linalg.norm(pts[lo:lo + 2048, None] - gt[None], axis=-1)
        d_pt[lo:lo + 2048] = d.min(axis=1)
        d_gt = np.minimum(d_gt, d.min(axis=0))
    spacing = np.median(np.linalg.norm(np.diff(gt[:200], axis=0), axis=1))
    return dict(edge_points=int(len(pts)),
                med_dist3d=float(np.median(d_pt)),
                coverage=float((d_gt < 2 * spacing).mean()),
                coverage_4x=float((d_gt < 4 * spacing).mean()))


def run_workload(sfmd, edge_imgs, curves, n_views: int,
                 max_starting_views, verbose=True, mesh_devices=0,
                 warm_scene=None):
    """Steady-state throughput: one warmup pass (same jit shapes — the
    padding budgets make every device program's shape independent of the
    refpoint count) triggers all compiles / executable loads, then the
    measured pass times the full workload.  The CPU probe goes through
    the identical warmup, so `vs_baseline` compares steady states.

    mesh_devices > 0 runs every sweep sharded over an n-device 1-D mesh
    (the scaling probe)."""
    import numpy as np

    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.pipeline import PipelineStats, run_pipeline

    mesh = None
    if mesh_devices:
        import jax

        from edgegraph3d_tpu.parallel import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(mesh_devices,
                                  devices=jax.devices()[:mesh_devices])

    # padding budgets at the audited defaults (tools/capacity_audit.py:
    # zero drops on real dtu006), so the headline number reflects the
    # real-data configuration.  max_follow_steps=32: the walk loop's
    # per-iteration cost is paid by EVERY seed lane until the longest
    # chain in the chunk terminates, so short round-0 sweeps + the
    # continuation rounds (which re-follow only the few survivors,
    # compacted, direction-pinned) cover long chains at a fraction of
    # the wall (round-5 probe: the T=128 walk was ~2.5 s of a 5.3 s
    # stage-3 chunk).  Chains up to 32*(1+8 rounds) = 288 steps still
    # complete; longer ones are counted (chains_truncated).
    cfg = EdgeGraphConfig().replace(max_follow_steps=32)

    # warmup so the measured pass is pure steady state.  Default: the
    # FULL workload once (identical shapes).  With `warm_scene` (the
    # full-scale workload's quarter-refpoint variant): every jit shape
    # is scene-size-INDEPENDENT by construction — chunk widths come
    # from the start-mask density and pow2 buckets, not N — so the
    # cheap scene exercises the same executables at ~1/4 the work.
    t0 = time.time()
    warm_stats = PipelineStats()
    w_sfmd, w_edges = (sfmd, edge_imgs) if warm_scene is None \
        else warm_scene
    run_pipeline(w_sfmd, w_edges, cfg,
                 max_starting_views=max_starting_views, mesh=mesh,
                 stats=warm_stats)
    if verbose:
        print(f"warmup: {time.time() - t0:.2f}s; stage breakdown "
              f"(compile-inclusive):", file=sys.stderr)
        print(warm_stats.report(), file=sys.stderr)

    stats = PipelineStats()
    t0 = time.time()
    out = run_pipeline(sfmd, edge_imgs, cfg,
                       max_starting_views=max_starting_views, stats=stats,
                       mesh=mesh)
    wall = time.time() - t0
    qual = quality_metrics(out, sfmd, curves)
    qual["device_fetches"] = stats.counters.get("device_fetches", 0)
    qual["overflow"] = stats.counters.get("polylines_dropped_overflow", 0)
    if verbose:
        print(stats.report(), file=sys.stderr)
        print(f"total: {wall:.2f}s, edge-points: "
              f"{out.n_points - sfmd.n_points}, quality: {qual}",
              file=sys.stderr)
    return wall, qual


def cpu_slices_probe(args):
    """Full-scale CPU baseline via the slice protocol: measure
    steady-state CPU passes at 1/32 and 1/8 of the refpoints, fit
    wall = a + b*refpoints, extrapolate the full-scale wall (see the
    FULL_CPU_BASELINE_VIEWS_PER_S comment).  1/8 is the largest slice
    a round budget can afford twice (round 5 measured 33 min per
    steady pass at 1/8; a 1/4 slice alone would cost ~2 h with its
    warmup).  Prints one JSON line with the slice walls, the fitted
    model, and the extrapolated views/s."""
    import subprocess
    slices = [args.refpoints // 32, args.refpoints // 8]
    walls = []
    for n_ref in slices:
        cmd = [sys.executable, os.path.abspath(__file__), "--probe-cpu",
               "--workload", "full", "--refpoints", str(n_ref),
               "--no-trend"]
        t0 = time.time()
        out = subprocess.run(cmd, capture_output=True, timeout=14400)
        stdout_lines = out.stdout.decode().strip().splitlines()
        if out.returncode != 0 or not stdout_lines:
            sys.stderr.write(out.stderr.decode()[-4000:])
            raise RuntimeError(
                f"slice probe rc={out.returncode}, no stdout")
        rec = json.loads(stdout_lines[-1])
        wall = args.views / rec["value"] if args.views else \
            49 / rec["value"]
        walls.append(wall)
        print(f"slice {n_ref} refpoints: {wall:.1f}s steady "
              f"({rec['edge_points']} pts; probe total "
              f"{time.time() - t0:.0f}s incl. warmup)", file=sys.stderr)
    # linear fit wall = a + b * n_ref through the two slices
    b = (walls[1] - walls[0]) / (slices[1] - slices[0])
    a = walls[0] - b * slices[0]
    wall_full = a + b * args.refpoints
    vps = (args.views or 49) / wall_full
    # linearity diagnostic: the per-refpoint marginal cost implied by
    # each slice alone (they should agree if the model is linear)
    print(json.dumps({
        "metric": "cpu_full_scale_slice_protocol",
        "slices_refpoints": slices,
        "slice_walls_s": [round(w, 1) for w in walls],
        "fit_intercept_s": round(a, 1),
        "fit_per_refpoint_ms": round(b * 1e3, 3),
        "extrapolated_full_wall_s": round(wall_full, 1),
        "value": round(vps, 5), "unit": "views/s",
        "method": "steady-state CPU pass at 1/8 and 1/4 refpoints, "
                  "linear wall-vs-refpoints fit, extrapolated to "
                  f"{args.refpoints}"}))


def scaling_probe(args):
    """views/s on 1 vs 8 virtual CPU devices (SURVEY §2.10 scaling
    target).  Honest caveat, printed with the number: virtual CPU
    devices SHARE the host's cores AND serialize trip-count-bound
    while_loop programs (each virtual device's follow walk runs its
    full iteration count back-to-back on the same silicon), so the
    sweep stages show no virtual speedup by construction.  The
    width-bound kernels (seed formation, expansion) run within ~2x of
    single-device on the same probe — the evidence that the mesh path
    adds little overhead — and real scaling needs real cards (the
    collective design is validated by tests/test_sharded_pipeline.py
    parity and tests/test_multihost.py crossing a true process
    boundary)."""
    import subprocess
    results = {}
    for n in (1, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                            + env.get("XLA_FLAGS", ""))
        cmd = [sys.executable, os.path.abspath(__file__), "--probe-cpu",
               "--workload", "cube8",
               "--views", str(args.views), "--width", str(args.width),
               "--height", str(args.height),
               "--refpoints-per-edge", str(args.refpoints_per_edge),
               "--max-starting-views", str(args.max_starting_views)]
        if n > 1:
            cmd += ["--mesh-devices", str(n)]
        out = subprocess.run(cmd, env=env, capture_output=True,
                             timeout=3600)
        line = out.stdout.decode().strip().splitlines()[-1]
        results[n] = json.loads(line)["value"]
        print(f"{n} virtual device(s): {results[n]} views/s",
              file=sys.stderr)
    eff = results[8] / (8 * results[1])
    print(json.dumps({
        "metric": "scaling_efficiency_8xvirtual_cpu",
        "value": round(eff, 4), "unit": "fraction",
        "vs_baseline": round(results[8] / results[1], 3),
        "note": "virtual CPU devices share host cores; measures mesh "
                "overhead/load balance, not silicon speedup"}))


def _qual_fields(views_per_s, qual, msv):
    return {
        "value": round(views_per_s, 4), "unit": "views/s",
        "edge_points": qual["edge_points"],
        "med_dist3d": round(qual["med_dist3d"], 5),
        "coverage": round(qual["coverage"], 4),
        "coverage_4x": round(qual["coverage_4x"], 4),
        "device_fetches": qual.get("device_fetches", 0),
        "overflow": qual.get("overflow", 0),
        "max_starting_views": msv if msv is not None else "all"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("full", "cube8"),
                    default="full",
                    help="full = the reference-scale headline (49 views "
                    "@1600x1200, 6268 refpoints, UNCAPPED starting "
                    "views); cube8 = the 8-view capped trend workload "
                    "benched since round 1")
    ap.add_argument("--views", type=int, default=0,
                    help="override view count (0 = workload default)")
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--refpoints", type=int, default=6268,
                    help="full workload refpoint count")
    ap.add_argument("--refpoints-per-edge", type=int, default=48)
    ap.add_argument("--max-starting-views", type=int, default=0,
                    help="cap on starting views per refpoint; 0 = "
                    "workload default (full: uncapped — the reference's "
                    "all-viewing-cams loop, "
                    "plg_matching_from_refpoints.cpp:64-81; cube8: 2); "
                    "< 0 forces uncapped")
    ap.add_argument("--probe-cpu", action="store_true",
                    help="run on the CPU backend and print raw views/s")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="shard sweeps over an n-device mesh (with "
                    "--probe-cpu: virtual CPU devices)")
    ap.add_argument("--scaling-probe", action="store_true",
                    help="measure views/s at 1 vs 8 virtual CPU devices "
                    "and print a scaling-efficiency JSON line")
    ap.add_argument("--no-trend", action="store_true",
                    help="skip the secondary cube8 trend run")
    ap.add_argument("--cpu-slices", action="store_true",
                    help="measure the full-scale CPU baseline via the "
                    "slice protocol (1/8 + 1/4 refpoints, linear "
                    "extrapolation)")
    args = ap.parse_args()

    if args.scaling_probe:
        scaling_probe(args)
        return
    if args.cpu_slices:
        cpu_slices_probe(args)
        return

    if args.probe_cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    from edgegraph3d_tpu import runtime
    runtime.cli_start()

    full = args.workload == "full"
    if args.max_starting_views > 0:
        msv = args.max_starting_views
    elif args.max_starting_views < 0:
        msv = None
    else:
        msv = None if full else 2
    warm_scene = None
    if full:
        views = args.views or 49
        sfmd, edge_imgs, curves = build_full_workload(
            views, args.refpoints, args.width, args.height)
        if args.refpoints >= 4000:
            # quarter-scale warmup scene: identical jit shapes (chunk
            # sizing is N-independent), ~1/4 the warmup wall
            w_sfmd, w_edges, _ = build_full_workload(
                views, args.refpoints // 4, args.width, args.height)
            warm_scene = (w_sfmd, w_edges)
    else:
        views = args.views or 8
        sfmd, edge_imgs, curves = build_workload(
            views, args.width, args.height, args.refpoints_per_edge)
    print(f"workload: {args.workload}, {views} views, "
          f"{sfmd.n_points} refpoints, max_starting_views="
          f"{msv if msv is not None else 'all'}", file=sys.stderr)
    wall, qual = run_workload(sfmd, edge_imgs, curves, views, msv,
                              mesh_devices=args.mesh_devices,
                              warm_scene=warm_scene)
    views_per_s = views / wall

    if args.probe_cpu:
        print(f"CPU probe: {views_per_s:.4f} views/s "
              f"({wall:.1f}s, {qual})", file=sys.stderr)
        print(json.dumps({
            "metric": f"views_per_s_cpu_{args.workload}",
            "vs_baseline": 1.0,
            **_qual_fields(views_per_s, qual, msv)}))
        return

    if full:
        baseline = FULL_CPU_BASELINE_VIEWS_PER_S
        headline = {
            "metric": "views_per_s_full_scale",
            "vs_baseline": (round(views_per_s / baseline, 3)
                            if baseline else None),
            "total_s": round(wall, 2),
            **_qual_fields(views_per_s, qual, msv)}
        if not args.no_trend:
            # secondary trend line: the 8-view capped workload every
            # round has benched (stderr, so the driver's headline
            # parse sees one stdout JSON line)
            s2, e2, c2 = build_workload(8, args.width, args.height,
                                        args.refpoints_per_edge)
            w2, q2 = run_workload(s2, e2, c2, 8, 2, verbose=False)
            vps2 = 8 / w2
            print("trend: " + json.dumps({
                "metric": "views_per_s_cube8",
                "vs_baseline": round(vps2 / CPU_BASELINE_VIEWS_PER_S, 3),
                "vs_frozen_r1_cpu": round(
                    vps2 / FROZEN_R1_CPU_VIEWS_PER_S, 3),
                **_qual_fields(vps2, q2, 2)}), file=sys.stderr)
        print(json.dumps(headline))
    else:
        print(json.dumps({
            "metric": "views_per_s",
            "vs_baseline": round(views_per_s / CPU_BASELINE_VIEWS_PER_S,
                                 3),
            "vs_frozen_r1_cpu": round(
                views_per_s / FROZEN_R1_CPU_VIEWS_PER_S, 3),
            **_qual_fields(views_per_s, qual, msv)}))


if __name__ == "__main__":
    main()
