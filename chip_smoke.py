"""On-card smoke test: the reconstruction's main path on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py                # phases a-f on one card
    python chip_smoke.py --four-cards   # the mesh path on four cards

Phases, in order; each prints its result lines, labelled with the card's
name and power limit, and any failure exits non-zero:

  a. device       JAX's default backend must be "gpu"
  b. native       the C++ extraction library must load
  c. precision    F table against float64 numpy (max abs error < 1e-4)
                  and one f32 [1024, 1024] product under the package's
                  matmul-precision pin (relative error < 1e-5; TF32
                  would give ~1e-3)
  d. similarity   the stage-1 similarity-graph kernel against its host
                  reference at full width: identical edge sets, weights
                  within 2%; both paths timed
  e. full scale   the reference-scale scene (49 views at 1600x1200,
                  6,268 refpoints, every viewing camera a starting view)
                  through `python -m edgegraph3d_tpu.cli.edge_graph_3d`
                  in a child process, from PNG edge images and an
                  OpenMVG JSON, gated on quality against the
                  ground-truth curves
  f. gpu vs cpu   the 8-view cube scene on the card and in a child
                  process pinned to the CPU, compared

With --four-cards, after phase a only the mesh path runs: the
full-scale scene on a 4-card mesh with device claiming against one card
with host claiming, then joint BA sharded against single-device.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: the reference-scale scene (example/dtu006's shape)
FULL = dict(n_views=49, n_refpoints=6268, width=1600, height=1200)

#: phase-e quality gates (algorithm outputs, not speeds)
MIN_COVERAGE = 0.98
MAX_MED_DIST3D = 0.004
MIN_EDGE_POINTS = 30_000

#: shares of the card's memory: phase e runs the CLI in a child process
#: while this one holds the card, and JAX reserves 75% by default
SMOKE_MEM_FRACTION = "0.35"
CLI_MEM_FRACTION = "0.55"

#: phase-f bounds, GPU against CPU on the same code
MAX_POINTS_REL = 0.01
MAX_QUALITY_REL = 0.02


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Reporter:
    """Prints result lines, each labelled with the card."""

    def __init__(self, card: str = "no card"):
        self.card = card

    def __call__(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg} | {self.card}", flush=True)


def card_label() -> str:
    """`name, power limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


# ----------------------------------------------------------------------
# a. device
# ----------------------------------------------------------------------

def phase_device(n_cards: int):
    """Refuse to run anywhere but on `n_cards` GPUs; place the cache."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeFailure(f"JAX found no GPU (default backend "
                           f"{backend!r}); this test runs only on a card")
    devs = jax.devices()
    check(len(devs) >= n_cards,
          f"need {n_cards} GPUs, JAX sees {len(devs)}")
    from edgegraph3d_tpu import runtime
    runtime.start()
    card = card_label()
    print(f"[a] devices {devs}; device_kind {devs[0].device_kind!r}; "
          f"nvidia-smi: {card}", flush=True)
    return devs[:n_cards], Reporter(card)


# ----------------------------------------------------------------------
# b. native extraction
# ----------------------------------------------------------------------

def phase_native(say) -> None:
    from edgegraph3d_tpu import native
    check(native.get_extraction_lib() is not None,
          "the native extraction library did not load; production "
          "output depends on it")
    say("b", "native extraction library loaded")


# ----------------------------------------------------------------------
# c. precision
# ----------------------------------------------------------------------

def f_table_max_error(n_cams: int = 6, width: int = 1600,
                      height: int = 1200) -> float:
    """Max abs error of the production F table against float64 numpy
    (each F unit-norm, sign-aligned)."""
    import jax.numpy as jnp

    from edgegraph3d_tpu.core.synthetic import make_cube_scene
    from edgegraph3d_tpu.ops.geometry import all_fundamental_matrices

    sfmd, _, _ = make_cube_scene(n_cams=n_cams, n_refpoints_per_edge=4,
                                 width=width, height_px=height,
                                 focal=2.2 * width / 1.6)
    P = np.asarray(sfmd.P, np.float64)
    C = np.asarray(sfmd.center, np.float64)
    F_dev = np.asarray(all_fundamental_matrices(
        jnp.asarray(P, jnp.float32), jnp.asarray(C, jnp.float32)))
    err = 0.0
    for i in range(n_cams):
        for j in range(n_cams):
            if i == j:
                continue
            e2 = P[j] @ np.append(C[i], 1.0)
            cross = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]],
                              [-e2[1], e2[0], 0]])
            F = cross @ P[j] @ np.linalg.pinv(P[i])
            F = F / max(np.linalg.norm(F), 1e-20)
            a = F_dev[i, j]
            if np.dot(a.ravel(), F.ravel()) < 0:
                F = -F
            err = max(err, float(np.max(np.abs(a - F))))
    return err


def matmul_rel_error(n: int = 1024, precision=None, seed: int = 0) -> float:
    """Relative Frobenius error of one f32 [n, n] product against
    float64; `precision` None means the package-wide pin."""
    import jax
    import jax.numpy as jnp

    import edgegraph3d_tpu  # noqa: F401  (import installs the pin)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    c = np.asarray(jax.jit(lambda x, y: jnp.matmul(x, y,
                                                   precision=precision))(
        jnp.asarray(a), jnp.asarray(b)), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.linalg.norm(c - ref) / np.linalg.norm(ref))


def phase_precision(say, n: int = 1024) -> dict:
    import jax

    f_err = f_table_max_error()
    pinned = matmul_rel_error(n)
    default = matmul_rel_error(n, precision=jax.lax.Precision.DEFAULT)
    say("c", f"F table max abs error {f_err:.3e} (bound 1e-4)")
    say("c", f"f32 [{n},{n}] matmul relative error {pinned:.3e} under the "
        f"pin (bound 1e-5); {default:.3e} at Precision.DEFAULT")
    check(f_err < 1e-4, f"F table error {f_err:.3e} >= 1e-4")
    check(pinned < 1e-5, f"pinned matmul error {pinned:.3e} >= 1e-5: the "
          "package's precision pin does not hold on this device")
    return dict(f_table_max_abs_err=f_err, matmul_rel_err=pinned,
                matmul_rel_err_default=default)


# ----------------------------------------------------------------------
# d. similarity kernel against its host reference
# ----------------------------------------------------------------------

def stage1_inputs(sfmd, edge_imgs, config=None) -> dict:
    """The stage-1 similarity-graph inputs of a scene, as the pipeline
    builds them (extraction, context, close polylines)."""
    from edgegraph3d_tpu.config import DEFAULT_CONFIG
    from edgegraph3d_tpu.matching import polyline_stages, refpoints
    from edgegraph3d_tpu.plgs.extraction import extract_plgs

    cfg = config or DEFAULT_CONFIG
    stack = extract_plgs(edge_imgs, cfg)
    ctx = refpoints.build_context(sfmd, stack, cfg)
    inp = polyline_stages.similarity_inputs(sfmd, ctx)
    check(inp is not None, "no polyline close to any refpoint")
    return inp


def compare_similarity(inp: dict, E_cap: int = 1 << 22) -> dict:
    """Device kernel against host build on the same inputs.  Each path
    runs once to warm up and once timed; the device path's time spans
    upload, kernel and fetch of the compacted edge list."""
    from edgegraph3d_tpu.matching import polyline_stages as ps

    def timed(fn):
        fn()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    dev, t_dev = timed(lambda: ps.similarity_edges_device(inp, E_cap))
    host, t_host = timed(lambda: ps._similarity_edges_host(**inp))
    check(dev is not None, f"device path overflowed E_cap={E_cap}")
    check(host is not None, "host path found no edge")
    key_h = {(int(a), int(b)): float(w) for (a, b), w in zip(*host)}
    key_d = {(int(a), int(b)): float(w) for (a, b), w in zip(*dev)}
    same = set(key_h) == set(key_d)
    rel = max((abs(key_d[k] - w) / max(w, 1e-6)
               for k, w in key_h.items() if k in key_d), default=0.0)
    return dict(n_nodes=len(inp["used"]), n_edges_host=len(key_h),
                n_edges_device=len(key_d), same_edges=same,
                max_rel_err=rel, device_s=t_dev, host_s=t_host)


def phase_similarity(say, inp: dict) -> dict:
    r = compare_similarity(inp)
    say("d", f"U={r['n_nodes']} nodes, {r['n_edges_host']} host edges, "
        f"{r['n_edges_device']} device edges, identical={r['same_edges']}")
    say("d", f"max relative weight error {r['max_rel_err']:.3e} (bound "
        "0.02; TF32 rounding of the Precision.DEFAULT products)")
    say("d", f"device path {r['device_s']:.4f} s, host path "
        f"{r['host_s']:.4f} s (warm, upload+kernel+fetch vs numpy)")
    check(r["same_edges"], "device and host edge sets differ")
    check(r["max_rel_err"] < 0.02,
          f"weight error {r['max_rel_err']:.3e} >= 0.02")
    return r


# ----------------------------------------------------------------------
# e. full scale through the CLI
# ----------------------------------------------------------------------

def write_scene(folder: str, sfmd, edge_imgs) -> tuple[str, str]:
    """PNG edge images + OpenMVG JSON, as a user's input folder."""
    from edgegraph3d_tpu.core import sfm as sfm_io
    from edgegraph3d_tpu.io.png import write_png

    edges = os.path.join(folder, "edges")
    os.makedirs(edges)
    for v, path in enumerate(sfmd.image_paths):
        write_png(os.path.join(edges, os.path.basename(path)),
                  edge_imgs[v])
    sfm_json = os.path.join(folder, "input.json")
    sfm_io.write_sfm_data(sfmd, sfm_json)
    return edges, sfm_json


def compile_cache_state(platform: str) -> str:
    """Where a fresh process of the CLI keeps its persistent compile
    cache, and how many entries the cache holds now."""
    from edgegraph3d_tpu import runtime
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path is None:
        path = runtime.compile_cache_dir(platform)
    if not path:
        return "persistent compile cache disabled"
    n = len(os.listdir(path)) if os.path.isdir(path) else 0
    return f"persistent compile cache {path} held {n} entries at start"


def run_cli(folder: str, sfmd, edge_imgs, curves,
            timeout: int = 900) -> dict:
    """Write the scene, run `python -m edgegraph3d_tpu.cli.edge_graph_3d`
    in a child process, read the output back.  The child gets its own
    share of the card's memory (CLI_MEM_FRACTION)."""
    from bench import quality_metrics
    from edgegraph3d_tpu.core import sfm as sfm_io

    edges, sfm_json = write_scene(folder, sfmd, edge_imgs)
    work = os.path.join(folder, "work")
    out_json = os.path.join(folder, "output.json")
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION=CLI_MEM_FRACTION)
    sys.stdout.flush()
    t0 = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "edgegraph3d_tpu.cli.edge_graph_3d",
         folder, edges, work, sfm_json, out_json],
        cwd=REPO, env=env, timeout=timeout).returncode
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI exited {rc}")
    out = sfm_io.read_sfm_data(out_json)
    with open(os.path.join(work, "stats.json")) as f:
        manifest = json.load(f)
    return dict(wall_s=wall, quality=quality_metrics(out, sfmd, curves),
                timings=manifest["timings"], counters=manifest["counters"],
                peak_bytes_in_use=manifest["peak_bytes_in_use"])


def gate_full_scale(r: dict) -> list[str]:
    """Failed phase-e gates, as messages."""
    q, c = r["quality"], r["counters"]
    bad = []
    if q["coverage"] < MIN_COVERAGE:
        bad.append(f"coverage {q['coverage']:.4f} < {MIN_COVERAGE}")
    if q["med_dist3d"] > MAX_MED_DIST3D:
        bad.append(f"med_dist3d {q['med_dist3d']:.5f} > {MAX_MED_DIST3D}")
    if c.get("polylines_dropped_overflow", 0) != 0:
        bad.append(f"{c['polylines_dropped_overflow']} polylines dropped "
                   "to overflow")
    if q["edge_points"] <= MIN_EDGE_POINTS:
        bad.append(f"{q['edge_points']} edge-points <= {MIN_EDGE_POINTS}")
    return bad


def phase_full_scale(say, scene) -> dict:
    sfmd, edge_imgs, curves = scene
    cache = compile_cache_state("gpu")
    with tempfile.TemporaryDirectory(prefix="eg3d_smoke_") as folder:
        r = run_cli(folder, sfmd, edge_imgs, curves)
    q, c = r["quality"], r["counters"]
    say("e", f"CLI wall {r['wall_s']:.2f} s, a fresh process from start "
        f"to exit (compilation included; {cache})")
    for k, v in r["timings"].items():
        say("e", f"stage {k}: {v:.4f} s")
    say("e", f"edge-points {q['edge_points']}, med_dist3d "
        f"{q['med_dist3d']:.6f}, coverage {q['coverage']:.4f}")
    say("e", f"device_fetches {c.get('device_fetches')}, chains_truncated "
        f"{c.get('chains_truncated')}, polylines_dropped_overflow "
        f"{c.get('polylines_dropped_overflow')}")
    say("e", f"peak_bytes_in_use {r['peak_bytes_in_use']} (the CLI "
        "process's peak)")
    bad = gate_full_scale(r)
    check(not bad, "full-scale gates failed: " + "; ".join(bad))
    return r


# ----------------------------------------------------------------------
# f. GPU against CPU on the cube scene
# ----------------------------------------------------------------------

def run_cube8(width: int = 1600, height: int = 1200,
              n_ref_per_edge: int = 48) -> dict:
    """The 8-view cube scene, two starting views, default config, on
    JAX's default device."""
    import jax

    from bench import build_workload, quality_metrics
    from edgegraph3d_tpu.config import EdgeGraphConfig
    from edgegraph3d_tpu.pipeline import run_pipeline

    sfmd, edge_imgs, curves = build_workload(8, width, height,
                                             n_ref_per_edge)
    t0 = time.perf_counter()
    out = run_pipeline(sfmd, edge_imgs, EdgeGraphConfig(),
                       max_starting_views=2)
    wall = time.perf_counter() - t0
    return dict(platform=jax.default_backend(), wall_s=wall,
                **quality_metrics(out, sfmd, curves))


def cube8_child() -> None:
    """Entry of the CPU child: one JSON line on stdout."""
    from edgegraph3d_tpu import runtime
    runtime.start()
    print(json.dumps(run_cube8()), flush=True)


def run_cube8_cpu_child(timeout: int = 900) -> dict:
    """run_cube8 in a child pinned to the CPU; it never opens a card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.cube8_child()"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise SmokeFailure(f"CPU child exited {out.returncode}:\n"
                           + out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_cube8(gpu: dict, cpu: dict) -> dict:
    """Relative differences of the GPU run against the CPU run, and the
    failed bounds."""
    def rel(k):
        return abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)

    d = {k: rel(k) for k in ("edge_points", "coverage", "med_dist3d")}
    bad = [f"{k} differs by {v:.4f} (bound {MAX_POINTS_REL})"
           for k, v in d.items() if k == "edge_points"
           and v > MAX_POINTS_REL]
    bad += [f"{k} differs by {v:.4f} (bound {MAX_QUALITY_REL})"
            for k, v in d.items() if k != "edge_points"
            and v > MAX_QUALITY_REL]
    return dict(rel_diff=d, failed=bad)


def phase_gpu_vs_cpu(say) -> dict:
    gpu = run_cube8()
    check(gpu["platform"] == "gpu", f"cube8 ran on {gpu['platform']}")
    cpu = run_cube8_cpu_child()
    check(cpu["platform"] == "cpu", f"CPU child ran on {cpu['platform']}")
    for r in (gpu, cpu):
        say("f", f"cube8 on {r['platform']}: {r['edge_points']} "
            f"edge-points, med_dist3d {r['med_dist3d']:.6f}, coverage "
            f"{r['coverage']:.4f}, wall {r['wall_s']:.2f} s (the "
            "process's first run_pipeline call)")
    cmp = compare_cube8(gpu, cpu)
    say("f", "relative differences GPU vs CPU: " + ", ".join(
        f"{k} {v:.5f}" for k, v in cmp["rel_diff"].items()))
    check(not cmp["failed"], "; ".join(cmp["failed"]))
    return cmp


# ----------------------------------------------------------------------
# four cards: mesh path against one card
# ----------------------------------------------------------------------

def mesh_parity(scene, devices, say=None, config=None) -> dict:
    """The scene on a mesh over `devices` with device claiming (the
    lax.pmin interval merge) against one device with host claiming:
    same points to atol 1e-5."""
    from edgegraph3d_tpu.config import DEFAULT_CONFIG
    from edgegraph3d_tpu.parallel.mesh import make_mesh
    from edgegraph3d_tpu.pipeline import PipelineStats, run_pipeline

    sfmd, edge_imgs, _ = scene
    cfg = (config or DEFAULT_CONFIG).replace(claiming_backend="device")
    t0 = time.perf_counter()
    out_1 = run_pipeline(sfmd, edge_imgs,
                         cfg.replace(claiming_backend="host"),
                         stats=PipelineStats())
    wall_1 = time.perf_counter() - t0
    n_new = out_1.n_points - sfmd.n_points
    if say:
        say("4", f"one device: {out_1.n_points} points ({n_new} "
            f"edge-points), wall {wall_1:.2f} s "
            "(compilation included)")
    mesh = make_mesh(len(devices), devices=list(devices))
    t0 = time.perf_counter()
    out_m = run_pipeline(sfmd, edge_imgs, cfg, mesh=mesh,
                         stats=PipelineStats())
    wall_m = time.perf_counter() - t0
    # every device of the mesh must have held work (the single-device
    # run above used only the first)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    if say:
        say("4", f"mesh over {len(devices)} devices: {out_m.n_points} "
            f"points, wall {wall_m:.2f} s (compilation included); "
            f"per-device peak_bytes_in_use {peaks}")
    check(out_m.n_points == out_1.n_points,
          f"point counts differ: mesh {out_m.n_points}, single "
          f"{out_1.n_points}")
    # the two stage drivers may emit the same points in another order,
    # so compare the point sets (rows in lexicographic order)
    pm = out_m.points[np.lexsort(out_m.points.T[::-1])]
    p1 = out_1.points[np.lexsort(out_1.points.T[::-1])]
    err = float(np.max(np.abs(pm - p1))) if out_1.n_points else 0.0
    same_order = bool(np.array_equal(out_m.points, out_1.points))
    if say:
        say("4", f"max abs point difference {err:.3e} (bound 1e-5), "
            f"same order: {same_order}")
    check(err <= 1e-5, f"points differ by {err:.3e} > 1e-5")
    return dict(out=out_1, n_points=out_1.n_points, wall_mesh_s=wall_m,
                wall_single_s=wall_1, max_abs_diff=err,
                same_order=same_order, peaks=peaks)


def ba_parity(sfmd, devices, n_steps: int = 4, say=None) -> dict:
    """distributed_ba on a mesh over `devices` against ops.ba.ba_run,
    n_steps each: per-step MSE within 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from edgegraph3d_tpu.ops import ba as ba_ops
    from edgegraph3d_tpu.parallel import sharded
    from edgegraph3d_tpu.parallel.distributed import shard_global
    from edgegraph3d_tpu.parallel.mesh import make_mesh
    from edgegraph3d_tpu.pipeline import ba_problem

    mesh = make_mesh(len(devices), devices=list(devices))
    state, cam, xy, mask = ba_problem(sfmd, len(devices))
    t0 = time.perf_counter()
    st_m, mse_m = sharded.distributed_ba(
        mesh, state._replace(X=shard_global(mesh, state.X)),
        shard_global(mesh, cam), shard_global(mesh, xy),
        shard_global(mesh, mask), n_steps=n_steps)
    jax.block_until_ready((st_m, mse_m))
    wall_m = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_1, mse_1 = ba_ops.ba_run(state, jnp.asarray(cam), jnp.asarray(xy),
                                jnp.asarray(mask), n_steps, 1e-4)
    jax.block_until_ready((st_1, mse_1))
    wall_1 = time.perf_counter() - t0
    mse_m, mse_1 = np.asarray(mse_m), np.asarray(mse_1)
    rel = float(np.max(np.abs(mse_m - mse_1)
                       / np.maximum(np.abs(mse_1), 1e-30)))
    placed = sorted(str(s.device) for s in st_m.X.addressable_shards)
    if say:
        say("4", f"joint BA {n_steps} steps: MSE mesh {mse_m.tolist()} vs "
            f"single {mse_1.tolist()}, max relative difference "
            f"{rel:.3e} (bound 1e-4); walls {wall_m:.2f} s / "
            f"{wall_1:.2f} s (compilation included)")
        say("4", f"BA point shards on {placed}; sharding.device_set "
            f"{sorted(str(d) for d in st_m.X.sharding.device_set)}")
    check(len(set(placed)) == len(devices),
          f"BA shards landed on {placed}, not on {len(devices)} devices")
    check(rel <= 1e-4, f"BA MSE differs by {rel:.3e} > 1e-4")
    return dict(mse_mesh=mse_m.tolist(), mse_single=mse_1.tolist(),
                max_rel_diff=rel)


# ----------------------------------------------------------------------

def full_scene():
    from bench import build_full_workload
    return build_full_workload(FULL["n_views"], FULL["n_refpoints"],
                               FULL["width"], FULL["height"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path on four cards against "
                    "one card")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    t_start = time.perf_counter()
    devices, say = phase_device(n_cards)
    if args.four_cards:
        t0 = time.perf_counter()
        scene = full_scene()
        r = mesh_parity(scene, devices, say=say)
        ba_parity(r["out"], devices, say=say)
        say("4", f"four-card phase {time.perf_counter() - t0:.1f} s")
    else:
        t0 = time.perf_counter()
        phase_native(say)
        phase_precision(say)
        say("c", f"phases b-c {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scene = full_scene()
        phase_similarity(say, stage1_inputs(scene[0], scene[1]))
        say("d", f"phase d {time.perf_counter() - t0:.1f} s (scene build "
            "and extraction included)")
        t0 = time.perf_counter()
        phase_full_scale(say, scene)
        say("e", f"phase e {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_gpu_vs_cpu(say)
        say("f", f"phase f {time.perf_counter() - t0:.1f} s")
    say("-", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ["XLA_PYTHON_CLIENT_MEM_FRACTION"] = SMOKE_MEM_FRACTION
    sys.exit(main())
