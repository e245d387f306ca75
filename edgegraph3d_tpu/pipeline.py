"""Full edge-matching pipeline orchestration.

JAX-native equivalent of the reference's `edge_matching`
(reference: src/edgegraph3d/edge_matcher.cpp:61-146) and the pipeline
drivers (src/edgegraph3d/matching/plg_matching/pipelines.cpp:160-248):

    load SfM JSON + edge images
    -> extract polyline graphs (plgs/extraction.py)
    -> build device context (grids, F-table)
    -> stage 3: reconstruction from refpoints (matching/refpoints.py)
    -> 2D density filter (filtering/density.py)
    -> append edge-points, write before_filtering.json
    -> GN + view-count outlier filter (filtering/outliers.py)
    -> write output JSON

Stages 1-2 (polyline-similarity and closeness matching) are driven from
matching/polyline_stages.py when enabled.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from edgegraph3d_tpu.config import DEFAULT_CONFIG, EdgeGraphConfig
from edgegraph3d_tpu.core import sfm as sfm_io
from edgegraph3d_tpu.filtering.density import density_filter
from edgegraph3d_tpu.filtering.outliers import filter_sfm_data
from edgegraph3d_tpu.io.images import load_edge_images
from edgegraph3d_tpu.matching import refpoints as refpoints_mod
from edgegraph3d_tpu.plgs.extraction import extract_plgs


@dataclass
class PipelineStats:
    """Wall-clock + count bookkeeping (parity: print_final_stats,
    pipelines.cpp:178-199)."""
    timings: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    #: suppression/truncation/overflow observability (MatchesManager
    #: counters + extraction overflow), merged in by the drivers
    counters: dict = field(default_factory=dict)
    #: float-valued quality/diagnostic metrics (e.g. BA mse before/after)
    metrics: dict = field(default_factory=dict)

    def log(self, name: str, t0: float, count: int | None = None):
        self.timings[name] = time.time() - t0
        if count is not None:
            self.counts[name] = count

    def report(self) -> str:
        lines = ["=== edgegraph3d_tpu stats ==="]
        for k, v in self.timings.items():
            c = f"  ({self.counts[k]})" if k in self.counts else ""
            lines.append(f"  {k}: {v:.2f}s{c}")
        if self.counters:
            lines.append("  counters: " + ", ".join(
                f"{k}={v}" for k, v in self.counters.items()))
        if self.metrics:
            lines.append("  metrics: " + ", ".join(
                f"{k}={v:.6g}" for k, v in self.metrics.items()))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dict(
            timings={k: round(float(v), 4) for k, v in
                     self.timings.items()},
            counts={k: int(v) for k, v in self.counts.items()},
            counters={k: int(v) for k, v in self.counters.items()},
            metrics={k: float(v) for k, v in self.metrics.items()})


def config_hash(config: EdgeGraphConfig) -> str:
    import dataclasses
    import hashlib
    import json
    blob = json.dumps(dataclasses.asdict(config), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def write_run_manifest(working_folder: str, config: EdgeGraphConfig,
                       stats: PipelineStats, extra: dict | None = None
                       ) -> str:
    """Machine-readable per-run record `stats.json` in the working
    folder: config (+hash), stage timings, counts, counters, and any
    caller-supplied fields (e.g. quality metrics) — two runs become
    diffable by file instead of by scraping stderr.  Exceeds the
    reference's print-only `print_final_stats`
    (pipelines.cpp:178-199), as SURVEY §5 envisions."""
    import dataclasses
    import json
    manifest = dict(config_hash=config_hash(config),
                    config=dataclasses.asdict(config),
                    **stats.to_dict())
    if extra:
        manifest.update(extra)
    path = os.path.join(working_folder, "stats.json")
    os.makedirs(working_folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True, default=str)
        f.write("\n")
    return path


def edge_points_to_obs_lists(pts: refpoints_mod.EdgePoints):
    """EdgePoints tensors -> ragged per-point obs lists for SfMData."""
    obs_cam, obs_xy = [], []
    for i in range(len(pts.X)):
        cams = np.flatnonzero(pts.obs_mask[i]).astype(np.int32)
        obs_cam.append(cams)
        obs_xy.append(pts.obs_xy[i][cams].astype(np.float64))
    return obs_cam, obs_xy


def reconstruct_all_stages(sfmd, ctx, stats: PipelineStats,
                           stages=(1, 2, 3),
                           max_starting_views: int | None = None,
                           debug: dict | None = None):
    """Run the enabled reconstruction stages with one shared interval
    manager (parity: edge_reconstruction_pipeline, pipelines.cpp:201-248
    — stage 1 similarity, stage 2 closeness, stage 3 refpoints, each
    skipping intervals claimed by earlier stages)."""
    from edgegraph3d_tpu.matching import matches as matches_mod
    from edgegraph3d_tpu.matching import polyline_stages

    V = ctx.P_mats.shape[0]
    manager = matches_mod.MatchesManager(np.asarray(ctx.plg_length))
    pieces = []

    def run_group_stage(name, groups, offset):
        t0 = time.time()
        res = None
        if ctx.mesh is None:
            # fused megakernel path (see group_seeds_and_follow)
            round0, _ = polyline_stages.group_seeds_and_follow(groups,
                                                               ctx)
            if round0 is not None:
                res = refpoints_mod.sweep_seeds(
                    None, None, ctx, manager, seed_id_offset=offset,
                    precomputed=round0)
        else:
            seeds_np, grp = polyline_stages.seeds_from_match_sets(
                groups, ctx)
            if seeds_np is not None:
                res = refpoints_mod.sweep_seeds(
                    seeds_np, grp, ctx, manager, seed_id_offset=offset)
        n = 0
        if res is not None:
            pieces.append(res)
            n = len(res[0])
        stats.log(name, t0, n)

    if 1 in stages:
        t0 = time.time()
        groups1 = polyline_stages.similarity_match_sets(sfmd, ctx,
                                                        stats=stats)
        stats.log("stage1_similarity_graph", t0, len(groups1))
        if debug is not None:
            debug["groups1"] = groups1
        run_group_stage("stage1_sweep", groups1, 0)
    if 2 in stages:
        t0 = time.time()
        groups2 = polyline_stages.closeness_match_sets(sfmd, ctx)
        stats.log("stage2_closeness_graph", t0, len(groups2))
        if debug is not None:
            debug["groups2"] = groups2
        run_group_stage("stage2_sweep", groups2, 10 ** 7)
    if 3 in stages:
        t0 = time.time()
        n = 0
        if ctx.mesh is None:
            # fused megakernel path: detection + seeding + follow in one
            # device program per chunk, one blocking fetch each
            round0, _ = refpoints_mod.compute_and_follow_seeds(
                sfmd, ctx, max_starting_views=max_starting_views)
            res = (refpoints_mod.sweep_seeds(
                None, None, ctx, manager, seed_id_offset=2 * 10 ** 7,
                precomputed=round0) if round0 is not None else None)
        else:
            seeds_np, seed_ref = refpoints_mod.compute_seeds(
                sfmd, ctx, max_starting_views=max_starting_views)
            res = (refpoints_mod.sweep_seeds(
                seeds_np, seed_ref, ctx, manager,
                seed_id_offset=2 * 10 ** 7)
                if seeds_np is not None else None)
        if res is not None:
            pieces.append(res)
            n = len(res[0])
        stats.log("stage3_refpoints", t0, n)

    if not pieces:
        stats.counters.update(manager.counters)
        return refpoints_mod._empty_points(V)
    merged = [np.concatenate([p[i] for p in pieces]) for i in range(6)]
    t0 = time.time()
    pts = refpoints_mod.expand_and_assemble(ctx, *merged)
    stats.log("expand_all_views", t0, len(pts.X))
    t0 = time.time()
    pts = refpoints_mod.extend_chains(ctx, pts, manager,
                                      stats=stats)
    stats.log("chain_extension", t0,
              manager.counters.get("extension_points", 0))
    stats.counters.update(manager.counters)
    if debug is not None:
        debug["manager"] = manager
        debug["edge_points"] = pts
    return pts


def ba_problem(sfmd: sfm_io.SfMData, multiple: int = 1):
    """Joint-BA inputs for every point of `sfmd`: (BAState, obs_cam,
    obs_xy, obs_mask), the point-axis arrays (X included) as host
    numpy, padded to a pow2 bucket (compile-cache discipline) that
    `multiple` devices divide.  Padding rows carry no observation."""
    import jax.numpy as jnp

    from edgegraph3d_tpu.matching.refpoints import dense_observations
    from edgegraph3d_tpu.ops import ba as ba_ops

    N, V = sfmd.n_points, sfmd.n_cameras
    obs_xy, obs_mask = dense_observations(sfmd)
    Np = max(256, 1 << (N - 1).bit_length())
    Np = -(-Np // multiple) * multiple
    pad = Np - N
    X = np.pad(sfmd.points.astype(np.float32), ((0, pad), (0, 0)))
    xy = np.pad(obs_xy.astype(np.float32), ((0, pad), (0, 0), (0, 0)))
    mask = np.pad(obs_mask, ((0, pad), (0, 0)))
    cam = np.broadcast_to(np.arange(V, dtype=np.int32), (Np, V)).copy()
    state = ba_ops.BAState(
        K=jnp.asarray(sfmd.K, jnp.float32),
        R=jnp.asarray(sfmd.R, jnp.float32),
        t=jnp.asarray(sfmd.t, jnp.float32), X=X)
    return state, cam, xy, mask


def joint_ba_refine(sfmd: sfm_io.SfMData, n_steps: int,
                    damping: float = 1e-4, mesh=None):
    """Joint Schur-complement LM over the (augmented) scene: camera
    poses AND all 3D points free, intrinsics fixed, camera 0 gauge-
    fixed.  The flagship multi-device generalization of the reference's
    per-point-only refinement (gauss_newton.cpp:136-178) — see
    ops/ba.py for the solver and parallel/sharded.py for the psum'd
    multi-chip variant used when `mesh` is given.

    Returns (refined SfMData, mse_before, mse_after) in px^2."""
    import dataclasses

    import jax.numpy as jnp

    from edgegraph3d_tpu.ops import ba as ba_ops

    N, V = sfmd.n_points, sfmd.n_cameras
    if N == 0 or n_steps <= 0:
        return sfmd, None, None
    state, cam, xy, mask = ba_problem(
        sfmd, mesh.size if mesh is not None else 1)
    X = state.X
    Np = len(X)
    if mesh is not None:
        from edgegraph3d_tpu.parallel import sharded
        from edgegraph3d_tpu.parallel.distributed import shard_global
        state = ba_ops.BAState(K=state.K, R=state.R, t=state.t,
                               X=shard_global(mesh, X))
        st, mses = sharded.distributed_ba(
            mesh, state, shard_global(mesh, cam), shard_global(mesh, xy),
            shard_global(mesh, mask), n_steps=n_steps, damping=damping)
    else:
        st, mses = ba_ops.ba_run(state, jnp.asarray(cam), jnp.asarray(xy),
                                 jnp.asarray(mask), n_steps, damping)
    mse_after = ba_ops.ba_mse(st, jnp.asarray(cam), jnp.asarray(xy),
                              jnp.asarray(mask))
    # one host sync for everything (counted round trip)
    from edgegraph3d_tpu.ops.compaction import fetch
    flat = fetch(jnp.concatenate(
        [jnp.ravel(st.X).astype(jnp.float32),
         jnp.ravel(st.R).astype(jnp.float32),
         jnp.ravel(st.t).astype(jnp.float32),
         jnp.ravel(mses).astype(jnp.float32),
         jnp.reshape(mse_after, (1,)).astype(jnp.float32)]))
    o1 = Np * 3
    o2 = o1 + V * 9
    o3 = o2 + V * 3
    X_new = flat[:o1].reshape(Np, 3)
    R_new = flat[o1:o2].reshape(V, 3, 3)
    t_new = flat[o2:o3].reshape(V, 3)
    mses = flat[o3:o3 + n_steps]
    mse_after = flat[o3 + n_steps]
    R_new = R_new.astype(np.float64)
    t_new = t_new.astype(np.float64)
    out = dataclasses.replace(
        sfmd, points=X_new[:N].astype(np.float64), R=R_new, t=t_new,
        center=-np.einsum("vji,vj->vi", R_new, t_new))
    return out, float(mses[0]), float(mse_after)


def run_pipeline(
    sfmd: sfm_io.SfMData,
    edge_images: np.ndarray,
    config: EdgeGraphConfig = DEFAULT_CONFIG,
    working_folder: str | None = None,
    max_starting_views: int | None = None,
    stats: PipelineStats | None = None,
    stages=(1, 2, 3),
    mesh=None,
    debug_images: bool = False,
) -> sfm_io.SfMData:
    """In-memory pipeline: returns the filtered, edge-augmented scene.

    With `mesh` (a 1-D `jax.sharding.Mesh`) every device sweep shards its
    work-item axis over the mesh (parallel/sharded.py)."""
    from edgegraph3d_tpu.ops import compaction
    stats = stats if stats is not None else PipelineStats()
    fetch0 = compaction.TRANSFER_COUNT[0]

    t0 = time.time()
    plg_ckpt = (os.path.join(working_folder, "plgs.npz")
                if working_folder else None)
    if plg_ckpt and os.path.exists(plg_ckpt):
        # stage-level resume (replaces the reference's unused read_plgs
        # path, plg_handling.cpp:59-67)
        from edgegraph3d_tpu.plgs.plg_io import load_plg_stack
        stack = load_plg_stack(plg_ckpt)
    else:
        stack = extract_plgs(edge_images, config)
        if plg_ckpt:
            os.makedirs(working_folder, exist_ok=True)
            from edgegraph3d_tpu.plgs.plg_io import save_plg_stack
            save_plg_stack(stack, plg_ckpt)
    stats.log("plg_extraction", t0, int((stack.length >= 2).sum()))
    stats.counters["polylines_dropped_overflow"] = stack.overflow_dropped
    if stack.overflow_dropped:
        import sys
        print(f"WARNING: {stack.overflow_dropped} polylines dropped to "
              f"the max_polylines_per_view={config.max_polylines_per_view}"
              " budget — raise it to keep full recall", file=sys.stderr)

    t0 = time.time()
    ctx = refpoints_mod.build_context(sfmd, stack, config, mesh=mesh)
    stats.log("context(F+grids)", t0)

    debug: dict | None = {} if debug_images else None
    pts = reconstruct_all_stages(sfmd, ctx, stats, stages,
                                 max_starting_views, debug=debug)

    t0 = time.time()
    keep = density_filter(pts.obs_xy, pts.obs_mask,
                          int(sfmd.widths.max()), int(sfmd.heights.max()),
                          cell=config.density_cell_size_px)
    pts = pts.select(keep)
    stats.log("density_filter", t0, len(pts.X))

    first_edgepoint = sfmd.n_points
    obs_cam, obs_xy = edge_points_to_obs_lists(pts)
    augmented = sfm_io.add_edge_points(sfmd, pts.X, obs_cam, obs_xy)

    if working_folder:
        os.makedirs(working_folder, exist_ok=True)
        sfm_io.write_sfm_data(
            augmented, os.path.join(working_folder, "before_filtering.json"))
        # 3D polyline graph checkpoint ("outgraph.3dg" equivalent,
        # pipelines.cpp:233), with the reference's library post-ops as
        # output options (simplify tol 0.01, polyline_graph_3d.hpp:65;
        # fragment, polyline_graph_3d.cpp:99-122)
        from edgegraph3d_tpu.plgs.polyline_graph_3d import \
            assemble_from_edge_points
        plg3d = assemble_from_edge_points(pts, sfmd.n_cameras)
        if config.output_3d_simplify:
            plg3d = plg3d.simplify(config.output_3d_simplify_tol)
        if config.output_3d_fragment_maxlen is not None:
            plg3d = plg3d.fragment(config.output_3d_fragment_maxlen)
        plg3d.save(os.path.join(working_folder, "outgraph_3d.npz"))

    if config.ba_steps > 0:
        # optional joint refinement: cameras + points free (new
        # capability over the reference's point-only GN; measured A/B
        # in tests/test_ba_pipeline.py), then the standard
        # filter judges the refined geometry below.
        t0 = time.time()
        augmented, mse0, mse1 = joint_ba_refine(
            augmented, config.ba_steps, config.ba_damping, mesh=mesh)
        stats.log("joint_ba", t0, config.ba_steps)
        if mse0 is not None:
            stats.metrics["ba_mse_before"] = mse0
            stats.metrics["ba_mse_after"] = mse1

    t0 = time.time()
    filtered = filter_sfm_data(augmented, first_edgepoint,
                               gn_max_mse=config.filter_gn_max_mse,
                               min_views_floor=config.filter_min_views,
                               epsilon=config.gn_epsilon)
    stats.log("outlier_filter", t0, filtered.n_points)

    # blocking device->host round trips this run (each is a host sync
    # that stalls the dispatch queue)
    stats.counters["device_fetches"] = \
        compaction.TRANSFER_COUNT[0] - fetch0

    if working_folder:
        # machine-readable per-run manifest (diffable across runs);
        # the device peak is the process's (None where the backend
        # keeps no memory statistics, as the CPU does)
        import jax
        write_run_manifest(working_folder, config, stats, extra=dict(
            n_views=sfmd.n_cameras, n_refpoints=sfmd.n_points,
            n_edge_points_prefilter=augmented.n_points - first_edgepoint,
            n_edge_points=filtered.n_points - first_edgepoint,
            n_points_out=filtered.n_points,
            peak_bytes_in_use=[(d.memory_stats() or {}).get(
                "peak_bytes_in_use") for d in jax.local_devices()]))

    if debug_images and working_folder:
        # full -i debug suite (parity: edge_matcher.cpp:89-96,138-143)
        from edgegraph3d_tpu.utils.drawing import save_debug_images
        t0 = time.time()
        save_debug_images(
            filtered, working_folder, stack=stack,
            first_edgepoint=first_edgepoint, rgb_images=edge_images,
            groups_stage1=(debug or {}).get("groups1"),
            groups_stage2=(debug or {}).get("groups2"),
            F_table=np.asarray(ctx.F_table),
            epipolar_refpoints=range(0, min(3, sfmd.n_points)),
            manager=(debug or {}).get("manager"),
            edge_points=(debug or {}).get("edge_points"),
            P_mats=np.asarray(ctx.P_mats), ctx=ctx)
        stats.log("debug_images", t0)
    return filtered


def edge_matching(images_folder: str, edges_folder: str,
                  working_folder: str, sfm_data_file: str,
                  output_json: str,
                  config: EdgeGraphConfig = DEFAULT_CONFIG,
                  max_starting_views: int | None = None,
                  debug_images: bool = False) -> sfm_io.SfMData:
    """File-level entry (parity: edge_matching, edge_matcher.cpp:61-146).

    `images_folder` is accepted for interface parity (RGB images are only
    needed for debug drawing / colored PLY output)."""
    stats = PipelineStats()
    sfmd = sfm_io.read_sfm_data(sfm_data_file)
    edge_images = load_edge_images(edges_folder, sfmd.image_paths)
    out = run_pipeline(sfmd, edge_images, config, working_folder,
                       max_starting_views, stats,
                       debug_images=debug_images)
    sfm_io.write_sfm_data(out, output_json)
    print(stats.report())
    return out
