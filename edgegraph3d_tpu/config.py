"""Single runtime configuration for the whole engine.

The reference scatters its tuning constants over compile-time #defines in
three headers (reference: include/edgegraph3d/utils/globals/global_defines.hpp:35-54,
include/edgegraph3d/plgs/polyline_graph_2d.hpp:56-80,
include/edgegraph3d/matching/plg_matching/plg_matching.hpp:39-62,
include/edgegraph3d/matching/polyline_matching/polyline_matcher.hpp:45,
include/edgegraph3d/filtering/gauss_newton.hpp:18,
include/edgegraph3d/filtering/outliers_filtering.hpp:16).  Here they are one
frozen dataclass so a run is fully described by (inputs, config).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class EdgeGraphConfig:
    # ---- PLG extraction / 2D graph optimization -------------------------
    #: Douglas-Peucker-style simplification tolerance in px
    #: (ref: polyline_graph_2d.hpp:69 MAXIMUM_LINEARIZABILITY_DISTANCE 1.0).
    simplify_tolerance_px: float = 1.0
    #: min angle cos for a "smooth" chain continuation
    #: (ref: polyline_graph_2d.hpp:64-65, 0.707).
    smooth_cos_min: float = 0.707
    #: keep components having >=1 polyline in the top fraction of smooth
    #: length (ref: polyline_graph_2d.hpp:67 TOP_FILTER_BY_POLYLINESMOOTHLENGTH 0.82).
    top_smooth_length_keep: float = 0.82
    #: max distance for connecting close extremes of different components
    #: (ref: polyline_graph_2d_hmap_impl.cpp:141-168, 6 px).
    connect_extremes_max_dist_px: float = 6.0
    #: degenerate loops shorter than this many coords are removed
    #: (ref: polyline_graph_2d_hmap_impl.cpp, < 5 coords).
    degenerate_loop_min_coords: int = 5
    #: loops with length >= this are split (ref: hmap_impl.cpp:237-253, 10).
    split_loop_min_len: int = 10
    #: pixel-graph cycle suppression BFS bound
    #: (ref: convert_edge_images_pixel_to_segment.cpp LOOP_CHECK_DIST 8).
    loop_check_dist: int = 8

    # ---- epipolar geometry ---------------------------------------------
    #: quasi-parallel epipolar/segment detection: |cos| above this within
    #: this distance counts as parallel (ref: polyline_graph_2d.hpp:72-74).
    quasiparallel_cos: float = 0.965
    quasiparallel_dist_px: float = 5.0
    #: min common refpoints for estimating F from correspondences
    #: (ref: geometric_utilities.cpp:750-781, 10).
    fmat_min_common_points: int = 10
    #: F-matrix source: "exact" (from the calibrated cameras,
    #: geometric_utilities.cpp:683-710) or "lmeds" (robust fit from
    #: common refpoint correspondences — the reference's production
    #: path, :750-781).  Default "exact": with bundle-adjusted poses the
    #: exact F dominates on clean data and stays within a fraction of
    #: the lmeds recall under pose noise (tests/test_fmat_ab.py
    #: quantifies the A/B on a noisy-pose scene); "lmeds" reproduces the
    #: reference's behavior of fitting the observation noise.
    fmat_source: str = "exact"

    # ---- PLG following / matching --------------------------------------
    #: step length on the driving view (ref: plg_matching.hpp:39
    #: PLG_FOLLOW_FIRST_IMAGE_DISTANCE 10).
    follow_first_image_dist_px: float = 10.0
    #: bounded distance clamp for epipolar-intersection steps on other
    #: views (ref: plg_matching.hpp:40-41, [5, 20] px).
    follow_min_dist_px: float = 5.0
    follow_max_dist_px: float = 20.0
    #: minimum views for a followed 3D point (ref: plg_matching.hpp:62, 3).
    min_views: int = 3
    #: a new plg point must survive this many following steps
    #: (ref: plg_matching.cpp:1276-1287, 2).
    new_point_min_steps: int = 2
    #: max following steps per sweep (JAX-native bound replacing the
    #: reference's unbounded while loop, plg_matching.cpp:765-795).
    max_follow_steps: int = 256
    #: GN acceptance during matching (ref: triangulation.cpp:168, MSE < 9 px^2).
    match_gn_max_mse: float = 9.0
    #: GN iterations during following steps: warm-started from the
    #: previous chain point, so few iterations reach the same fixed
    #: point as the reference's 30 cold-start iterations.
    follow_gn_iters: int = 8
    #: GN iterations (ref: triangulation.cpp:122 / gauss_newton.cpp:97, 30).
    gn_max_iters: int = 30
    #: GN convergence epsilon (ref: triangulation.cpp:150, 5e-7).
    gn_epsilon: float = 5e-7
    #: expand-all-views projection tolerance
    #: (ref: triangulation.hpp:46 MAX_3DPOINT_PROJECTIONDISTSQ_EXPANDALLVIEWS 16 px^2).
    expand_max_projection_distsq: float = 16.0
    #: expansion correspondence position: "epipolar" = intersect the
    #: driving-view epipolar line with the anchored polyline, falling
    #: back to the closest point (the reference's walk,
    #: triangulation.cpp:742-919 + projection/plmap fallback);
    #: "closest" = closest point only.  Default "closest": the A/B
    #: (tests/test_expansion.py::test_expansion_mode_ab) measures
    #: identical acceptance but ~2x lower reprojection error — the
    #: epipolar intersection amplifies the driving view's ~1 px
    #: polyline discretization by 1/sin(crossing angle), a noise the
    #: reference's output carries and this formulation avoids.
    expand_correspondence_mode: str = "closest"
    #: chain-extension rounds after expansion: chains whose EXPANDED
    #: observation set covers a chain end are re-followed outward from
    #: that end with a tuple drawn from the expanded view set — the
    #: reference's follow_direction tail that grows the chain with new
    #: 3D points once a new view matches to the chain end
    #: (ref: add_view_to_3dpoint_and_sides_plgp_matches_vector,
    #: plg_matching.cpp:1393-1412).  0 disables.
    max_extension_rounds: int = 1

    # ---- stage drivers --------------------------------------------------
    #: interval sampling distance along polylines in stages 1-2
    #: (ref: polyline_matching.hpp:51 SPLIT_INTERVAL_DISTANCE 20).
    split_interval_distance_px: float = 20.0
    #: refpoint-to-polyline distance for the similarity graph
    #: (ref: polyline_matcher.hpp:45 FIND_WITHIN_DIST 10).
    find_within_dist_px: float = 10.0
    #: stage-2 closeness matcher: required fraction of views with close
    #: polylines (ref: polyline_matcher.cpp:75-168, 0.7) and max
    #: min/max close-distance ratio (3).
    closeness_min_view_coverage: float = 0.7
    closeness_max_dist_ratio: float = 3.0
    #: refpoint stage detection radii (ref: global_defines.hpp: starting 10 px,
    #: correspondence radius = starting_dist * 3, capped at 30 px grid).
    detection_starting_dist_px: float = 10.0
    detection_correspondence_factor: float = 3.0
    #: DEVIATION: floor on the correspondence radius, as a fraction of
    #: detection_starting_dist_px.  The reference uses exactly
    #: `dist * 3` (plg_edge_manager.cpp:176), so a dead-on starting
    #: intersection (dist ~ 0) searches a zero radius and finds no
    #: correspondences; the floor keeps exact hits seedable.  0.0
    #: reproduces the reference precisely.  Measured on the bench
    #: scene (tests/test_detection_deviations.py): the floor only
    #: ADDS seeds whose starting intersection is (near-)exact — recall
    #: strictly >= the reference-exact setting, accuracy unchanged.
    detection_radius_floor_factor: float = 0.3

    # ---- chain extension (matching/refpoints.py extend_chains) ---------
    #: DEVIATION KNOBS for the extension stage, which generalizes the
    #: reference's add-view follow_direction tail
    #: (plg_matching.cpp:1393-1412) to the expanded view set; the
    #: reference has no analogous constants because its walks carry
    #: exact polyline positions end-to-end.
    #: re-anchor tolerance: an expanded 2D observation (a known
    #: polyline point, re-located via the grid) must lie within this
    #: distance of a polyline to anchor an extension walk.
    extension_reanchor_px: float = 2.0
    #: consistency gate: a view joins an extension tuple only if the
    #: chain end reprojects within this residual on it (a marginal
    #: observation inside the 9 px^2 MSE gate must not steer new
    #: geometry).  Measured A/B in tests/test_detection_deviations.py.
    extension_consistency_px: float = 2.0

    # ---- joint bundle adjustment (ops/ba.py) ---------------------------
    #: optional final joint-refinement stage: Schur-complement
    #: Levenberg-Marquardt steps over the augmented scene (cameras +
    #: all points free), run after reconstruction and before the
    #: outlier filter.  0 disables.  Generalizes the reference's
    #: per-point-only refinement (gauss_newton.cpp:136-178) to the
    #: multi-device joint solve (SURVEY §2.10 item 3); the A/B benefit
    #: is measured in tests/test_ba_pipeline.py.
    ba_steps: int = 0
    #: LM damping for the joint BA stage.
    ba_damping: float = 1e-4

    # ---- filtering ------------------------------------------------------
    #: final GN filter acceptance (ref: gauss_newton.hpp:18 GN_MAX_MSE 2.25 px^2).
    filter_gn_max_mse: float = 2.25
    #: min observations floor (ref: outliers_filtering.hpp:16
    #: FILTER_3VIEWS_AMOUNT 3; applied as max(3, median_rays/2 - 1)).
    filter_min_views: int = 3
    #: density-filter cell size (ref: filtering_close_plgps.cpp CELLSIZE 3 px).
    density_cell_size_px: int = 3

    # ---- 3D output graph post-ops (library surface in the reference,
    # exposed here as output options; see pipeline.py) -------------------
    #: simplify the saved 3D graph (ref: PolyLineGraph3D::simplify,
    #: polyline_graph_3d.cpp:355-365).
    output_3d_simplify: bool = False
    #: 3D linearizability tolerance (ref: polyline_graph_3d.hpp:65
    #: MAXIMUM_LINEARIZABILITY_DISTANCE 0.01).
    output_3d_simplify_tol: float = 0.01
    #: if set, fragment the saved 3D graph at this arc-length
    #: (ref: PolyLineGraph3D::fragment, polyline_graph_3d.cpp:99-122).
    output_3d_fragment_maxlen: float | None = None

    # ---- padding budgets (JAX-native: fixed shapes + masks) -------------
    #: sized by tools/capacity_audit.py on the full real dtu006 scene
    #: (49 views @1600x1200): worst view traces 5410 chains, so 8192
    #: gives zero drops with 1.5x headroom (2048 dropped >50%); chain
    #: length is p99=12 / max=52 coords after simplification, so 64
    #: covers every real chain without splitting at 1/4 the memory of
    #: the old 256.
    max_polylines_per_view: int = 8192
    max_polyline_len: int = 64
    max_obs_per_point: int = 64
    #: grid candidate list length per cell
    grid_cell_capacity: int = 8
    #: per-refpoint candidate intersections per view
    max_candidates_per_view: int = 4
    #: stage-1 community method (communities.py): "auto" = "union3" —
    #: sweep the union of the lp+merge, Louvain, and raw-LP partitions
    #: (interval claims dedup the overlap); the Louvain arm runs the
    #: deterministic batch-parallel local-moving pass (grappolo's own
    #: parallel design) above communities.LOUVAIN_MAX_NODES, so the
    #: union holds at multi-device scale.  Also "louvain" / "lp" / "lp+merge" /
    #: "union".  Measured against the grappolo objective in
    #: COMMUNITIES.md + tests/test_communities.py: no single
    #: partitioner dominates (LP collapses some scenes, Louvain's
    #: resolution limit merges others, raw LP wins some cluttered
    #: scenes) — the union recovers each arm's misses.
    #: (ref: driverForGraphClustering_edited.cpp:50-170,
    #: louvainMultiPhaseRun.cpp, parallelLouvainWithColoring.cpp).
    community_method: str = "auto"
    #: stage-1 similarity graph: close polylines kept per (refpoint,
    #: view).  The reference's close set is unbounded
    #: (polyline_matcher.cpp:244-278); tests/test_polyline_stages.py
    #: measures the cap's effect — edge counts saturate by 8 on a
    #: cluttered scene (round-2's 4 measurably truncated them).
    similarity_close_cap: int = 8

    #: interval-claim resolution backend: "host" (numpy sequential
    #: loop per chunk — faster at single-chip scale, claims live next
    #: to the host assembly code) or "device" (fixpoint kernel in
    #: matching/claiming_device.py whose owner raster min-reduces over
    #: the mesh with lax.pmin — the multi-device collective interval
    #: merge, SURVEY §2.10 item 2; bit-identical accept sets, asserted
    #: by tests/test_claiming.py).
    claiming_backend: str = "host"

    # ---- numerics -------------------------------------------------------
    #: compute dtype for geometry kernels on device. f32 + normalized
    #: coordinates matches the reference's f64 acceptance decisions:
    #: tests/test_f64_parity.py runs the synthetic e2e under
    #: jax_enable_x64 and asserts the accepted point/observation sets
    #: are IDENTICAL to the f32 run (measured: 0 obs flips, |dX| < 1e-6
    #: scene units).
    dtype: str = "float32"

    def replace(self, **kw) -> "EdgeGraphConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EdgeGraphConfig()
