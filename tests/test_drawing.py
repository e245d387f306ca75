"""Debug-image suite tests (the -i flag equivalent,
reference: drawing_utilities.cpp via edge_matcher.cpp:89-96,138-143)."""

import os

import numpy as np

from edgegraph3d_tpu.config import EdgeGraphConfig
from edgegraph3d_tpu.core import synthetic
from edgegraph3d_tpu.plgs.extraction import extract_plgs
from edgegraph3d_tpu.utils import drawing

CFG = EdgeGraphConfig().replace(max_polylines_per_view=256,
                                max_polyline_len=128)


def _scene():
    return synthetic.make_scene(n_cams=4, n_refpoints_per_curve=8,
                                width=160, height_px=120, focal=200.0,
                                seed=5)


def test_draw_plgs_by_polyline_and_component():
    sfmd, edges, _ = _scene()
    stack = extract_plgs(edges, CFG)
    by_pl = drawing.draw_plgs(stack, 160, 120)
    by_comp = drawing.draw_plgs(stack, 160, 120, color_by="component")
    assert by_pl.shape == by_comp.shape == (4, 120, 160, 3)
    assert by_pl.any() and by_comp.any()
    # drawn pixels coincide (same geometry, different colors)
    assert ((by_pl.sum(-1) > 0) == (by_comp.sum(-1) > 0)).all()


def test_draw_match_sets_and_epipolar(tmp_path):
    sfmd, edges, _ = _scene()
    stack = extract_plgs(edges, CFG)
    groups = [np.asarray([[0, 0], [1, 0], [2, 0]]),
              np.asarray([[0, 1], [3, 1]])]
    imgs = drawing.draw_match_sets(groups, stack, 160, 120)
    assert imgs.shape == (4, 120, 160, 3)

    from edgegraph3d_tpu.matching import refpoints as refpoints_mod
    ctx = refpoints_mod.build_context(sfmd, stack, CFG)
    ep = drawing.draw_epipolar_process(sfmd, np.asarray(ctx.F_table), 0,
                                       160, 120, stack=stack)
    assert ep.shape == (4, 120, 160, 3)
    # the observation cross is drawn in white on each viewing cam
    for c, xy in zip(sfmd.obs_cam[0],
                     np.asarray(sfmd.obs_xy[0]).reshape(-1, 2)):
        x, y = int(round(xy[0])), int(round(xy[1]))
        if 0 <= x < 160 and 0 <= y < 120:
            assert (ep[int(c), y, x] == 255).all()


def test_community_coloring_and_match_epipolars():
    """The two round-4 stage-1 recall oracles: community-colored PLGs
    (gray = unmatched) and the per-match-set epipolar overlay."""
    sfmd, edges, _ = _scene()
    stack = extract_plgs(edges, CFG)
    groups = [np.asarray([[0, 0], [1, 0], [2, 0]])]
    comm = drawing.draw_plgs_by_community(stack, groups, 160, 120)
    assert comm.shape == (4, 120, 160, 3)
    # uncolored polylines render dim gray; community members colored
    grayish = (comm == 70).all(-1)
    colored = (comm.sum(-1) > 0) & ~grayish
    assert grayish.any() and colored.any()
    # view 3 is in no community: only gray there
    assert not colored[3].any()

    from edgegraph3d_tpu.matching import refpoints as refpoints_mod
    ctx = refpoints_mod.build_context(sfmd, stack, CFG)
    epi = drawing.draw_match_set_epipolars(
        np.asarray(ctx.F_table), stack, groups[0], 160, 120)
    assert epi.shape == (4, 120, 160, 3)
    # matched polylines drawn white on their own views; epipolar lines
    # from the OTHER views land on member views
    white = (epi == 255).all(-1)
    assert white[0].any() and white[1].any() and white[2].any()
    nonwhite_color = (epi.sum(-1) > 0) & ~white
    assert nonwhite_color[[0, 1, 2]].any()
    # non-member view stays empty
    assert not epi[3].any()


def test_primitive_draw_family():
    """The reference primitive surface (drawing_utilities.cpp:53-135,
    785-843) mapped onto the numpy rasterizer."""
    img = np.zeros((60, 80, 3), np.uint8)
    red = np.asarray([255, 0, 0], np.uint8)
    drawing.draw_point(img, (10, 10), red)
    assert (img[10, 10] == red).all()
    drawing.draw_points(img, [(20, 10), (30, 10)])
    drawing.draw_reference_point(img, (40, 10), red)
    drawing.draw_intersection_point(img, (50, 10), red)
    drawing.draw_segment_on_img(img, (0, 30, 79, 30), red)
    assert (img[30, 40] == red).all()
    drawing.draw_segments_on_image(img, [(0, 40, 79, 40)])
    assert img[40].any()
    drawing.draw_line(img, (0.0, 1.0, -50.0), red)  # y = 50
    assert (img[50, 40] == red).all()
    drawing.draw_lines(img, [(1.0, 0.0, -5.0)])     # x = 5
    assert img[25, 5].any()
    drawing.draw_circle(img, (40, 30), 8, red)

    bg = np.asarray([10, 10, 10], np.uint8)
    green = np.asarray([0, 255, 0], np.uint8)
    blue = np.asarray([0, 0, 255], np.uint8)
    seg = [(5, 5, 70, 50)]
    fresh = drawing.draw_segments_on_newimage((60, 80), seg, bg, red)
    assert (fresh[0, 0] == bg).all() and (fresh[5, 5] == red).all()
    ext = drawing.draw_segments_on_newimage_with_extremes(
        (60, 80), seg, bg, red, green, blue)
    assert (ext[5, 5] == green).all() and (ext[50, 70] == blue).all()


def test_refpoint_overlays_and_pair_epipolars():
    """draw_refpoints_on_imgs (+circles), the img-pair family, and
    point epipolars (drawing_utilities.cpp:465-673,610-628); the pair
    epipolar line must pass through the partner observation."""
    sfmd, edges, _ = _scene()
    over = drawing.draw_refpoints_on_imgs(sfmd, 160, 120, radius=6.0,
                                          radius2=10.0)
    assert over.shape == (4, 120, 160, 3) and over.any()
    sub = drawing.draw_refpoints_on_imgs(sfmd, 160, 120, point_ids=[0])
    assert sub.any() and sub.sum() < over.sum()

    from edgegraph3d_tpu.plgs.extraction import extract_plgs
    from edgegraph3d_tpu.matching import refpoints as refpoints_mod
    stack = extract_plgs(edges, CFG)
    ctx = refpoints_mod.build_context(sfmd, stack, CFG)
    F = np.asarray(ctx.F_table)
    pair = drawing.draw_img_pair_refpoints(sfmd, 0, 1, 160, 120)
    assert pair.shape == (2, 120, 160, 3) and pair[0].any()
    epi = drawing.draw_img_pair_epipolars_refpoints(sfmd, F, 0, 1,
                                                    160, 120)
    assert epi.sum() > pair.sum()
    # geometric parity: epipolar line of cam-0 obs passes through the
    # cam-1 obs (within rasterization tolerance)
    pid = drawing._common_refpoints(sfmd, 0, 1)[0]
    x0 = drawing._obs_in_cam(sfmd, pid, 0)
    x1 = drawing._obs_in_cam(sfmd, pid, 1)
    line = F[0, 1] @ np.asarray([x0[0], x0[1], 1.0])
    d = abs(line @ np.asarray([x1[0], x1[1], 1.0]))
    d /= np.hypot(line[0], line[1])
    assert d < 1.5

    pe = drawing.draw_point_epipolars_on_imgs(sfmd, F, x0, 0, 160, 120)
    assert pe[0].any() and pe[1].any() and pe[2].any()


def test_projection_plg_variants_and_focus(tmp_path):
    """3D-point projections, bw/segment/single-color PLG renders,
    component+refpoint compose, and the numbered focus image
    (drawing_utilities.cpp:540-587,989-1191)."""
    sfmd, edges, _ = _scene()
    from edgegraph3d_tpu.plgs.extraction import extract_plgs
    stack = extract_plgs(edges, CFG)

    imgs = np.zeros((4, 120, 160, 3), np.uint8)
    drawing.draw_point_projections(imgs, [(30, 30), (50, 50)], [0, 1])
    assert imgs[0].any() and imgs[1].any() and not imgs[2].any()
    drawing.draw_3dpoints_on_imgs(
        imgs, [((0.0, 0.0, 1.0), [(70, 70)], [2])])
    assert imgs[2].any()

    bw = drawing.draw_plgs_bw(stack, 160, 120)
    on = bw.sum(-1) > 0
    assert on.any() and (bw[on] == 255).all()
    seg = drawing.draw_plgs(stack, 160, 120, color_by="segment")
    assert ((seg.sum(-1) > 0) == on).all()

    overlay = np.zeros((120, 160, 3), np.uint8)
    drawing.draw_polyline_graph_simplified(
        overlay, stack, 0, np.asarray([0, 255, 0], np.uint8))
    o = overlay.sum(-1) > 0
    assert o.any() and (overlay[o] == [0, 255, 0]).all()

    comp = drawing.draw_colored_components_and_edge_refpoints(
        stack, sfmd, 160, 120)
    assert (comp == 255).all(-1).any()

    assert drawing.draw_polyline_matches is drawing.draw_match_sets

    from edgegraph3d_tpu.matching import refpoints as refpoints_mod
    ctx = refpoints_mod.build_context(sfmd, stack, CFG)
    path = drawing.draw_and_write_focus_image(
        sfmd, np.asarray(ctx.F_table), 0, int(sfmd.obs_cam[0][0]), 7,
        str(tmp_path), 160, 120, stack=stack)
    assert os.path.exists(path) and "focus_000007" in path


def test_save_debug_images_full_suite(tmp_path):
    sfmd, edges, _ = _scene()
    stack = extract_plgs(edges, CFG)
    from edgegraph3d_tpu.matching import matches as mm
    from edgegraph3d_tpu.matching import refpoints as refpoints_mod
    ctx = refpoints_mod.build_context(sfmd, stack, CFG)
    manager = mm.MatchesManager(np.asarray(ctx.plg_length))
    pts = refpoints_mod.reconstruct_from_refpoints(
        sfmd, ctx, max_starting_views=1, manager=manager)
    drawing.save_debug_images(
        sfmd, str(tmp_path), stack=stack, rgb_images=edges,
        groups_stage1=[np.asarray([[0, 0], [1, 0]])],
        groups_stage2=[np.asarray([[2, 0], [3, 0]])],
        F_table=np.asarray(ctx.F_table), epipolar_refpoints=[0],
        manager=manager, edge_points=pts,
        P_mats=np.asarray(ctx.P_mats), ctx=ctx)
    names = os.listdir(tmp_path)
    for prefix in ("plgs_imgs", "plgs_comp", "output_on_imgs",
                   "output_on_plgs", "pmsg", "pmctr", "epipolar",
                   "claimed_intervals", "chains", "detection",
                   "pmsg_comm", "pmsg_epi"):
        assert any(n.startswith(prefix) for n in names), prefix
    # the claimed-interval overlay carries actual claims (red pixels)
    from edgegraph3d_tpu.io.png import read_png
    ci = [n for n in sorted(names) if n.startswith("claimed_intervals")]
    reds = 0
    for n in ci:
        img = read_png(str(tmp_path / n))
        reds += int(((img[..., 0] > 200) & (img[..., 1] < 100)).sum())
    assert reds > 0, "no claimed arcs rendered"
