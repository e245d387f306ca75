"""Image loading for RGB and binary edge images.

Replaces the reference's OpenCV imread path (reference:
src/edgegraph3d/utils/edge_graph_3d_utilities.cpp:285-344 parse_images).
Edge images are white-edge-on-black binary maps
(reference: global_defines.hpp EDGE_COLOR white).

PNGs are decoded by io/png.py; the other extensions need Pillow, which
is imported only for them.
"""

from __future__ import annotations

import os
import re

import numpy as np

from edgegraph3d_tpu.io.png import read_png


def _numeric_key(name: str):
    m = re.findall(r"\d+", name)
    return (int(m[-1]) if m else 0, name)


def list_image_files(folder: str) -> list[str]:
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}
    names = [n for n in os.listdir(folder)
             if os.path.splitext(n)[1].lower() in exts]
    return [os.path.join(folder, n) for n in sorted(names, key=_numeric_key)]


def _luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma in the fixed-point form Pillow's "L" uses."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _load(path: str, mode: str) -> np.ndarray:
    """Image at `path` as uint8 grey [H,W] (mode "L") or RGB [H,W,3]."""
    if os.path.splitext(path)[1].lower() != ".png":
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(
                f"reading {path!r} needs Pillow, which is not installed; "
                "convert the image to PNG") from None
        return np.asarray(Image.open(path).convert(mode))
    a = read_png(path)
    if a.dtype == np.uint16:
        a = (a >> 8).astype(np.uint8)
    if a.ndim == 3 and a.shape[2] == 2:      # grey + alpha
        a = a[..., 0]
    if a.ndim == 3:                          # RGB or RGBA
        rgb = a[..., :3]
        return _luma(rgb) if mode == "L" else rgb
    return a if mode == "L" else np.repeat(a[..., None], 3, axis=2)


def load_edge_image(path: str, threshold: int = 127) -> np.ndarray:
    """Load a binary edge image -> uint8 {0,255} [H,W]."""
    img = _load(path, "L")
    return np.where(img > threshold, 255, 0).astype(np.uint8)


def load_rgb_image(path: str) -> np.ndarray:
    return _load(path, "RGB")


def load_edge_images(folder: str, image_paths: list[str] | None = None,
                     pad_to_common: bool = True) -> np.ndarray:
    """Load all edge images in a folder into one [C,H,W] uint8 stack.

    If `image_paths` (from the SfM views) is given, files are matched to
    the view order by basename, mirroring parse_images' matching of the
    image folder to camerasPaths_ (edge_graph_3d_utilities.cpp:285-344).
    """
    files = list_image_files(folder)
    if image_paths:
        by_base = {os.path.basename(f): f for f in files}
        ordered = []
        for p in image_paths:
            base = os.path.basename(p)
            stem = os.path.splitext(base)[0]
            cand = by_base.get(base)
            if cand is None:
                matches = [f for f in files
                           if os.path.splitext(os.path.basename(f))[0] == stem]
                if not matches:
                    raise FileNotFoundError(
                        f"no edge image for view {p!r} in {folder!r}")
                cand = matches[0]
            ordered.append(cand)
        files = ordered
    imgs = [load_edge_image(f) for f in files]
    if pad_to_common:
        H = max(i.shape[0] for i in imgs)
        W = max(i.shape[1] for i in imgs)
        out = np.zeros((len(imgs), H, W), dtype=np.uint8)
        for c, im in enumerate(imgs):
            out[c, : im.shape[0], : im.shape[1]] = im
        return out
    return np.stack(imgs)
