"""PNG codec (io/png.py) and the image loaders built on it.

Test files are made by a plain reference encoder below (scalar row
filters straight from the PNG specification), decoded by io/png.py, and
where Pillow is installed also decoded by Pillow: the two decoders must
agree sample for sample.
"""

import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from edgegraph3d_tpu.io import png
from edgegraph3d_tpu.io.images import load_edge_image, load_rgb_image

try:
    from PIL import Image
except ImportError:  # the codec itself must not need it
    Image = None

# (colour type, bit depth) pairs the specification allows
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
           (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
           (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the five filter types, and every row a different one
FILTERS = [0, 1, 2, 3, 4, "mixed"]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype, row, prior, bpp):
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
        out.append((x - pred) % 256)
    return out


def _encode(samples, ctype, depth, filters, palette=None):
    """Reference encoder: samples [H, W, C] -> PNG bytes."""
    H, W, C = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(H, -1)
    elif depth == 8:
        rows = samples.reshape(H, -1).astype(np.uint8)
    else:
        bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1))
                & 1).reshape(H, W * depth).astype(np.uint8)
        rows = np.packbits(bits, axis=1)
    bpp = max(1, C * depth // 8)
    raw = bytearray()
    prior = [0] * rows.shape[1]
    for y in range(H):
        ftype = y % 5 if filters == "mixed" else filters
        row = [int(v) for v in rows[y]]
        raw.append(ftype)
        raw.extend(_filter_row(ftype, row, prior, bpp))
        prior = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (out + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _case(ctype, depth, seed=0, H=5, W=7):
    """Random samples, their PNG bytes' expected decode, and palette."""
    rng = np.random.default_rng(seed)
    C = CHANNELS[ctype]
    samples = rng.integers(0, 1 << depth, (H, W, C)).astype(
        np.uint16 if depth == 16 else np.uint8)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        expect = palette[samples[..., 0]].astype(np.uint8)
    elif C == 1:
        expect = samples[..., 0]
        if depth < 8:
            expect = expect * (255 // ((1 << depth) - 1))
    else:
        expect = samples
    return samples, expect, palette


def _pil_samples(data, like):
    """Pillow's decode of PNG bytes, in the layout decode_png returns
    (Pillow keeps only the high byte of 16-bit colour images)."""
    import io
    im = Image.open(io.BytesIO(data))
    if im.mode == "P":
        im = im.convert("RGB")
    elif im.mode == "1":
        im = im.convert("L")
    elif like.ndim == 3 and like.shape[2] == 2 and im.mode != "LA":
        im = im.convert("LA")      # Pillow opens 16-bit grey+alpha as RGBA
    got = np.asarray(im)
    if like.dtype == np.uint16 and got.dtype == np.uint8:
        like = (like >> 8).astype(np.uint8)
    return got, like


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_decode_matches_reference_encoder(ctype, depth, filters):
    samples, expect, palette = _case(ctype, depth, seed=depth + ctype)
    data = _encode(samples, ctype, depth, filters, palette)
    got = png.decode_png(data)
    assert got.dtype == expect.dtype
    np.testing.assert_array_equal(got, expect)
    if Image is not None:
        pil, mine = _pil_samples(data, got)
        np.testing.assert_array_equal(pil.astype(np.int64),
                                      mine.astype(np.int64))


@pytest.mark.parametrize("shape", [(1, 1), (4, 9), (33, 17), (3, 5, 3),
                                   (16, 31, 3)])
def test_writer_round_trip(shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "img.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    if Image is not None:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


@pytest.mark.parametrize("mode", ["1", "L", "I;16", "LA", "RGB", "RGBA",
                                  "P1", "P2", "P4", "P8"])
def test_reads_pillow_written_files(mode, tmp_path):
    """Pillow picks its own filters per row; the reader must agree with
    Pillow's own decode of every mode Pillow writes."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(len(mode))
    H, W = 23, 37
    # an edge-map-like pattern (long runs) plus noise, so that Pillow's
    # adaptive filtering uses several filter types
    base = (np.add.outer(np.arange(H), np.arange(W)) * 7 % 256)
    noise = rng.integers(0, 256, (H, W))
    grey = np.where(rng.random((H, W)) < 0.3, noise, base).astype(np.uint8)
    kw = {}
    if mode == "1":
        im = Image.fromarray(grey > 127)
    elif mode == "I;16":
        im = Image.fromarray(grey.astype(np.uint16) * 257)
    elif mode in ("LA", "RGB", "RGBA"):
        C = {"LA": 2, "RGB": 3, "RGBA": 4}[mode]
        im = Image.fromarray(np.stack([grey, 255 - grey, noise.astype(
            np.uint8), grey // 2][:C], axis=-1), mode=mode)
    elif mode.startswith("P"):
        bits = int(mode[1:])
        im = Image.fromarray(grey >> (8 - bits)).convert("L")
        im = im.convert("P")
        im.putpalette(list(rng.integers(0, 256, 768)))
        kw = dict(bits=bits)
    else:
        im = Image.fromarray(grey)
    path = str(tmp_path / "pil.png")
    im.save(path, **kw)
    mine = png.read_png(path)
    with open(path, "rb") as f:
        pil, mine = _pil_samples(f.read(), mine)
    np.testing.assert_array_equal(pil.astype(np.int64),
                                  mine.astype(np.int64))


def test_interlaced_is_refused():
    samples, _, _ = _case(0, 8)
    data = bytearray(_encode(samples, 0, 8, 0))
    # IHDR's interlace byte is the last of its 13; patch it and its CRC
    data[8 + 8 + 12] = 1
    data[8 + 8 + 13:8 + 8 + 17] = struct.pack(
        ">I", zlib.crc32(bytes(data[12:8 + 8 + 13])))
    with pytest.raises(png.PNGError, match="interlaced"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("damage", ["signature", "crc", "truncated"])
def test_damaged_files_are_refused(damage):
    samples, _, _ = _case(2, 8)
    data = bytearray(_encode(samples, 2, 8, 0))
    if damage == "signature":
        data[1] = ord("X")
    elif damage == "crc":
        data[-20] ^= 0xFF
    else:
        data = data[:-14]
    with pytest.raises(png.PNGError):
        png.decode_png(bytes(data))


def test_writer_refuses_other_layouts():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 8), (0, 16), (2, 8),
                                         (2, 16), (3, 4), (4, 8), (6, 8)])
def test_edge_and_rgb_loaders_match_pillow(ctype, depth, tmp_path):
    """load_edge_image / load_rgb_image give Pillow's convert("L") and
    convert("RGB") results byte for byte."""
    pytest.importorskip("PIL")
    samples, _, palette = _case(ctype, depth, seed=3, H=9, W=11)
    path = tmp_path / "img.png"
    path.write_bytes(_encode(samples, ctype, depth, "mixed", palette))
    grey = np.asarray(Image.open(path).convert("L"))
    if depth == 16:   # Pillow's "L" of 16-bit grey clips; we take >> 8
        grey = (samples[..., 0] >> 8).astype(np.uint8) if ctype == 0 \
            else grey
    np.testing.assert_array_equal(load_edge_image(str(path)),
                                  np.where(grey > 127, 255, 0))
    if ctype != 0 or depth != 16:
        np.testing.assert_array_equal(
            load_rgb_image(str(path)),
            np.asarray(Image.open(path).convert("RGB")))


def test_non_png_without_pillow_names_the_file(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = tmp_path / "edges_0001.jpg"
    path.write_bytes(b"not read")
    with pytest.raises(ImportError, match="edges_0001.jpg"):
        load_edge_image(str(path))


def test_main_path_imports_without_pillow():
    code = ("import sys; sys.modules['PIL'] = None; "
            "import edgegraph3d_tpu.pipeline, edgegraph3d_tpu.utils.drawing,"
            " edgegraph3d_tpu.cli.edge_graph_3d; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
