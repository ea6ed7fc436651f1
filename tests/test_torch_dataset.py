"""The port's dataset I/O against the JAX package's: the sweep-task layout
both ways, the PNG codec against imageio and Pillow, the PLY writer and
the named-camera registry.

  * A 48x48 pair saved by the JAX package is loaded by the port, and one
    saved by the port is loaded by the JAX package: every array equal to
    the other loader's.  Saved from the same render, the two packages'
    CSV files are byte-identical and their PNGs decode to equal pixels.
  * data/png.py reads PNGs written by imageio and Pillow, and PNGs that use
    each of the five row filters (written here filter by filter), equal
    to what imageio and Pillow read from them; imageio and Pillow read the
    port's PNGs back bit-exact.
  * write_ply writes the JAX package's bytes.
"""

import ast
import filecmp
import io
import os
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

import imageio.v3 as iio
import jax.numpy as jnp
from PIL import Image

import rs_sfm_tpu_torch
from rs_sfm_tpu.data import dataset as jds
from rs_sfm_tpu.data import intrinsics as jintr
from rs_sfm_tpu.data.ply import write_ply as j_write_ply
from rs_sfm_tpu.data.synthetic import castle_scene as j_castle
from rs_sfm_tpu.data.synthetic import default_intrinsics as j_default_intr
from rs_sfm_tpu.data.synthetic import render_pair as j_render
from rs_sfm_tpu_torch.data import dataset as tds
from rs_sfm_tpu_torch.data import intrinsics as tintr
from rs_sfm_tpu_torch.data import png
from rs_sfm_tpu_torch.data import synthetic as tsyn
from rs_sfm_tpu_torch.data.ply import write_ply
from rs_sfm_tpu_torch.geom.camera import Intrinsics

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
H = W = 48
V = (0.12, -0.05, 0.08)
WR = (0.003, -0.002, 0.004)


@pytest.fixture(scope="module")
def jax_pair():
    return j_render(j_castle(dtype=jnp.float64), j_default_intr(H, W), H, W,
                    gamma=0.9, k=0.0, v=np.array(V), w=np.array(WR),
                    dtype=jnp.float64)


def _as_port_pair(jp):
    """The JAX render as the port's SyntheticPair (CPU tensors)."""
    def frame(fr):
        return tsyn.SyntheticFrame(*(None if a is None else
                                     torch.from_numpy(np.array(a))
                                     for a in fr))
    return tsyn.SyntheticPair(
        frame1=frame(jp.frame1), frame2=frame(jp.frame2),
        intrinsics=Intrinsics(jp.intrinsics.fx, jp.intrinsics.fy,
                              jp.intrinsics.cx, jp.intrinsics.cy),
        gamma=jp.gamma, k=jp.k, v=torch.from_numpy(np.array(jp.v)),
        w=torch.from_numpy(np.array(jp.w)))


def _assert_same(a, b):
    """Two loaded PairData equal field by field."""
    assert a.intrinsics.fx == b.intrinsics.fx
    assert (a.intrinsics.cx, a.intrinsics.cy, a.intrinsics.fy) == (
        b.intrinsics.cx, b.intrinsics.cy, b.intrinsics.fy)
    assert (a.gamma, a.k) == (b.gamma, b.k)
    np.testing.assert_array_equal(a.v, b.v)
    np.testing.assert_array_equal(a.w, b.w)
    for fa, fb in ((a.frame1, b.frame1), (a.frame2, b.frame2)):
        for name in fa._fields:
            x, y = getattr(fa, name), getattr(fb, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


def test_port_loads_jax_dataset_and_writes_its_bytes(jax_pair, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jds.save_synthetic_pair(jax_pair, str(jdir))
    tds.save_synthetic_pair(_as_port_pair(jax_pair), str(tdir))
    _assert_same(tds.load_synthetic_pair(str(jdir)),
                 jds.load_synthetic_pair(str(jdir)))
    names = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if
                   p.is_file())
    assert names == sorted(p.relative_to(tdir) for p in tdir.rglob("*")
                           if p.is_file())
    assert len(names) == 29
    for name in names:
        if name.suffix == ".csv":
            assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
        else:
            np.testing.assert_array_equal(iio.imread(jdir / name),
                                          png.read(str(tdir / name)))


def test_jax_loads_port_dataset(tmp_path):
    pair = tsyn.render_pair(tsyn.castle_scene(torch.float64, "cpu"),
                            tsyn.default_intrinsics(H, W), H, W, gamma=0.9,
                            k=0.0, v=V, w=WR, dtype=torch.float64)
    tds.save_synthetic_pair(pair, str(tmp_path))
    got = jds.load_synthetic_pair(str(tmp_path))
    _assert_same(tds.load_synthetic_pair(str(tmp_path)), got)
    assert got.frame1.rs_image.shape == (H, W, 3)
    np.testing.assert_array_equal(got.v, np.array(V))


def _png_with_filters(img, filters):
    """A PNG of uint8 `img` whose row y uses filter filters[y % len]."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        raw.append(ft)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_codec_matches_imageio_and_pillow(channels):
    rng = np.random.default_rng(channels)
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    ys, xs = np.mgrid[0:23, 0:37]
    smooth = ((xs * 7 + ys * 3) % 256).astype(np.uint8)
    smooth = smooth if channels == 1 else np.repeat(smooth[..., None],
                                                    channels, -1)
    for img in (noise, smooth):
        # Each row filter alone, then all five in turn.
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
            blob = _png_with_filters(img, filters)
            np.testing.assert_array_equal(png.decode(blob), img)
            np.testing.assert_array_equal(iio.imread(blob, extension=".png"),
                                          img)
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(blob))), img)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        np.testing.assert_array_equal(png.decode(buf.getvalue()), img)
        # The port's writer with each row filter (the default "up" first).
        for row_filter in (None, 0, 1, 2, 3, 4):
            mine = (png.encode(img) if row_filter is None
                    else png.encode(img, row_filter=row_filter))
            np.testing.assert_array_equal(iio.imread(mine, extension=".png"),
                                          img)
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(mine))), img)
            np.testing.assert_array_equal(png.decode(mine), img)


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 40, 3), (40, 1, 2),
                                   (61, 5, 4), (5, 61), (33, 33, 3)])
def test_png_reads_every_filter_at_any_aspect(shape):
    """The reader's anti-diagonal pass (rows of the average and Paeth
    filters) on single rows and columns, tall and wide images, each row
    filter alone and all five in turn, against imageio."""
    img = np.random.default_rng(len(shape) * 100 + shape[0]).integers(
        0, 256, shape, dtype=np.uint8)
    for filters in ([3], [4], [4, 0, 3, 1, 2], [2, 2, 4]):
        blob = _png_with_filters(img, filters)
        np.testing.assert_array_equal(png.decode(blob), img)
        np.testing.assert_array_equal(iio.imread(blob, extension=".png"), img)


def test_png_round_trip_of_a_float_image(tmp_path):
    """A render's unit-float image through to_uint8, written and read."""
    img = np.random.default_rng(0).uniform(0, 1, (31, 17, 3))
    path = str(tmp_path / "x.png")
    png.write(path, tds.to_uint8(img))
    np.testing.assert_array_equal(png.read(path), jds._to_uint8(img))
    np.testing.assert_array_equal(iio.imread(path), jds._to_uint8(img))
    with pytest.raises(TypeError):
        png.encode(img)


def test_write_ply_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(20, 30, 3)) * 5.0
    pts[3, :5] = 0.0
    pts[4, 2] = np.nan
    cols = rng.uniform(0, 1, (20, 30, 3))
    mask = rng.uniform(size=(20, 30)) > 0.3
    for kw in (dict(), dict(mask=mask)):
        a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
        n_j = j_write_ply(str(a), pts, cols, **kw)
        n_t = write_ply(str(b), torch.from_numpy(pts), cols, **kw)
        assert n_j == n_t > 0
        assert a.read_bytes() == b.read_bytes()


def test_intrinsics_registry_matches_jax():
    assert sorted(tintr.REGISTRY) == sorted(jintr.REGISTRY)
    for name, intr in jintr.REGISTRY.items():
        got = tintr.get(name)
        assert (got.fx, got.fy, got.cx, got.cy) == (intr.fx, intr.fy,
                                                    intr.cx, intr.cy)
    with pytest.raises(KeyError, match="unknown camera"):
        tintr.get("nokia")


def test_port_imports_no_image_library():
    """The GPU machine has no imageio or Pillow: no file of the port, nor
    chip_smoke.py, imports either."""
    root = pathlib.Path(rs_sfm_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("imageio", "PIL"), (
                    f"{os.path.relpath(path, REPO)} imports {name}")
