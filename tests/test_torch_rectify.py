"""Rectification engines of rs_sfm_tpu_torch vs the JAX package on the CPU.

Every engine is integer or exact-float work on the same float32 pixel
targets and depths, so the port must be bit-exact to JAX: `packed24`,
`packed`, `sort` and `scatter` against the same JAX method, the port's
`pallas` (the z-buffer kernel, whose plain version runs on CPU tensors)
against JAX's exact `scatter` engine, and `fill_cracks` and
`small_motion_warp` against theirs.  The scene has depth ties (a few depth
levels under a zooming motion), negative depths, zero depths and void
pixels.  The z-buffer's tie rule is also held against a brute-force loop
on forced ties with -0.0 and +0.0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.geom.rspose import scanline_poses as j_scanline_poses
from rs_sfm_tpu.rectify.backproject import backproject as j_backproject
from rs_sfm_tpu.rectify.crackfill import fill_cracks as j_fill_cracks
from rs_sfm_tpu.rectify.warp import small_motion_warp as j_small_motion_warp
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.ops.kernels import zbuffer as kz
from rs_sfm_tpu_torch.rectify.backproject import backproject
from rs_sfm_tpu_torch.rectify.crackfill import fill_cracks
from rs_sfm_tpu_torch.rectify.warp import small_motion_warp

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

H, W, GAMMA = 40, 56, 0.9
INTR = Intrinsics(fx=50.0, fy=48.0, cx=W / 2.0, cy=H / 2.0)
JINTR = JaxIntrinsics(**dataclasses.asdict(INTR))
# A zoom (v along the optical axis) with rotation: sources fold onto
# shared targets, and on the few depth levels they tie.
V = np.array([0.05, -0.02, -0.6])
WR = np.array([0.01, -0.015, 0.02])
K = 0.1


def _scene(kind):
    rng = np.random.default_rng(3)
    depth = rng.choice(np.float32([1.5, 2.0, 3.0]), size=(H, W))
    depth[rng.uniform(size=(H, W)) < 0.05] = 0.0
    depth[rng.uniform(size=(H, W)) < 0.03] *= -1.0   # behind the camera
    if kind == "uint8":
        image = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        image[rng.uniform(size=(H, W)) < 0.03] = 1    # void pixels
    else:
        image = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
        image[rng.uniform(size=(H, W)) < 0.03] = 1.0 / 255.0
    r, t = j_scanline_poses(V, WR, K, H, GAMMA, dtype=jnp.float32)
    return image, depth.astype(np.float32), np.array(r), np.array(t)


def _port(image, depth, r, t, **kw):
    return backproject(torch.from_numpy(image), torch.from_numpy(depth),
                       torch.from_numpy(r), torch.from_numpy(t), INTR, **kw)


def _jax(image, depth, r, t, **kw):
    return j_backproject(jnp.asarray(image), jnp.asarray(depth),
                         jnp.asarray(r), jnp.asarray(t), JINTR, **kw)


def _assert_same(bt, bj, fields=("gs_image", "scattered", "coords_3d",
                                 "valid")):
    for f in fields:
        got, ref = getattr(bt, f).numpy(), np.asarray(getattr(bj, f))
        assert got.dtype == ref.dtype, (f, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=f)


@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("method", ["packed24", "packed", "sort", "scatter"])
def test_engine_bit_exact_to_jax(method, kind):
    image, depth, r, t = _scene(kind)
    bt = _port(image, depth, r, t, method=method)
    bj = _jax(image, depth, r, t, method=method)
    # The scene exercises conflicts: more live sources than hit targets.
    assert 0.3 * H * W < int(bt.scattered.sum()) < int(bt.valid.sum())
    _assert_same(bt, bj)


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_pallas_engine_bit_exact_to_jax_scatter(kind):
    """The port's z-buffer engine is held to the exact scatter engine, not
    to the TPU kernel's lossy window search."""
    image, depth, r, t = _scene(kind)
    bt = _port(image, depth, r, t, method="pallas")
    bj = _jax(image, depth, r, t, method="scatter")
    _assert_same(bt, bj)


@pytest.mark.parametrize("use_fy,use_scanline_pose",
                         [(False, True), (True, False)])
def test_backproject_options_bit_exact_to_jax(use_fy, use_scanline_pose):
    image, depth, r, t = _scene("uint8")
    kw = dict(use_fy=use_fy, use_scanline_pose=use_scanline_pose,
              method="scatter")
    _assert_same(_port(image, depth, r, t, **kw), _jax(image, depth, r, t,
                                                       **kw))


def _brute_force_splat(tx, ty, d, colors):
    """Minimum depth, ties to the lowest source id, in a plain loop."""
    h, w = d.shape
    gs = np.zeros((h, w, 3), np.float32)
    best = np.full((h, w), np.inf, np.float32)
    hit = np.zeros((h, w), bool)
    for s in range(h * w):
        i, j = divmod(s, w)
        if not (np.isfinite(tx[i, j]) and np.isfinite(ty[i, j])
                and np.isfinite(d[i, j])):
            continue
        x = int(np.floor(np.float32(tx[i, j]) + np.float32(0.5)))
        y = int(np.floor(np.float32(ty[i, j]) + np.float32(0.5)))
        if 0 <= x < w and 0 <= y < h and (not hit[y, x]
                                          or d[i, j] < best[y, x]):
            best[y, x], gs[y, x], hit[y, x] = d[i, j], colors[i, j], True
    return gs, hit


def test_zbuffer_ties_and_signed_zero_match_brute_force():
    rng = np.random.default_rng(7)
    h, w = 12, 20
    # Targets on a 4x5 grid of cells, so about 12 sources share each.
    tx = rng.integers(0, 5, (h, w)).astype(np.float32) * 4.0 + 0.49
    ty = rng.integers(0, 4, (h, w)).astype(np.float32) * 3.0 - 0.5
    d = rng.choice(np.float32([-1.0, -0.0, 0.0, 2.0]), size=(h, w))
    d[0, 3] = np.inf
    tx[1, 1] = np.nan
    ty[2, 2] = -0.51                        # rounds to row -1: off the image
    colors = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gs, hit = kz.zbuffer_splat(*(torch.from_numpy(a) for a in (tx, ty, d,
                                                                 colors)))
    gs_ref, hit_ref = _brute_force_splat(tx, ty, d, colors)
    np.testing.assert_array_equal(hit.numpy(), hit_ref)
    np.testing.assert_array_equal(gs.numpy(), gs_ref)
    assert int(hit.sum()) == 20


@pytest.mark.parametrize("kind", ["uint8", "float32"])
@pytest.mark.parametrize("offset,require_all", [(1, True), (2, False)])
def test_fill_cracks_bit_exact_to_jax(kind, offset, require_all):
    image, depth, r, t = _scene(kind)
    holes = np.array(_jax(image, depth, r, t, method="scatter").gs_image)
    got = fill_cracks(torch.from_numpy(holes), offset=offset,
                      require_all_neighbors=require_all)
    ref = j_fill_cracks(jnp.asarray(holes), offset=offset,
                        require_all_neighbors=require_all)
    assert got.numpy().dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.array_equal(got.numpy(), holes)  # some cracks filled


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_small_motion_warp_bit_exact_to_jax(kind):
    image, depth, _, _ = _scene(kind)
    v32, w32 = V.astype(np.float32), WR.astype(np.float32)
    bt = small_motion_warp(torch.from_numpy(image), torch.from_numpy(depth),
                           torch.from_numpy(v32), torch.from_numpy(w32), K,
                           GAMMA, INTR)
    bj = j_small_motion_warp(jnp.asarray(image), jnp.asarray(depth),
                             jnp.asarray(v32), jnp.asarray(w32), K, GAMMA,
                             JINTR)
    assert 0.3 * H * W < int(bt.scattered.sum())
    _assert_same(bt, bj)


def test_unknown_engine_raises():
    image, depth, r, t = _scene("uint8")
    with pytest.raises(ValueError):
        _port(image, depth, r, t, method="nearest")
