"""The synthetic renderer and its ground truth: rs_sfm_tpu_torch vs the JAX
package on the CPU in float64.

  * `render_pair` of the castle at 40x64 (the JAX scene carried across by
    `scene_from_numpy`): depth, unprojection, poses and the hit mask
    within 1e-9, colour within 1e-6.  Colour is looser because
    `_hash_noise` multiplies `sin` of arguments up to a few thousand by
    43758.5: one float64 ulp of `sin` moves the texture by about 1e-12
    (one float32 ulp by about 1e-2, so colour is never compared in
    float32);
  * `true_flow` (with and without the sub-scanline step) and
    `true_depth_from_unprojection` on that render, within 1e-9;
  * `apply_photometric` with the JAX package's normal draws injected,
    within 1e-12: exposure, tone curve, vignette and noise, and the camera
    pipeline's blur, motion streak, JPEG quantization and demosaic (every
    case's JAX reference from one jitted function);
  * the repetitive-texture castle's render, colour within 1e-6;
  * `gauss_inv`, `beta2` and `relocate_poses` within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_sfm_tpu.data import dataset as jdataset
from rs_sfm_tpu.data import synthetic as jsyn
from rs_sfm_tpu.flow.true_flow import true_flow as jax_true_flow
from rs_sfm_tpu.geom import rspose as jrs
from rs_sfm_tpu.ops import linalg as jlinalg
from rs_sfm_tpu_torch.data import dataset as tdataset
from rs_sfm_tpu_torch.data import scene_from_numpy
from rs_sfm_tpu_torch.data import synthetic as tsyn
from rs_sfm_tpu_torch.flow.true_flow import true_flow
from rs_sfm_tpu_torch.geom import rspose as trs
from rs_sfm_tpu_torch.ops import linalg as tlinalg

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

H, W = 40, 64
GAMMA = 0.9
V = np.array([0.35, -0.15, 0.25])
WV = np.array([0.003, -0.002, 0.004])
GEOMETRY_ATOL = 1e-9
COLOR_ATOL = 1e-6


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, port pair, JAX intrinsics, port intrinsics) of the castle
    at 40x64 in float64, k = 0.3 so that β carries its quadratic term."""
    scene = jsyn.castle_scene(dtype=jnp.float64)
    jintr = jsyn.default_intrinsics(H, W)
    tintr = tsyn.default_intrinsics(H, W)
    jp = jsyn.render_pair(scene, jintr, H, W, gamma=GAMMA, k=0.3, v=V, w=WV,
                          dtype=jnp.float64)
    tscene = scene_from_numpy(scene, device="cpu")
    tp = tsyn.render_pair(tscene, tintr, H, W, gamma=GAMMA, k=0.3, v=V,
                          w=WV, dtype=torch.float64)
    return jp, tp, jintr, tintr


def test_default_intrinsics_and_scene():
    j = jsyn.default_intrinsics(1080, 1920)
    t = tsyn.default_intrinsics(1080, 1920)
    assert (t.fx, t.fy, t.cx, t.cy) == (j.fx, j.fy, j.cx, j.cy)
    js = jsyn.castle_scene(dtype=jnp.float64)
    ts = tsyn.castle_scene(torch.float64, device="cpu")
    for f in ("origins", "edge1", "edge2", "base_color"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert ts.velocity is None and ts.periodic is None


@pytest.mark.parametrize("frame", ["frame1", "frame2"])
def test_render_pair_matches_jax(pairs, frame):
    jp, tp, _, _ = pairs
    jf, tf = getattr(jp, frame), getattr(tp, frame)
    for name in ("rs_depth", "gs_depth", "rs_unproject", "gs_unproject",
                 "poses_r", "poses_t"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), rtol=0,
                                   atol=GEOMETRY_ATOL, err_msg=name)
    for name in ("rs_depth", "gs_depth"):
        hit_t = getattr(tf, name).numpy() > 0
        np.testing.assert_array_equal(hit_t, np.asarray(getattr(jf, name)) > 0)
        assert 0.5 < hit_t.mean() <= 1.0
    np.testing.assert_array_equal(tf.mover_mask.numpy(),
                                  np.asarray(jf.mover_mask))
    for name in ("rs_image", "gs_image"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), rtol=0,
                                   atol=COLOR_ATOL, err_msg=name)


def test_render_movers_match_jax():
    """The JAX stress scene (a near slab and two independently moving
    cards) carried across: each scanline sees a mover where it is at its
    own readout time, and the mover mask flags its pixels."""
    scene = jsyn.stress_scene(dtype=jnp.float64)
    intr = jsyn.default_intrinsics(H, W)
    jp = jsyn.render_pair(scene, intr, H, W, gamma=GAMMA, k=0.0, v=V, w=WV,
                          dtype=jnp.float64)
    tscene = scene_from_numpy(scene, device="cpu")
    tp = tsyn.render_pair(tscene, tsyn.default_intrinsics(H, W), H, W,
                          gamma=GAMMA, k=0.0, v=V, w=WV, dtype=torch.float64)
    for frame in ("frame1", "frame2"):
        jf, tf = getattr(jp, frame), getattr(tp, frame)
        for name in ("rs_depth", "rs_unproject", "gs_depth"):
            np.testing.assert_allclose(getattr(tf, name).numpy(),
                                       np.asarray(getattr(jf, name)), rtol=0,
                                       atol=GEOMETRY_ATOL, err_msg=name)
        np.testing.assert_allclose(tf.rs_image.numpy(),
                                   np.asarray(jf.rs_image), rtol=0,
                                   atol=COLOR_ATOL)
        mask = tf.mover_mask.numpy()
        np.testing.assert_array_equal(mask, np.asarray(jf.mover_mask))
        assert 0 < mask.sum() < mask.size


@pytest.mark.parametrize("subscanline", [True, False])
def test_true_flow_matches_jax(pairs, subscanline):
    jp, tp, jintr, tintr = pairs
    ref = np.asarray(jax_true_flow(
        jp.frame1.rs_unproject, jp.frame2.poses_r, jp.frame2.poses_t, jintr,
        subscanline=subscanline))
    got = true_flow(tp.frame1.rs_unproject, tp.frame2.poses_r,
                    tp.frame2.poses_t, tintr,
                    subscanline=subscanline).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GEOMETRY_ATOL)
    assert np.abs(ref).max() > 1.0


def test_true_depth_matches_jax(pairs):
    jp, tp, _, _ = pairs
    ref = jdataset.true_depth_from_unprojection(
        np.asarray(jp.frame1.rs_unproject), np.asarray(jp.frame1.poses_r),
        np.asarray(jp.frame1.poses_t))
    got = tdataset.true_depth_from_unprojection(
        tp.frame1.rs_unproject, tp.frame1.poses_r, tp.frame1.poses_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GEOMETRY_ATOL)
    np.testing.assert_array_equal(got > 0, ref > 0)


PHOTOMETRIC_CASES = [
    dict(exposure=1.35, vignette=0.35, noise_sigma=0.005),
    dict(exposure=0.8, gamma_curve=1.4),
    dict(exposure=1.1, gamma_curve=0.7, vignette=0.2, noise_sigma=0.02),
    dict(blur=True),
    dict(motion_blur_px=3.0, motion_blur_dir=(-0.4, 1.0)),
    dict(jpeg_quality=30),
    # tests/test_real_ingestion.py's frame 2: every stage in one pass.
    dict(exposure=1.25, vignette=0.25, noise_sigma=0.004, motion_blur_px=3.0,
         demosaic=True, jpeg_quality=82),
]


@pytest.fixture(scope="module")
def photometric_refs():
    """The JAX package's apply_photometric of every case on one image
    (27x38: JPEG pads both axes) in float64, one jitted function, and its
    normal draws."""
    image = np.random.default_rng(2).uniform(0.0, 1.0, (27, 38, 3))
    key = jax.random.PRNGKey(1)
    refs = jax.jit(lambda img: [jsyn.apply_photometric(img, key, **opts)
                                for opts in PHOTOMETRIC_CASES])(
        jnp.asarray(image))
    noise = np.array(jax.random.normal(key, image.shape, jnp.float64))
    return image, noise, [np.asarray(r) for r in refs]


@pytest.mark.parametrize("opts", PHOTOMETRIC_CASES)
def test_apply_photometric_matches_jax(photometric_refs, opts):
    image, noise, refs = photometric_refs
    ref = refs[PHOTOMETRIC_CASES.index(opts)]
    got = tsyn.apply_photometric(torch.from_numpy(image),
                                 noise=torch.from_numpy(noise), **opts)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert float(np.abs(ref - image).max()) > 1e-3


def test_repetitive_scene_matches_jax():
    """repetitive_scene's periodic walls beside the noise-textured ground
    and roof, rendered at 40x64 in float64: colour within COLOR_ATOL."""
    scene = jsyn.repetitive_scene(dtype=jnp.float64)
    intr = tsyn.default_intrinsics(H, W)
    jp = jsyn.render_pair(scene, jsyn.default_intrinsics(H, W), H, W,
                          gamma=GAMMA, k=0.0, v=V, w=WV, dtype=jnp.float64)
    tscene = tsyn.repetitive_scene(torch.float64, "cpu")
    np.testing.assert_array_equal(tscene.periodic.numpy(),
                                  np.asarray(scene.periodic))
    tp = tsyn.render_pair(tscene, intr, H, W, gamma=GAMMA, k=0.0, v=V, w=WV,
                          dtype=torch.float64)
    for frame in ("frame1", "frame2"):
        np.testing.assert_allclose(
            getattr(tp, frame).rs_image.numpy(),
            np.asarray(getattr(jp, frame).rs_image), rtol=0, atol=COLOR_ATOL)
    # The periodic texture differs from the castle's noise texture.
    castle = tsyn.render_pair(tsyn.castle_scene(torch.float64, "cpu"), intr,
                              H, W, gamma=GAMMA, k=0.0, v=V, w=WV,
                              dtype=torch.float64)
    assert float(torch.abs(castle.frame1.rs_image
                           - tp.frame1.rs_image).max()) > 0.1


def test_gauss_inv_matches_jax():
    """Random 3x3 matrices, the renderer's near-identity rotations, and
    matrices whose first column needs each pivot row."""
    rng = np.random.default_rng(7)
    mats = [rng.normal(size=(64, 3, 3)),
            np.eye(3) + 0.01 * rng.normal(size=(16, 3, 3)),
            np.array([[[0.0, 1.0, 2.0], [3.0, 0.0, 1.0], [1.0, 4.0, 0.0]],
                      [[1e-9, 2.0, 1.0], [0.5, 1.0, 3.0], [4.0, 1.0, 1.0]]])]
    a = np.concatenate(mats)
    ref = np.asarray(jlinalg.gauss_inv(jnp.asarray(a)))
    got = tlinalg.gauss_inv(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.einsum("nij,njk->nik", a, got),
                               np.broadcast_to(np.eye(3), a.shape), atol=1e-9)


@pytest.mark.parametrize("k", [0.0, 0.7])
def test_beta2_matches_jax(k):
    rows = np.arange(1080, dtype=np.float64)
    ref = np.asarray(jrs.beta2(jnp.asarray(rows), 1080, GAMMA, k))
    got = trs.beta2(torch.from_numpy(rows), 1080, GAMMA, k).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("skip_first_row", [False, True])
def test_relocate_poses_matches_jax(skip_first_row):
    rng = np.random.default_rng(9)
    r = np.eye(3) + 0.05 * rng.normal(size=(12, 3, 3))
    t = rng.normal(size=(12, 3))
    jr, jt = jrs.relocate_poses(jnp.asarray(r), jnp.asarray(t),
                                skip_first_row=skip_first_row)
    tr, tt = trs.relocate_poses(torch.from_numpy(r), torch.from_numpy(t),
                                skip_first_row=skip_first_row)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-12)
