"""The evaluation layer of the port against the JAX package: the mesh-grade
castle and the stress scene, the evaluateVelocities harness (batched and
sequential), the artifact images, the flow colouring and the flow
self-check.

  * castle_mesh_scene and stress_scene: every scene array equal to JAX's
    in float64 within 1e-12, and a 24x32 render of the stress scene (its
    movers) with equal mover masks and geometry within 1e-9.
  * evaluate_velocities_batched and evaluate_velocities on a 32x48 castle
    pair in float64, N = 2, both handed the JAX package's RANSAC draws of
    `jax.random.split(key, 2)`: v within 1e-9, w within 1e-12, err3d,
    its LS form and the depth RMSE within 1e-9 relative, inlier counts
    equal.
  * The artifact images, flow_to_color and flow_arrows: bit-exact uint8.
  * flow_consistency_error within 1e-6.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rs_sfm_tpu.config import PipelineConfig as JaxConfig
from rs_sfm_tpu.data import synthetic as jsyn
from rs_sfm_tpu.data.dataset import FrameData as JFrame
from rs_sfm_tpu.data.dataset import PairData as JPair
from rs_sfm_tpu.eval import artifacts as jart
from rs_sfm_tpu.eval import harness as jh
from rs_sfm_tpu.flow.check import flow_consistency_error as j_consistency
from rs_sfm_tpu.flow.viz import flow_arrows as j_arrows
from rs_sfm_tpu.flow.viz import flow_to_color as j_color
from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs as j_prepare
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.data import synthetic as tsyn
from rs_sfm_tpu_torch.data.dataset import FrameData, PairData
from rs_sfm_tpu_torch.eval import artifacts as tart
from rs_sfm_tpu_torch.eval import harness as th
from rs_sfm_tpu_torch.flow.check import flow_consistency_error
from rs_sfm_tpu_torch.flow.viz import flow_arrows, flow_to_color
from rs_sfm_tpu_torch.geom.camera import Intrinsics

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

H, W, N = 32, 48, 2
V = np.array([0.12, -0.05, 0.08])
WR = np.array([0.003, -0.002, 0.004])


@pytest.mark.parametrize("name", ["mesh", "stress", "stress_no_slab"])
def test_scenes_match_jax(name):
    if name == "mesh":
        want = jsyn.castle_mesh_scene(dtype=jnp.float64, seed=3)
        got = tsyn.castle_mesh_scene(torch.float64, "cpu", seed=3)
    else:
        kw = dict(mover_speed=0.6, foreground=name == "stress")
        want = jsyn.stress_scene(dtype=jnp.float64, **kw)
        got = tsyn.stress_scene(torch.float64, "cpu", **kw)
    for field in ("origins", "edge1", "edge2", "base_color", "velocity"):
        a, b = getattr(want, field), getattr(got, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-12, err_msg=field)
    assert got.periodic is None and want.periodic is None


def test_stress_render_matches_jax():
    h, w = 24, 32
    jintr = jsyn.default_intrinsics(h, w)
    want = jsyn.render_pair(jsyn.stress_scene(dtype=jnp.float64), jintr, h,
                            w, gamma=0.9, k=0.0, v=V * 3, w=WR,
                            dtype=jnp.float64)
    got = tsyn.render_pair(tsyn.stress_scene(torch.float64, "cpu"),
                           tsyn.default_intrinsics(h, w), h, w, gamma=0.9,
                           k=0.0, v=V * 3, w=WR, dtype=torch.float64)
    for fj, ft in ((want.frame1, got.frame1), (want.frame2, got.frame2)):
        assert torch.equal(ft.mover_mask,
                           torch.from_numpy(np.array(fj.mover_mask)))
        for field in ("rs_depth", "rs_unproject", "gs_depth"):
            np.testing.assert_allclose(getattr(ft, field).numpy(),
                                       np.asarray(getattr(fj, field)),
                                       rtol=0, atol=1e-9, err_msg=field)
    assert bool(got.frame1.mover_mask.any())


def _frames(fr, cls):
    return cls(rs_image=np.asarray(fr.rs_image),
               gs_image=np.asarray(fr.gs_image), depth_image=None,
               poses_r=np.asarray(fr.poses_r), poses_t=np.asarray(fr.poses_t),
               rs_unproject=np.asarray(fr.rs_unproject),
               gs_unproject=np.asarray(fr.gs_unproject))


@pytest.fixture(scope="module")
def pairs():
    """The 32x48 castle pair (float64) as the JAX and the port PairData."""
    intr = jsyn.default_intrinsics(H, W)
    p = jsyn.render_pair(jsyn.castle_scene(dtype=jnp.float64), intr, H, W,
                         gamma=0.9, k=0.0, v=V, w=WR, dtype=jnp.float64)
    gt = dict(gamma=0.9, k=0.0, v=np.asarray(p.v), w=np.asarray(p.w))
    jp = JPair(_frames(p.frame1, JFrame), _frames(p.frame2, JFrame), intr,
               **gt)
    tp = PairData(_frames(p.frame1, FrameData), _frames(p.frame2, FrameData),
                  Intrinsics(**dataclasses.asdict(intr)), **gt)
    return jp, tp


CFG = PipelineConfig(ransac_trials=32, ransac_tol=0.01, refine_iterations=20)


def _jax_draws(jp, key):
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    flow = jh.compute_flow(jp, False, dtype=jnp.float64)
    valid = j_prepare(flow, jp.intrinsics, 0.9, jcfg)[4]
    return jcfg, np.stack([
        np.array(jransac.sample_valid_indices(k, valid, CFG.ransac_trials))
        for k in jax.random.split(key, N)])


@pytest.mark.parametrize("form", ["batched", "sequential"])
def test_harness_matches_jax(pairs, form, tmp_path):
    jp, tp = pairs
    key = jax.random.PRNGKey(0)
    jcfg, idx = _jax_draws(jp, key)
    kw = dict(num_evaluations=N, dtype=torch.float64, sample_indices=idx,
              device="cpu")
    if form == "batched":
        want = jh.evaluate_velocities_batched(jp, jcfg, num_evaluations=N,
                                              key=key, dtype=jnp.float64)
        got = th.evaluate_velocities_batched(tp, CFG, **kw)
        rel = ("error_reproject_vec", "error_reproject_ls_vec",
               "depth_rmse_vec")
    else:
        want = jh.evaluate_velocities(jp, jcfg, num_evaluations=N, key=key,
                                      dtype=jnp.float64)
        got = th.evaluate_velocities(tp, CFG, image_path=str(tmp_path), **kw)
        rel = ("error_reproject_vec",)
        for run in range(N):
            assert (tmp_path / f"depth_{run}.png").exists()
            assert (tmp_path / f"point_cloud_{run}.ply").exists()
    np.testing.assert_allclose(got.v, want.v, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.w, want.w, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.k, want.k)
    np.testing.assert_allclose(got.error_v_vec, want.error_v_vec, rtol=0,
                               atol=1e-9)
    for name in rel:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.num_inliers, want.num_inliers)
    # tests/test_harness.py's gates.
    assert got.error_w < 1e-3 and got.error_v < 0.02
    assert got.error_reproject < 0.2


def test_artifact_images_match_jax(pairs, tmp_path):
    jp, tp = pairs
    rng = np.random.default_rng(4)
    depth = np.where(rng.uniform(size=(H, W)) > 0.3,
                     rng.uniform(2.0, 9.0, (H, W)), 0.0)
    est = rng.normal(size=(H, W, 3))
    true = est + rng.normal(scale=0.5, size=(H, W, 3))
    valid = rng.uniform(size=(H, W)) > 0.2
    bp = rng.uniform(0, 1, (H, W, 3))
    flow = rng.normal(scale=3.0, size=(H, W, 2))
    pairs_of = [
        (jart.depth_image(depth), tart.depth_image(torch.from_numpy(depth))),
        (jart.error_image(est, true, valid),
         tart.error_image(torch.from_numpy(est), true, valid)),
        (j_color(flow), flow_to_color(torch.from_numpy(flow))),
        (j_arrows(jp.frame1.rs_image, flow, step_x=8, step_y=8),
         flow_arrows(tp.frame1.rs_image, flow, step_x=8, step_y=8)),
    ]
    jset = jart.synthetic_eval_images(jp.frame1.rs_image, jp.frame1.gs_image,
                                      bp)
    tset = tart.synthetic_eval_images(tp.frame1.rs_image, tp.frame1.gs_image,
                                      torch.from_numpy(bp))
    assert sorted(jset) == sorted(tset)
    pairs_of += [(jset[k], tset[k]) for k in jset]
    for want, got in pairs_of:
        assert got.dtype == np.uint8 == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tart.depth_image(np.zeros((4, 4))).max() == 0


def test_flow_consistency_matches_jax(pairs):
    jp, _ = pairs
    i1 = np.asarray(jp.frame1.rs_image, np.float32)
    i2 = np.asarray(jp.frame2.rs_image, np.float32)
    flow = np.asarray(jh.compute_flow(jp, False, dtype=jnp.float32))
    mask = np.random.default_rng(2).uniform(size=(H, W)) > 0.5
    for m in (None, mask):
        want = float(j_consistency(jnp.asarray(i1), jnp.asarray(i2),
                                   jnp.asarray(flow),
                                   None if m is None else jnp.asarray(m)))
        got = float(flow_consistency_error(
            torch.from_numpy(i1), torch.from_numpy(i2),
            torch.from_numpy(flow), None if m is None
            else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6
    grey = float(flow_consistency_error(torch.from_numpy(i1[..., 0]),
                                        torch.from_numpy(i2[..., 0]),
                                        torch.from_numpy(flow)))
    assert 0.0 < grey < float(flow_consistency_error(
        torch.from_numpy(i1[..., 0]), torch.from_numpy(i2[..., 0]),
        torch.zeros((H, W, 2))))

