"""The acceleration model end to end: rs_sfm_tpu_torch's
`estimate_with_feedback(use_acceleration=True)` against the JAX package's on
a 48x48 castle rendered with k 0.8, and the rest of the slice.

One JAX run, computed once: the castle's true flow (the port's renderer,
float64, held to the JAX one in tests/test_torch_synthetic.py) through the
JAX `estimate_with_feedback` with the "xla" engines, 48 RANSAC draws, 4
diversity starts winnowed after 8 of 20 iterations, the k-scan, the Huber
loss, the 2 px depth export and one feedback pass; the port gets the same
flow and JAX's draws.

Tolerances:
- against JAX, float64: v as a direction (2.3e-9) and a scale, k and the
  depths (4.3e-8 relative: PARITY.md's k bound; ρ and k trade along the
  objective's flat valley), w 2.3e-10; the inlier count and mask equal;
  the refinement cost 1e-9 relative.
- against the truth: |k - 0.8| < 0.2 and v within 0.05 rad
  (tests/test_synthetic_consistency.py:111-123), w within 1e-3.
- the fused engines (the kernels' plain twins) against the "xla" engines,
  both on the float32 flow and the same draws: v direction 1e-3, w 1e-5,
  k 1e-3, inlier counts within 0.5 % (float32 sums in another order).
- `projection_roundtrip_error` against JAX: 1e-9 relative.
- the sharded estimation with the acceleration model or the prescore over
  a group of one rank: bit-identical to the unsharded one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu.config import PipelineConfig as JaxConfig
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.geom.diagnostics import projection_roundtrip_error as j_rt
from rs_sfm_tpu.geom.rspose import scanline_poses as j_poses
from rs_sfm_tpu.solver.pipeline import estimate_with_feedback as j_estimate
from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs as j_prepare
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.data.synthetic import (castle_scene, default_intrinsics,
                                             render_pair)
from rs_sfm_tpu_torch.eval.gate import V_TRUE, W_TRUE
from rs_sfm_tpu_torch.flow.true_flow import true_flow
from rs_sfm_tpu_torch.geom.diagnostics import projection_roundtrip_error
from rs_sfm_tpu_torch.parallel.api import estimate_sharded
from rs_sfm_tpu_torch.solver import pipeline as tpipeline

import torch_parallel_ranks as ranks

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

V_TOL, W_TOL, K_RTOL, RTOL = 2.3e-9, 2.3e-10, 4.3e-8, 1e-9
SIZE, GAMMA, K_TRUE = 48, 0.9, 0.8
CFG = PipelineConfig(ransac_trials=48, ransac_tol=0.02, use_acceleration=True,
                     refine_iterations=20, refine_starts=4,
                     refine_winnow_iters=8, refine_rel_tol=0.0,
                     depth_residual_px=2.0, refine_loss_delta_px=3.0,
                     feedback_passes=1, feedback_refine_iterations=8)



@pytest.fixture(scope="module")
def castle():
    """The castle's true flow (numpy float64), intrinsics, JAX's draws and
    JAX's estimate."""
    intr = default_intrinsics(SIZE, SIZE)
    pair = render_pair(castle_scene(torch.float64, "cpu"), intr, SIZE, SIZE,
                       gamma=GAMMA, k=K_TRUE, v=V_TRUE, w=W_TRUE,
                       dtype=torch.float64)
    flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr).numpy()
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    jintr = JaxIntrinsics(**dataclasses.asdict(intr))
    key = jax.random.PRNGKey(1)
    want = run_jitted(lambda f: j_estimate(f, jintr, GAMMA, jcfg, key),
                       jnp.asarray(flow))
    valid = j_prepare(jnp.asarray(flow), jintr, GAMMA, jcfg)[4]
    draws = np.array(jransac.sample_valid_indices(key, valid,
                                                  CFG.ransac_trials))
    return dict(flow=flow, intr=intr, draws=draws,
                want=jax.tree_util.tree_map(np.asarray, want))


@pytest.fixture(scope="module")
def port(castle):
    """The port's estimate on the same flow and draws (float64)."""
    return _port(castle, castle["flow"])


def _port(castle, flow, cfg=CFG):
    return tpipeline.estimate_with_feedback(
        torch.from_numpy(flow), castle["intr"], GAMMA, cfg,
        sample_indices=castle["draws"])


def _direction(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_acceleration_estimate_matches_jax(castle, port):
    got, want = port, castle["want"]
    np.testing.assert_allclose(np.linalg.norm(got.v.numpy()),
                               np.linalg.norm(want.v), rtol=K_RTOL)
    np.testing.assert_allclose(_direction(got.v), _direction(want.v), rtol=0,
                               atol=V_TOL)
    np.testing.assert_allclose(got.w.numpy(), want.w, rtol=0, atol=W_TOL)
    np.testing.assert_allclose(float(got.k), float(want.k), rtol=K_RTOL)
    np.testing.assert_allclose(float(got.ransac_k), float(want.ransac_k),
                               rtol=K_RTOL)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), want.inlier_mask)
    np.testing.assert_allclose(float(got.refine_cost),
                               float(want.refine_cost), rtol=RTOL)
    scale_g = np.linalg.norm(got.v.numpy())
    scale_w = np.linalg.norm(want.v)
    np.testing.assert_allclose(got.depth_map.numpy() / scale_g,
                               want.depth_map / scale_w, rtol=K_RTOL, atol=0)


def test_acceleration_recovers_the_castle_motion(port):
    got = port
    assert abs(float(got.k) - K_TRUE) < 0.2, float(got.k)
    cos = float(_direction(got.v) @ _direction(V_TRUE))
    assert np.arccos(min(1.0, cos)) < 0.05
    np.testing.assert_allclose(got.w.numpy(), W_TRUE, rtol=0, atol=1e-3)
    assert int(got.num_inliers) > 0.8 * SIZE * SIZE


def test_fused_engines_match_xla_engines(castle):
    """The kernels' engines (B1, B3, B2 k free: their plain twins here)
    against the "xla" engines on the float32 flow, the same draws."""
    flow32 = castle["flow"].astype(np.float32)
    xla = _port(castle, flow32)
    fused = _port(castle, flow32, dataclasses.replace(
        CFG, refine_engine="pallas", ransac_engine="pallas"))
    assert fused.v.dtype == torch.float32
    np.testing.assert_allclose(_direction(fused.v), _direction(xla.v),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(fused.w.numpy(), xla.w.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(fused.k), float(xla.k), rtol=0,
                               atol=1e-3)
    assert abs(int(fused.num_inliers) - int(xla.num_inliers)) <= 0.005 * (
        int(xla.num_inliers))
    assert abs(float(fused.k) - K_TRUE) < 0.2


def test_projection_roundtrip_matches_jax():
    intr = default_intrinsics(32, 32)
    r, t = j_poses(jnp.asarray([0.1, -0.05, 0.08]),
                   jnp.asarray([0.003, -0.002, 0.004]), 0.8, 32, 0.9,
                   dtype=jnp.float64)
    jintr = JaxIntrinsics(**dataclasses.asdict(intr))
    want = float(run_jitted(lambda r, t: j_rt(32, 32, jintr, r, t), r, t))
    got = float(projection_roundtrip_error(
        32, 32, intr, torch.from_numpy(np.array(r)),
        torch.from_numpy(np.array(t))))
    assert 0.0 < want < 5e-3
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("change", [dict(use_acceleration=True),
                                    dict(ransac_prescore_subsample=64)])
def test_sharded_estimation_raises_for_a8_options(castle, change):
    """The sharded k-scan and prescore (ROADMAP A8, which both sharded
    entry points refused before they were ported) run: over a group of
    one rank, `estimate_sharded` equals the unsharded estimation on the
    same draws bit for bit (a pool of every pixel indexes the image).
    tests/test_torch_parallel.py holds them on 2 ranks."""
    cfg = dataclasses.replace(CFG, feedback_passes=0,
                              refine_engine="pallas", **change)
    flow = torch.from_numpy(castle["flow"])
    want = tpipeline.estimate_from_flow(flow, castle["intr"], GAMMA, cfg,
                                        sample_indices=castle["draws"])
    with ranks.solo_group() as group:
        got = estimate_sharded(group, castle["intr"], GAMMA, cfg,
                               pool_per_shard=SIZE * SIZE)(
            flow, sample_indices=castle["draws"])
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert abs(float(got.k) - K_TRUE) < 0.2
