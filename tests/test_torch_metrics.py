"""The error metrics: rs_sfm_tpu_torch vs the JAX package on the CPU in
float64 (1e-12 absolute, 1e-12 relative for the summed ones), on the same
numpy inputs; and the port's production estimation configuration against
the one the JAX package's full-HD gate uses."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rs_sfm_tpu.eval import metrics as jmetrics
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu_torch import config as tconfig
from rs_sfm_tpu_torch.eval import metrics as tmetrics
from rs_sfm_tpu_torch.geom.camera import Intrinsics

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

H, W = 30, 44
INTR = Intrinsics(fx=50.0, fy=49.0, cx=21.5, cy=14.5)
JINTR = JaxIntrinsics(**dataclasses.asdict(INTR))


def _close(got, ref, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=1e-12)


def test_rotation_and_translation_error_match_jax():
    rng = np.random.default_rng(4)
    w_est = rng.normal(scale=0.01, size=(50, 3))
    w_true = rng.normal(scale=0.01, size=3)
    v_est = rng.normal(size=(50, 3))
    v_est[0] = 0.0  # a zero vector: the guarded division
    v_est[1] = -2.0 * np.array([0.35, -0.15, 0.25])  # antiparallel: pi
    v_true = np.array([0.35, -0.15, 0.25])
    _close(tmetrics.rotation_error(torch.from_numpy(w_est), w_true),
           jmetrics.rotation_error(jnp.asarray(w_est), jnp.asarray(w_true)))
    got = tmetrics.translation_error(torch.from_numpy(v_est), v_true)
    _close(got, jmetrics.translation_error(jnp.asarray(v_est),
                                           jnp.asarray(v_true)))
    assert abs(float(got[1]) - np.pi) < 1e-7


def _reprojection_inputs(seed):
    """Estimated points = the true points of a blocky depth under
    near-identity scanline poses, scaled by 0.7, with noise, a few
    outliers and zeros where not valid."""
    rng = np.random.default_rng(seed)
    depth = np.kron(rng.uniform(3.0, 9.0, (H // 5 + 1, W // 4 + 1)),
                    np.ones((5, 4)))[:H, :W]
    depth[:2, :6] = 0.0  # void
    r = np.eye(3) + 0.003 * rng.normal(size=(H, 3, 3))
    t = 0.01 * np.arange(H)[:, None] * np.array([0.3, -0.1, 0.2]) + 0.5
    _, _, true_3d = jmetrics.mean_reprojection_error(
        jnp.zeros((H, W, 3)), jnp.zeros((H, W), bool), jnp.asarray(depth),
        jnp.asarray(r), jnp.asarray(t), JINTR)
    est = 0.7 * np.asarray(true_3d) + rng.normal(scale=0.02, size=(H, W, 3))
    est[rng.uniform(size=(H, W)) < 0.03] *= 40.0  # beyond the ratio cap
    valid = (rng.uniform(size=(H, W)) > 0.1) & (depth > 0)
    est[~valid] = 0.0
    return est, valid, depth, r, t


@pytest.mark.parametrize("scale_mode", ["ratio-mean", "ls"])
@pytest.mark.parametrize("skip_first_row", [False, True])
def test_mean_reprojection_error_matches_jax(scale_mode, skip_first_row):
    est, valid, depth, r, t = _reprojection_inputs(8)
    kw = dict(scale_mode=scale_mode, relocate_skip_first_row=skip_first_row)
    ref = jmetrics.mean_reprojection_error(
        jnp.asarray(est), jnp.asarray(valid), jnp.asarray(depth),
        jnp.asarray(r), jnp.asarray(t), JINTR, **kw)
    got = tmetrics.mean_reprojection_error(
        torch.from_numpy(est), torch.from_numpy(valid),
        torch.from_numpy(depth), torch.from_numpy(r), torch.from_numpy(t),
        INTR, **kw)
    for g, j in zip(got, ref):
        _close(g.numpy(), j)
    assert 0.0 < float(got[0]) < 1.0


@pytest.mark.parametrize("scale_mode", ["ls", "median"])
def test_depth_rmse_matches_jax(scale_mode):
    rng = np.random.default_rng(6)
    true = rng.uniform(2.0, 9.0, (H, W))
    true[0, :5] = 0.0
    est = true / 1.8 * (1.0 + rng.normal(scale=0.05, size=(H, W)))
    est[3, :7] = 0.0
    est[4, 0] = np.inf
    mask = rng.uniform(size=(H, W)) > 0.2
    for m in (mask, mask & (np.arange(W) < 11)):  # an even and an odd count
        ref = jmetrics.depth_rmse(jnp.asarray(est), jnp.asarray(true),
                                  jnp.asarray(m), scale_mode=scale_mode)
        got = tmetrics.depth_rmse(torch.from_numpy(est),
                                  torch.from_numpy(true),
                                  torch.from_numpy(m), scale_mode=scale_mode)
        for g, j in zip(got, ref):
            _close(g.numpy(), j)


def test_e2e_config_is_the_fullhd_gates_estimation():
    """config.E2E_CONFIG, which chip_smoke.py's castle gate runs, equals
    tests/test_fullhd_flow.py's EST_CFG in every field but the kernel
    engines and RANSAC's chunk, which change no result."""
    est_cfg = importlib.import_module("test_fullhd_flow").EST_CFG
    differ = {f.name for f in dataclasses.fields(tconfig.PipelineConfig)
              if getattr(tconfig.E2E_CONFIG, f.name)
              != getattr(est_cfg, f.name)}
    assert differ == {"refine_engine", "ransac_engine", "ransac_chunk"}
