"""The plain-tensor Schur-LM refinement (refine_engine="xla") and the
estimation on it: rs_sfm_tpu_torch vs the JAX package, float64 on the CPU.

(a) `solver.refine.refine` against the JAX `refine` on 512 pixels of a
    rolling-shutter flow with noise and a block of outliers: L2 and Huber,
    k free and frozen, rel_tol 0 (a fixed trip count) and 1e-8 (early
    stop), and J = 4 starts batched against the JAX `jax.vmap` of `refine`.
(b) `estimate_from_flow` / `estimate_with_feedback` with the "xla" engines
    against JAX's on a 48x64 GT flow, the JAX RANSAC draws injected: one
    start, 4 starts winnowed after 8 iterations, and 2 feedback passes.

Bounds: PARITY.md's (v 2.3e-9 and w 2.3e-10 absolute, k 4.3e-8 relative);
the cost 1e-9 relative; inlier counts equal.  The inverse depths are held
to k's bound, 4.3e-8 relative: ρ trades against k and the (v, ρ) scale
along the objective's flat valley, where the two packages' summation
orders (one Gram product here, XLA's einsum there) leave ρ up to 1e-8
apart while the costs agree to 1e-15.
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
from rs_sfm_tpu.solver.pipeline import estimate_with_feedback as j_estimate
from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs as j_prepare
from rs_sfm_tpu.solver.refine import refine as j_refine
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver import pipeline as tpipeline
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.refine import refine

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

N = 512
V_TOL, W_TOL, K_RTOL, RTOL = 2.3e-9, 2.3e-10, 4.3e-8, 1e-9


def _problem(seed=0):
    """N pixels of RS flow (float64) from a model with k = 0.3, with
    noise and 16 outliers, and a perturbed start."""
    rng = np.random.default_rng(seed)
    f, h, gamma = 500.0, 600, 0.9
    px = rng.uniform(0, 599, size=(N, 2))
    coords = torch.from_numpy((px - 300.0) / f)
    v = torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64)
    w = torch.tensor([0.004, -0.002, 0.008], dtype=torch.float64)
    rho = torch.from_numpy(1.0 / rng.uniform(3.0, 9.0, size=N))
    dy = torch.from_numpy(rng.normal(scale=2.0, size=N))
    alpha = get_alpha(dy, h, gamma)
    alpha_k = get_alpha_k(torch.from_numpy(px[:, 1]), dy, h, gamma)
    flow = predict_flow(coords, rho, v, w, 0.3, alpha, alpha_k)
    flow = flow + torch.from_numpy(rng.normal(scale=2e-4, size=(N, 2)))
    flow[:16] += torch.tensor([3e-3, -2e-3], dtype=torch.float64)
    mask = torch.from_numpy(rng.uniform(size=N) > 0.1)
    return dict(coords=coords, flow=flow, alpha=alpha, alpha_k=alpha_k,
                mask=mask, v0=v * 1.2 + 0.002, w0=w * 0.8,
                k0=torch.tensor(0.1, dtype=torch.float64),
                rho0=rho * 0.9)


def _jax(p):
    return {k: jnp.asarray(t.numpy()) for k, t in p.items()}


def _close(got, want):
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0,
                               atol=V_TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=W_TOL)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                               rtol=K_RTOL, atol=1e-300)
    for name, rtol in (("cost", RTOL), ("initial_cost", RTOL),
                       ("inv_depth", K_RTOL)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("loss_delta,optimize_k,rel_tol", [
    (0.0, True, 0.0), (1e-3, False, 1e-8), (0.0, False, 1e-8),
    (1e-3, True, 0.0)])
def test_refine_matches_jax(loss_delta, optimize_k, rel_tol):
    p = _problem()
    kw = dict(optimize_k=optimize_k, iterations=20, rel_tol=rel_tol,
              loss_delta=loss_delta)
    got = refine(*p.values(), **kw)
    want = j_refine(*_jax(p).values(), **kw)
    _close(got, want)
    assert float(got.cost) < float(got.initial_cost)


def test_refine_batched_starts_match_jax_vmap():
    """J = 4 starts with their own masks: the batched refine equals JAX's
    vmap of the single-start refine, start by start (rel_tol > 0, so the
    starts stop at different iterations and the stopped ones stay put)."""
    p = _problem(1)
    rng = np.random.default_rng(5)
    scale = torch.from_numpy(rng.uniform(0.7, 1.4, size=(4, 1)))
    starts = dict(
        mask=torch.from_numpy(rng.uniform(size=(4, N)) > 0.2),
        v0=p["v0"][None] * scale, w0=p["w0"][None] / scale,
        k0=torch.tensor([0.1, 0.3, 0.0, 0.5], dtype=torch.float64),
        rho0=p["rho0"][None] * torch.from_numpy(rng.uniform(0.8, 1.2,
                                                            (4, 1))))
    kw = dict(optimize_k=True, iterations=20, rel_tol=1e-8, loss_delta=1e-3)
    shared = [p[k] for k in ("coords", "flow", "alpha", "alpha_k")]
    got = refine(*shared, *starts.values(), **kw)
    js = [jnp.asarray(t.numpy()) for t in shared]
    want = jax.vmap(lambda m, a, b, c, d: j_refine(*js, m, a, b, c, d, **kw))(
        *(jnp.asarray(t.numpy()) for t in starts.values()))
    assert got.v.shape == (4, 3) and got.inv_depth.shape == (4, N)
    _close(got, want)


H, W, F, GAMMA = 48, 64, 60.0, 0.9
INTR = Intrinsics(fx=F, fy=F, cx=W / 2.0, cy=H / 2.0)
BASE = dict(ransac_trials=64, refine_iterations=20)
ROBUST = dict(BASE, ransac_tol=0.02, refine_starts=4, refine_winnow_iters=8,
              refine_rel_tol=0.0, depth_residual_px=2.0,
              refine_loss_delta_px=3.0)
CASES = {"one_start": PipelineConfig(**BASE),
         "winnow": PipelineConfig(**ROBUST),
         "feedback": PipelineConfig(**ROBUST, feedback_passes=2,
                                    feedback_refine_iterations=8)}


def _gt_flow(seed=3):
    """(H, W, 2) float64 RS flow of a random-depth scene: the flow's own y
    component sets each pixel's readout time (fixed-point iteration)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(np.stack([(xs - W / 2.0) / F,
                                        (ys - H / 2.0) / F], -1).reshape(-1, 2))
    rho = torch.from_numpy(1.0 / rng.uniform(4.0, 9.0, size=H * W))
    v = torch.tensor([0.2, -0.1, 0.15], dtype=torch.float64)
    wr = torch.tensor([0.003, -0.002, 0.004], dtype=torch.float64)
    ys = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((H * W, 2), dtype=torch.float64)
    for _ in range(6):
        a = get_alpha(fl[:, 1] * F, H, GAMMA)
        ak = get_alpha_k(ys, fl[:, 1] * F, H, GAMMA)
        fl = predict_flow(coords, rho, v, wr, 0.0, a, ak)
    flow = (fl * F).reshape(H, W, 2).numpy()
    # Pixel noise and a corrupted band, so that the winnow and the feedback
    # passes have outliers to drop.
    flow = flow + rng.normal(scale=0.02, size=flow.shape)
    flow[10:16, 20:40] += np.array([1.5, -1.0])
    return flow


@pytest.fixture(scope="module")
def jax_estimates():
    """The JAX estimation of every case on one flow, in one compiled
    function, in which the winnow case is the feedback case's first
    pass."""
    jintr = JaxIntrinsics(**dataclasses.asdict(INTR))
    key = jax.random.PRNGKey(2)

    def all_cases(flow):
        return {name: j_estimate(flow, jintr, GAMMA,
                                 JaxConfig(**dataclasses.asdict(cfg)), key)
                for name, cfg in CASES.items()}

    return key, run_jitted(all_cases, jnp.asarray(_gt_flow()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimation_xla_engine_matches_jax(name, jax_estimates):
    cfg = CASES[name]
    assert cfg.refine_engine == "xla" and cfg.ransac_engine == "xla"
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jintr = JaxIntrinsics(**dataclasses.asdict(INTR))
    flow = _gt_flow()
    key, wants = jax_estimates
    want = wants[name]
    valid = j_prepare(jnp.asarray(flow), jintr, GAMMA, jcfg)[4]
    idx = np.array(jransac.sample_valid_indices(key, valid,
                                                cfg.ransac_trials))
    got = tpipeline.estimate_with_feedback(torch.from_numpy(flow), INTR,
                                           GAMMA, cfg, sample_indices=idx)
    # v as a direction and a scale (the LM moves along the (v, ρ) scale
    # gauge), the depths divided by that scale.
    scale_g = np.linalg.norm(got.v.numpy(), axis=-1)
    scale_w = np.linalg.norm(np.asarray(want.v), axis=-1)
    np.testing.assert_allclose(scale_g, scale_w, rtol=K_RTOL)
    np.testing.assert_allclose(got.v.numpy() / scale_g,
                               np.asarray(want.v) / scale_w, rtol=0,
                               atol=V_TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=W_TOL)
    assert float(got.k) == float(want.k) == 0.0
    assert int(got.num_inliers) == int(want.num_inliers)
    assert torch.equal(got.inlier_mask, torch.from_numpy(
        np.array(want.inlier_mask)))
    np.testing.assert_allclose(float(got.refine_cost),
                               float(want.refine_cost), rtol=RTOL)
    np.testing.assert_allclose(got.depth_map.numpy() / scale_g,
                               np.asarray(want.depth_map) / scale_w,
                               rtol=K_RTOL, atol=0)
    top_g = got.top_v.numpy()
    top_w = np.asarray(want.top_v)
    np.testing.assert_allclose(
        top_g / np.linalg.norm(top_g, axis=-1, keepdims=True),
        top_w / np.linalg.norm(top_w, axis=-1, keepdims=True), rtol=0,
        atol=V_TOL)
    assert int(got.num_inliers) > 0.8 * H * W


def test_sharded_xla_refinement_raises():
    """The sharded "xla" refinement (ROADMAP A8, refused before it was
    ported) runs: over a group of one rank, `estimate_sharded` with the
    "xla" engines equals the unsharded estimation on the same draws bit
    for bit (a pool of every pixel indexes the image); the single start
    and the winnowed starts.  tests/test_torch_parallel.py holds it on 2
    ranks."""
    from rs_sfm_tpu_torch.parallel.api import estimate_sharded
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    import torch_parallel_ranks as ranks

    flow = torch.from_numpy(_gt_flow())
    with ranks.solo_group() as group:
        for name in ("one_start", "winnow"):
            cfg = CASES[name]
            valid = tpipeline.prepare_flow_inputs(flow, INTR, GAMMA, cfg)[4]
            draws = sample_valid_indices(torch.Generator().manual_seed(0),
                                         valid, cfg.ransac_trials)
            want = tpipeline.estimate_from_flow(flow, INTR, GAMMA, cfg,
                                                sample_indices=draws)
            got = estimate_sharded(group, INTR, GAMMA, cfg,
                                   pool_per_shard=H * W)(
                flow, sample_indices=draws)
            for f in want._fields:
                assert torch.equal(getattr(got, f), getattr(want, f)), (
                    name, f)
