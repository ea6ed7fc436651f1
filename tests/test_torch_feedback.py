"""The model-feedback passes: rs_sfm_tpu_torch vs the JAX package on the
CPU, on a 48x64 rolling-shutter flow with blocky depth, a band of wrong
flow (an occlusion smear) and an untrusted block.

  * `model_feedback` on the same first-pass estimate: the extended masks
    equal (0.1 % of pixels allowed for a threshold test that flips on
    float32 rounding), the model flow within 1e-4 px;
  * `estimate_with_feedback` with the e2e configuration (bench.py:185-194:
    4 starts winnowed at 8, 20 Huber-LM iterations, 2 warm-start feedback
    passes of 8 iterations), the port handed the JAX package's RANSAC
    draws: v as a direction within 2e-3, w within 2e-5, inlier counts and
    the final trusted masks within 0.5 % of N.  Pass 1 agrees to about 1e-5
    (tests/test_torch_pipeline.py); each warm-start refinement restarts on
    a changed pixel set from a model that differs at float32 rounding, and
    on this small, narrow-field problem the direction of v is the weakly
    determined part of the motion (measured 6e-4 apart, w 6e-6);
  * `estimate_with_feedback` with feedback_mode="full" (one feedback pass
    re-running RANSAC, the 4-start schedule and its winnow on the cleaned
    mask) against the JAX package's on its "xla" engines, each pass handed
    the JAX draws on that pass's trusted mask (pass p of the JAX package
    draws with fold_in(key, 101 + p)): the port's "xla" and fused engines
    within the tolerances above.
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
from rs_sfm_tpu.flow import feedback as jfeedback
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.ops.pallas import refine_kernels as jrk
from rs_sfm_tpu.solver import pipeline as jpipeline
from rs_sfm_tpu_torch import config as tconfig
from rs_sfm_tpu_torch.flow import feedback as tfeedback
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.ops.kernels import refine_kernels as trk
from rs_sfm_tpu_torch.solver import pipeline as tpipeline
from rs_sfm_tpu_torch.solver import refine_fused as tref
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

H, W, F, GAMMA = 48, 64, 55.0, 0.9
INTR = Intrinsics(fx=F, fy=F, cx=W / 2.0, cy=H / 2.0)
JINTR = JaxIntrinsics(**dataclasses.asdict(INTR))
V_TRUE = (0.03, -0.01, 0.02)
W_TRUE = (0.002, -0.001, 0.003)


def _rs_flow(seed=5):
    """(flow (H, W, 2) float32, trusted mask (H, W) bool): the rolling-
    shutter flow of a scene of 8x8-pixel depth blocks (fixed-point
    iteration on the flow's own y component), 0.05 px noise, a band of
    columns whose flow is off by (3, -1.5) px, and an untrusted block."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(np.stack([(xs - W / 2) / F, (ys - H / 2) / F],
                                       -1).reshape(-1, 2))
    depth = np.kron(rng.uniform(4.0, 8.0, (H // 8 + 1, W // 8 + 1)),
                    np.ones((8, 8)))[:H, :W]
    rho = torch.from_numpy(1.0 / depth.reshape(-1))
    v = torch.tensor(V_TRUE, dtype=torch.float64)
    w = torch.tensor(W_TRUE, dtype=torch.float64)
    ysf = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((H * W, 2), dtype=torch.float64)
    for _ in range(6):
        fl = predict_flow(coords, rho, v, w, 0.0,
                          get_alpha(fl[:, 1] * F, H, GAMMA),
                          get_alpha_k(ysf, fl[:, 1] * F, H, GAMMA))
    flow = (fl * F).reshape(H, W, 2).numpy().astype(np.float32)
    flow[:, 20:28] += np.array([3.0, -1.5], np.float32)
    flow += rng.normal(scale=0.05, size=flow.shape).astype(np.float32)
    mask = np.ones((H, W), bool)
    mask[5:12, 40:50] = False
    return flow, mask


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _to_torch(res):
    return type(res)(*[torch.from_numpy(np.array(x)) for x in res])


@pytest.fixture(scope="module")
def problem():
    return _rs_flow()


def test_model_feedback_matches_jax(problem):
    """Fed the same estimate: the true motion scored on the trusted pixels
    (the JAX warm-start path without refinement, so no LM runs)."""
    flow, mask = problem
    cfg = dataclasses.replace(tconfig.E2E_CONFIG, use_refinement=False)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    warm = tuple(jnp.asarray(a, jnp.float32) for a in (V_TRUE, W_TRUE, 0.0))

    def jax_feedback(f, m):
        # One compile (op by op, JAX compiles each of the feedback pass's
        # many small operations apart, about 5x the time).
        res = jpipeline.estimate_from_flow(
            f, JINTR, GAMMA, jcfg, jax.random.PRNGKey(0), pixel_mask=m,
            warm_start=warm)
        return res, jfeedback.model_feedback(f, ~m, res, JINTR, GAMMA, jcfg)

    res_j, fj = run_jitted(jax_feedback, jnp.asarray(flow),
                           jnp.asarray(mask))
    ft = tfeedback.model_feedback(torch.from_numpy(flow),
                                  ~torch.from_numpy(mask), _to_torch(res_j),
                                  INTR, GAMMA, cfg)
    for name in ("occlusion", "outlier", "depth_outlier", "trusted_depth"):
        got, ref = getattr(ft, name).numpy(), np.asarray(getattr(fj, name))
        assert (got != ref).mean() <= 1e-3, name
    # Every family of the extension is exercised.
    assert np.asarray(fj.depth_outlier).sum() > 0
    assert np.asarray(fj.outlier).sum() > 0
    np.testing.assert_allclose(ft.model_flow.numpy(),
                               np.asarray(fj.model_flow), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.flow.numpy(), np.asarray(fj.flow), rtol=0,
                               atol=1e-4)


def test_estimate_with_feedback_matches_jax(problem, monkeypatch):
    # The JAX multi-start refinement pads N to its 16384-pixel tile; 4096
    # keeps its interpret-mode run short and changes only the summation
    # blocks.
    monkeypatch.setattr(jrk, "TILE_MULTI", 4096)
    flow, mask = problem
    cfg = tconfig.E2E_CONFIG
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    key = jax.random.PRNGKey(0)
    rj = run_jitted(lambda f, m: jpipeline.estimate_with_feedback(
        f, JINTR, GAMMA, jcfg, key, pixel_mask=m), jnp.asarray(flow),
        jnp.asarray(mask))
    valid = (jpipeline.prepare_flow_inputs(jnp.asarray(flow), JINTR, GAMMA,
                                           jcfg)[4]
             & jnp.asarray(mask).reshape(-1))
    idx = np.array(jransac.sample_valid_indices(key, valid,
                                                cfg.ransac_trials))
    rt = tpipeline.estimate_with_feedback(torch.from_numpy(flow), INTR, GAMMA,
                                          cfg, sample_indices=idx,
                                          pixel_mask=torch.from_numpy(mask))
    vj, vt = _unit(rj.v), _unit(rt.v.numpy())
    np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=0,
                               atol=2e-5)
    n = H * W
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 5e-3 * n
    # The last pass's trusted mask: the feedback extension removed pixels.
    trusted = rt.valid_mask.numpy()
    assert (trusted != np.asarray(rj.valid_mask)).mean() <= 5e-3
    assert trusted.sum() < (mask & (np.abs(flow).sum(-1) > 0)).sum()
    assert torch.isfinite(rt.depth_map).all()
    # The true motion is recovered (v up to scale and sign).
    np.testing.assert_allclose(np.abs(vt @ _unit(V_TRUE)), 1.0, atol=1e-3)
    np.testing.assert_allclose(rt.w.numpy(), W_TRUE, rtol=0, atol=2e-4)


def test_feedback_passes_go_through_the_kernel_wrappers(problem,
                                                       monkeypatch):
    """Each feedback pass is one warm-start refinement: B1 is not run
    again, B2 (lm_iter) runs feedback_refine_iterations + 1 sweeps per
    pass, B3 only in pass 1 (chip_smoke.py asserts the same counts on the
    card)."""
    calls = {"lm_iter": 0, "lm_iter_multi": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tref, "lm_iter", spy("lm_iter", trk.lm_iter))
    monkeypatch.setattr(tref, "lm_iter_multi",
                        spy("lm_iter_multi", trk.lm_iter_multi))
    flow, mask = problem
    cfg = dataclasses.replace(tconfig.E2E_CONFIG, ransac_trials=32)
    tpipeline.estimate_with_feedback(torch.from_numpy(flow), INTR, GAMMA, cfg,
                                     torch.Generator().manual_seed(0),
                                     pixel_mask=torch.from_numpy(mask))
    fb_iters = cfg.feedback_refine_iterations
    winnow = cfg.refine_winnow_iters
    assert calls == {
        "lm_iter": cfg.feedback_passes * (fb_iters + 1),
        "lm_iter_multi": (winnow + 1) + (cfg.refine_iterations - winnow + 1)}


def test_no_feedback_passes_is_estimate_from_flow(problem):
    flow, mask = problem
    cfg = dataclasses.replace(tconfig.E2E_CONFIG, feedback_passes=0,
                              ransac_trials=32)
    args = (torch.from_numpy(flow), INTR, GAMMA, cfg)
    a = tpipeline.estimate_with_feedback(
        *args, torch.Generator().manual_seed(0),
        pixel_mask=torch.from_numpy(mask))
    b = tpipeline.estimate_from_flow(*args, torch.Generator().manual_seed(0),
                                     pixel_mask=torch.from_numpy(mask))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("change", [
    dict(feedback_revote=True), dict(feedback_fast_inpaint=True),
    dict(feedback_mode="full", feedback_revote=True)])
def test_unported_feedback_options_raise(problem, change):
    """The re-vote and the decimated inpainting (ROADMAP A10) raise, the
    re-vote in "full" mode as well."""
    flow, mask = problem
    cfg = dataclasses.replace(tconfig.E2E_CONFIG, ransac_trials=32, **change)
    with pytest.raises(NotImplementedError):
        tpipeline.estimate_with_feedback(torch.from_numpy(flow), INTR, GAMMA,
                                         cfg, torch.Generator().manual_seed(0))


FULL_CFG = dataclasses.replace(tconfig.E2E_CONFIG, refine_engine="xla",
                               ransac_engine="xla", feedback_passes=1,
                               feedback_mode="full")


def _jax_draws(key, trials):
    """sample_indices for the port: pass p's JAX draws from that pass's
    trusted pixels (pass 0 the key itself, feedback pass p fold_in(key,
    101 + p - 1), as the JAX loop draws them)."""
    def draws(p, valid):
        k = key if p == 0 else jax.random.fold_in(key, 100 + p)
        return np.array(jransac.sample_valid_indices(
            k, jnp.asarray(valid.numpy()), trials))
    return draws


@pytest.fixture(scope="module")
def jax_full(problem):
    """The JAX estimation with one "full" feedback pass, "xla" engines,
    compiled once."""
    flow, mask = problem
    jcfg = JaxConfig(**dataclasses.asdict(FULL_CFG))
    key = jax.random.PRNGKey(2)
    res = run_jitted(lambda f, m: jpipeline.estimate_with_feedback(
        f, JINTR, GAMMA, jcfg, key, pixel_mask=m), jnp.asarray(flow),
        jnp.asarray(mask))
    return key, jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_full_feedback_mode_matches_jax(problem, jax_full, engine):
    flow, mask = problem
    key, rj = jax_full
    cfg = dataclasses.replace(FULL_CFG, refine_engine=engine,
                              ransac_engine=engine)
    passes = []

    def draws(p, valid):
        passes.append(p)
        return _jax_draws(key, cfg.ransac_trials)(p, valid)

    rt = tpipeline.estimate_with_feedback(torch.from_numpy(flow), INTR, GAMMA,
                                          cfg, sample_indices=draws,
                                          pixel_mask=torch.from_numpy(mask))
    assert passes == [0, 1]
    vj, vt = _unit(rj.v), _unit(rt.v.numpy())
    np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(rt.w.numpy(), rj.w, rtol=0, atol=2e-5)
    n = H * W
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 5e-3 * n
    assert (rt.valid_mask.numpy() != rj.valid_mask).mean() <= 5e-3
    # A full pass re-runs the multi-start schedule: its diversity starts
    # are exported again (row 0 the model, then the 4 refined starts).
    assert rt.top_v.shape == rj.top_v.shape == (5, 3)
    # On these draws pass 1 settles in another basin (|cos| to the true v
    # 0.886, both packages); the full pass on the cleaned mask leaves it
    # (0.9989 in both).
    assert np.abs(vt @ _unit(V_TRUE)) > 0.998


def test_full_feedback_mode_draws_per_pass_generators(problem):
    """Each "full" pass draws from its own generator, seeded from the
    caller's seed and the pass (pipeline.pass_generator): the run is
    reproducible from the seed, fixed draws alone are refused, and the
    warm-start iteration count does not apply to a full pass."""
    flow, mask = problem
    cfg = dataclasses.replace(FULL_CFG, ransac_trials=32,
                              feedback_refine_iterations=1)
    args = (torch.from_numpy(flow), INTR, GAMMA, cfg)
    a, b = (tpipeline.estimate_with_feedback(
        *args, torch.Generator().manual_seed(7),
        pixel_mask=torch.from_numpy(mask)) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    g = tpipeline.pass_generator(torch.Generator().manual_seed(7), 0)
    assert g.initial_seed() == (7 * 1_000_003 + 101) % (1 << 63)
    assert tpipeline.pass_generator(None, 0) is None
    with pytest.raises(ValueError, match="full"):
        tpipeline.estimate_with_feedback(
            *args, sample_indices=np.zeros((32, 9), np.int64))
    assert np.abs(_unit(a.v.numpy()) @ _unit(V_TRUE)) > 0.998
