"""The relock pass (flow/relock.py) and the flow prior it feeds dense flow:
rs_sfm_tpu_torch vs the JAX package on the CPU.

  * `flow_with_relock(force=True)` on the repetitive-texture castle at
    64x96 (rendered once in float64 by the port, the same float32 frames
    to both packages), the port handed the JAX package's draws of every
    stage (the shift family's fold_in(key, 100 + n), the final
    estimation's fold_in(key, 7)): the ambiguity masks equal (their shares
    within 1e-6, summed in another order), the second pass's flow within
    the dense-flow parity tolerances (tests/test_torch_flow.py: median EPE
    1e-3 px, 99th percentile 0.1 px; the port's SOR is the TPU kernel's
    absolute form), the same winning shift (its inliers equal, its cost
    within 0.5 %), and the winning shift's estimation and the final one
    with v as a direction within 5e-3 and w within 3e-4 (measured 7e-5
    and 1.4e-4 for the first, 1.9e-3 and 5e-5 for the final one), inlier
    counts within 0.5 % of the pixels.  These are looser than the pipeline
    tests' 2e-3 and 2e-5: on this scene only 102 and 179 of the 6,144
    pixels are inliers (the periodic walls hold 88 % of the frame), so
    float32 rounding of the flow moves the fit more.  The JAX package's
    own flow_with_relock runs, its estimations and model_feedback each
    jitted once (level 0) in place of its eager calls: the configuration
    makes the shift family's scoring configuration the final one, so one
    compile serves all six estimations;
  * `flow_forward_backward` with the anchored pass (`anchor_ambiguous`),
    without and with a prior, against the JAX package's (the executables
    the relock compiled): the ambiguity masks equal, the flows within the
    dense-flow parity tolerances;
  * without JAX: below the trigger the result is the single pass bit for
    bit; a pass 1 with no ambiguous pixel gives p̂ NaN and no NaN in any
    flow or result; the median of an even count is the mean of the two
    middle values (jnp.nanmedian), not torch.nanmedian's lower one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference import compile_level0

from rs_sfm_tpu.config import PipelineConfig as JaxConfig
from rs_sfm_tpu.flow import dense as jdense
from rs_sfm_tpu.flow import feedback as jfeedback
from rs_sfm_tpu.flow import relock as jrelock
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.solver import pipeline as jpipeline
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.data import synthetic as tsyn
from rs_sfm_tpu_torch.flow import relock as trelock
from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

H, W, GAMMA = 64, 96, 0.9
V_TRUE = (0.35, -0.15, 0.25)
W_TRUE = (0.003, -0.002, 0.004)
# A short pyramid (3 levels at 64x96: the coarse search at 16x24, a
# refine at 32x48) with the anchored pass, and an estimation that equals the shift family's
# scoring configuration (at most 128 trials, one start, 8 iterations, no
# feedback pass).
FLOW_CFG = dict(warps=1, iters=5, warps_coarse=1, anchor_ambiguous=True)
EST_CFG = dict(ransac_trials=64, ransac_tol=0.1, refine_iterations=8)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def frames():
    """The repetitive-texture castle at 64x96 (float64 render, float32
    frames) and its intrinsics."""
    intr = tsyn.default_intrinsics(H, W)
    pair = tsyn.render_pair(tsyn.repetitive_scene(torch.float64, "cpu"),
                            intr, H, W, gamma=GAMMA, k=0.0, v=V_TRUE,
                            w=W_TRUE, dtype=torch.float64)
    return (pair.frame1.rs_image.float().numpy(),
            pair.frame2.rs_image.float().numpy(), intr)


@pytest.fixture(scope="module")
def jax_relock(frames):
    i1, i2, intr = frames
    jintr = JaxIntrinsics(**dataclasses.asdict(intr))
    jcfg = JaxConfig(**EST_CFG)
    key = jax.random.PRNGKey(3)
    estimate, feedback = jpipeline.estimate_from_flow, jfeedback.model_feedback
    compiled = {}

    def jitted(name, fn, *args):
        if name not in compiled:
            compiled[name] = compile_level0(fn, *args)
        return compiled[name](*args)

    def estimate_jit(flow, intr_, gamma, cfg, k, pixel_mask=None):
        assert cfg == jcfg  # the one compiled configuration
        return jitted("estimate", lambda f, kk, m: estimate(
            f, jintr, GAMMA, jcfg, kk, pixel_mask=m), flow, k, pixel_mask)

    def feedback_jit(flow, occ, res, intr_, gamma, cfg):
        return jitted("feedback", lambda f, o, r: feedback(
            f, o, r, jintr, GAMMA, jcfg), flow, occ, res)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline, "estimate_from_flow", estimate_jit)
        mp.setattr(jrelock, "estimate_with_feedback", estimate_jit)
        mp.setattr(jfeedback, "model_feedback", feedback_jit)
        res = jrelock.flow_with_relock(
            jnp.asarray(i1), jnp.asarray(i2),
            jdense.DenseFlowConfig(**FLOW_CFG), jintr, GAMMA, jcfg, key,
            force=True)
    return key, jax.tree_util.tree_map(np.asarray, res)


def test_flow_with_relock_matches_jax(frames, jax_relock):
    i1, i2, intr = frames
    key, rj = jax_relock
    stages = []

    def draws(stage, valid):
        """JAX's draws of `stage`: the caller's key folded by each of its
        integers, from the stage's valid pixels."""
        stages.append(stage)
        k = key
        for data in stage:
            k = jax.random.fold_in(k, data)
        return np.array(jransac.sample_valid_indices(
            k, jnp.asarray(valid.numpy()), EST_CFG["ransac_trials"]))

    rt = trelock.flow_with_relock(
        torch.from_numpy(i1), torch.from_numpy(i2),
        DenseFlowConfig(**FLOW_CFG), intr, GAMMA, PipelineConfig(**EST_CFG),
        force=True, sample_indices=draws)
    # The five shift estimations, then the final estimation.
    assert stages == [(98,), (99,), (100,), (101,), (102,), (7,)]
    assert abs(float(rt.ambiguous_frac) - float(rj.ambiguous_frac)) <= 1e-6
    assert 0.05 < float(rt.ambiguous_frac) < 0.95
    assert rt.shift in trelock.SHIFTS
    assert torch.isfinite(rt.period).all()
    epe = np.linalg.norm(rt.fb.flow.numpy() - rj.fb.flow, axis=-1)
    assert np.median(epe) <= 1e-3 and np.percentile(epe, 99) <= 0.1, (
        np.median(epe), np.percentile(epe, 99))
    # The same shift won: its inliers, and its cost within rounding (the
    # family's costs differ by 60 % or more on these draws).
    assert int(rt.first_pass.num_inliers) == int(rj.first_pass.num_inliers)
    np.testing.assert_allclose(float(rt.first_pass.refine_cost),
                               float(rj.first_pass.refine_cost), rtol=5e-3)
    for got, ref in ((rt.first_pass, rj.first_pass), (rt.result, rj.result)):
        vj, vt = _unit(ref.v), _unit(got.v.numpy())
        np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, rtol=0,
                                   atol=5e-3)
        np.testing.assert_allclose(got.w.numpy(), ref.w, rtol=0, atol=3e-4)
        assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 5e-3 * H * W


@pytest.mark.parametrize("prior", [False, True])
def test_dense_flow_prior_and_anchored_pass_match_jax(frames, jax_relock,
                                                      prior):
    """flow_forward_backward with the anchored pass, without and with a
    prior (JAX pass 1's flow moved by p̂ on its ambiguous pixels, which
    steers the exact ties to the next period), against the JAX package's
    (the executables the relock compiled): the discrete searches'
    ambiguity masks and alternative locks equal, the flows within the
    dense-flow parity tolerances, and the anchored pass changed the flow
    (the masked data term)."""
    i1, i2, _ = frames
    jcfg = jdense.DenseFlowConfig(**FLOW_CFG)
    tcfg = DenseFlowConfig(**FLOW_CFG)
    j1 = jdense.flow_forward_backward(jnp.asarray(i1), jnp.asarray(i2), jcfg)
    pr = None
    if prior:
        p_hat = trelock.period_estimate(
            torch.from_numpy(np.array(j1.flow)),
            torch.from_numpy(np.array(j1.alt_flow)),
            torch.from_numpy(np.array(j1.ambiguous)))
        pr = torch.where(torch.from_numpy(np.array(j1.ambiguous))[..., None],
                         torch.from_numpy(np.array(j1.flow)) + p_hat,
                         torch.from_numpy(np.array(j1.flow)))
        rj = jdense.flow_forward_backward(jnp.asarray(i1), jnp.asarray(i2),
                                          jcfg, prior=jnp.asarray(pr.numpy()))
    else:
        rj = j1
    rt = flow_forward_backward(torch.from_numpy(i1), torch.from_numpy(i2),
                               tcfg, prior=pr)
    np.testing.assert_array_equal(rt.ambiguous.numpy(), np.asarray(rj.ambiguous))
    alt = np.abs(rt.alt_flow.numpy() - np.asarray(rj.alt_flow)).max(-1)
    assert np.percentile(alt, 99) <= 0.1
    for got, ref in ((rt.flow, rj.flow), (rt.backward, rj.backward)):
        epe = np.linalg.norm(got.numpy() - np.asarray(ref), axis=-1)
        assert np.median(epe) <= 1e-3 and np.percentile(epe, 99) <= 0.1, (
            np.median(epe), np.percentile(epe, 99))
    assert (rt.occlusion.numpy() != np.asarray(rj.occlusion)).mean() <= 5e-3
    free = flow_forward_backward(torch.from_numpy(i1), torch.from_numpy(i2),
                                 tcfg._replace(anchor_ambiguous=False),
                                 prior=pr)
    assert float(torch.abs(free.flow - rt.flow).max()) > 0.1
    if prior:
        # The prior moved the locks: the flow is not pass 1's.
        moved = np.linalg.norm(rt.flow.numpy() - np.array(j1.flow), axis=-1)
        assert np.median(moved) > 0.5


def test_relock_below_the_trigger_is_the_single_pass(frames):
    i1, i2, intr = (torch.from_numpy(frames[0]), torch.from_numpy(frames[1]),
                    frames[2])
    fcfg = DenseFlowConfig(**FLOW_CFG)
    cfg = dataclasses.replace(PipelineConfig(**EST_CFG), ransac_trials=32,
                              feedback_passes=1, feedback_refine_iterations=2)
    got = trelock.flow_with_relock(i1, i2, fcfg, intr, GAMMA, cfg,
                                   torch.Generator().manual_seed(5),
                                   trigger_frac=1.01)
    fb = flow_forward_backward(i1, i2, fcfg)
    res = estimate_with_feedback(fb.flow, intr, GAMMA, cfg,
                                 torch.Generator().manual_seed(5),
                                 pixel_mask=~fb.occlusion)
    assert got.shift is None and got.period is None and got.prior is None
    assert got.first_pass is got.result
    for a, b in zip(got.fb, fb):
        assert torch.equal(a, b)
    for a, b in zip(got.result, res):
        assert torch.equal(a, b)


def test_relock_without_ambiguous_pixels_keeps_nan_out(frames, monkeypatch):
    """force=True on a pass 1 with no ambiguous pixel: p̂ is NaN, and
    torch.where keeps it out of the shift family as jnp.where does."""
    i1, i2, intr = (torch.from_numpy(frames[0]), torch.from_numpy(frames[1]),
                    frames[2])
    real = trelock.flow_forward_backward
    calls = []

    def clean_first_pass(*args, **kwargs):
        fb = real(*args, **kwargs)
        calls.append(kwargs.get("prior"))
        if len(calls) == 1:
            fb = fb._replace(ambiguous=torch.zeros_like(fb.ambiguous))
        return fb

    monkeypatch.setattr(trelock, "flow_forward_backward", clean_first_pass)
    cfg = dataclasses.replace(PipelineConfig(**EST_CFG), ransac_trials=32)
    got = trelock.flow_with_relock(i1, i2, DenseFlowConfig(**FLOW_CFG), intr,
                                   GAMMA, cfg,
                                   torch.Generator().manual_seed(1),
                                   force=True)
    assert float(got.ambiguous_frac) == 0.0
    assert torch.isnan(got.period).all()
    assert calls[0] is None and torch.isfinite(calls[1]).all()
    assert calls[1] is got.prior
    for res in (got.first_pass, got.result):
        for field in ("v", "w", "k", "depth_map", "refine_cost"):
            assert torch.isfinite(getattr(res, field)).all(), field
    assert torch.isfinite(got.fb.flow).all()


@pytest.mark.parametrize("n", [0, 1, 2, 5, 6])
def test_nanmedian_is_the_midpoint(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=12).astype(np.float32)
    x[n:] = np.nan  # n values
    got = trelock.nanmedian(torch.from_numpy(x))
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), ref)
    if n and n % 2 == 0:
        # torch.nanmedian returns the lower middle value.
        lower = torch.nanmedian(torch.from_numpy(x))
        assert float(lower) < float(got)
    if n:
        np.testing.assert_allclose(float(got), np.nanmedian(x), rtol=1e-6)
    else:
        assert torch.isnan(got)


def test_period_estimate_canonicalises_signs():
    """Separations of ±p about the flow give p̂ = p (the sign turned to
    +x), whichever lock each pixel took."""
    flow = torch.zeros((4, 6, 2))
    p = torch.tensor([5.0, -1.0])
    signs = torch.tensor([1.0, -1.0]).repeat(12)[:24].reshape(4, 6, 1)
    alt = flow + signs * p
    amb = torch.ones((4, 6), dtype=torch.bool)
    amb[0, 0] = False
    alt[0, 0] = torch.tensor([-100.0, 3.0])  # not ambiguous: not counted
    assert torch.equal(trelock.period_estimate(flow, alt, amb), p)
