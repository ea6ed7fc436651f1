"""The solver slice end to end: rs_sfm_tpu_torch vs the JAX package on a
60x80 rolling-shutter flow, for both slice configurations
(rs_sfm_tpu_torch.config.SLICE_CONFIGS).

The port is handed the JAX package's RANSAC draws
(`sample_valid_indices(key, valid, trials)`), so both run the same
hypotheses.  Tolerances: v as a direction (sign-aligned) atol 2e-4, w atol
1e-5, num_inliers within 0.1 % of N (float32 summation order in the LM and
in the inlier tests).  Rectification is then fed the same depth map and
scanline poses on both sides; the packed24 image and hit mask are integer
results of identical float32 elementwise arithmetic and must be bit-exact.
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
from rs_sfm_tpu.geom.rspose import scanline_poses as j_scanline_poses
from rs_sfm_tpu.ops.pallas import refine_kernels as jrk
from rs_sfm_tpu.rectify.backproject import backproject as j_backproject
from rs_sfm_tpu.solver.pipeline import estimate_from_flow as j_estimate
from rs_sfm_tpu.solver.pipeline import prepare_flow_inputs as j_prepare
from rs_sfm_tpu_torch import config as tconfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.geom.rspose import scanline_poses
from rs_sfm_tpu_torch.ops.kernels import refine_kernels as trk
from rs_sfm_tpu_torch.ops.kernels import score as tscore
from rs_sfm_tpu_torch.rectify.backproject import backproject
from rs_sfm_tpu_torch.solver import pipeline as tpipeline
from rs_sfm_tpu_torch.solver import ransac as transac
from rs_sfm_tpu_torch.solver import refine_fused as tref
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

H, W, F, GAMMA = 60, 80, 70.0, 0.9
INTR = Intrinsics(fx=F, fy=F, cx=W / 2.0, cy=H / 2.0)
JINTR = JaxIntrinsics(**dataclasses.asdict(INTR))


def _rs_flow(h=H, w=W, seed=17):
    """(h, w, 2) float32 pixel flow of a random-depth scene under a
    rolling shutter: the flow's own y component sets each pixel's readout
    time, so it is found by fixed-point iteration (as in
    tests/test_pallas_refine.py::test_pipeline_winnow_matches_full_multistart)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(np.stack([(xs - w / 2.0) / F,
                                        (ys - h / 2.0) / F], -1).reshape(-1, 2))
    rho = torch.from_numpy(1.0 / rng.uniform(4.0, 9.0, size=h * w))
    v = torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64)
    wr = torch.tensor([0.003, -0.002, 0.004], dtype=torch.float64)
    ys = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((h * w, 2), dtype=torch.float64)
    for _ in range(6):
        a = get_alpha(fl[:, 1] * F, h, GAMMA)
        ak = get_alpha_k(ys, fl[:, 1] * F, h, GAMMA)
        fl = predict_flow(coords, rho, v, wr, 0.0, a, ak)
    return (fl * F).reshape(h, w, 2).numpy().astype(np.float32)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def jax_estimates():
    """The JAX estimation of both slice configurations on one flow, in one
    compiled function (their RANSAC draws and minimal solves are the same
    computation, compiled once)."""
    key = jax.random.PRNGKey(0)
    jcfgs = {name: JaxConfig(**dataclasses.asdict(cfg))
             for name, cfg in tconfig.SLICE_CONFIGS.items()}
    with pytest.MonkeyPatch.context() as mp:
        # The JAX multi-start refinement pads N to its 16384-pixel tile;
        # 4096 keeps its interpret-mode run short and changes only the
        # summation blocks.
        mp.setattr(jrk, "TILE_MULTI", 4096)
        return key, run_jitted(
            lambda f: {name: j_estimate(f, JINTR, GAMMA, jcfg, key)
                       for name, jcfg in jcfgs.items()},
            jnp.asarray(_rs_flow()))


@pytest.mark.parametrize("name", sorted(tconfig.SLICE_CONFIGS))
def test_estimate_and_rectify_match_jax(name, jax_estimates):
    cfg = tconfig.SLICE_CONFIGS[name]
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    flow = _rs_flow()
    key, wants = jax_estimates
    rj = wants[name]
    valid = j_prepare(jnp.asarray(flow), JINTR, GAMMA, jcfg)[4]
    idx = np.array(jransac.sample_valid_indices(key, valid, cfg.ransac_trials))
    rt = tpipeline.estimate_from_flow(torch.from_numpy(flow), INTR, GAMMA, cfg,
                                      sample_indices=idx)

    vj, vt = _unit(rj.v), _unit(rt.v.numpy())
    np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, rtol=0, atol=2e-4)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=0,
                               atol=1e-5)
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 1e-3 * H * W
    assert int(rt.num_inliers) > 0.9 * H * W
    assert torch.isfinite(rt.depth_map).all()
    assert rt.top_v.shape == (1 + (cfg.refine_starts if cfg.refine_starts > 1
                                   else 0), 3)

    # Rectification, both fed the JAX estimate's depth map and poses.
    r_j, t_j = j_scanline_poses(rj.v, rj.w, rj.k, H, GAMMA, dtype=jnp.float32)
    r_t, t_t = scanline_poses(torch.from_numpy(np.array(rj.v)),
                              torch.from_numpy(np.array(rj.w)),
                              torch.from_numpy(np.array(rj.k)), H, GAMMA,
                              dtype=torch.float32)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0,
                               atol=1e-7)
    image = np.random.default_rng(0).uniform(0.1, 0.9, (H, W, 3)).astype(
        np.float32)
    depth = np.array(rj.depth_map)
    bj = j_backproject(jnp.asarray(image), jnp.asarray(depth), r_j, t_j, JINTR)
    bt = backproject(torch.from_numpy(image), torch.from_numpy(depth),
                     torch.from_numpy(np.array(r_j)),
                     torch.from_numpy(np.array(t_j)), INTR)
    assert int(bt.scattered.sum()) > 0.5 * H * W
    np.testing.assert_array_equal(bt.scattered.numpy(),
                                  np.asarray(bj.scattered))
    np.testing.assert_array_equal(bt.gs_image.numpy(), np.asarray(bj.gs_image))
    np.testing.assert_allclose(bt.coords_3d.numpy(), np.asarray(bj.coords_3d),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,score_calls,lm_calls", [
    ("gt_flow", 1, {"lm_iter": 4, "lm_iter_multi": 0}),
    ("estimation", 1, {"lm_iter": 0, "lm_iter_multi": (2 + 1) + (1 + 1)}),
])
def test_slice_goes_through_the_kernel_wrappers(name, score_calls, lm_calls,
                                                monkeypatch):
    """The main path reaches B1 once per RANSAC and B2/B3 (iterations + 1)
    times per refinement call, through the wrappers that count launches on
    the card (chip_smoke.py asserts the same counts there)."""
    calls = {"score": 0, "lm_iter": 0, "lm_iter_multi": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(transac, "score_hypotheses",
                        spy("score", tscore.score_hypotheses))
    monkeypatch.setattr(tref, "lm_iter", spy("lm_iter", trk.lm_iter))
    monkeypatch.setattr(tref, "lm_iter_multi",
                        spy("lm_iter_multi", trk.lm_iter_multi))
    cfg = dataclasses.replace(tconfig.SLICE_CONFIGS[name], ransac_trials=16,
                              refine_iterations=3, refine_winnow_iters=2)
    flow = torch.from_numpy(_rs_flow(24, 32))
    res = tpipeline.estimate_from_flow(flow, INTR, GAMMA, cfg,
                                       torch.Generator().manual_seed(0))
    assert calls == {"score": score_calls, **lm_calls}
    assert torch.isfinite(res.v).all() and torch.isfinite(res.w).all()


def test_injected_draws_as_tensor_or_array():
    """`ransac` and `estimate_from_flow` take the injected draws as a torch
    tensor, a numpy array or a read-only numpy array (which torch cannot
    wrap), with equal results; a tensor may lie on any device (the CUDA
    case is in tests/test_torch_cuda.py)."""
    cfg = dataclasses.replace(tconfig.ESTIMATION_CONFIG, ransac_trials=16,
                              refine_iterations=3, refine_winnow_iters=2)
    flow = torch.from_numpy(_rs_flow(24, 32))
    coords, flow_n, alpha, alpha_k, valid = tpipeline.prepare_flow_inputs(
        flow, INTR, GAMMA, cfg)
    draws = transac.sample_valid_indices(torch.Generator().manual_seed(5),
                                         valid, cfg.ransac_trials)
    frozen = draws.numpy().copy()
    frozen.setflags(write=False)
    forms = {"tensor": draws, "int32 tensor": draws.to(torch.int32),
             "array": draws.numpy(), "read-only array": frozen}
    fits = {}
    for form, idx in forms.items():
        rr = transac.ransac(coords, flow_n, alpha, alpha_k, valid,
                            use_k=False, trials=cfg.ransac_trials,
                            tolerance=cfg.ransac_tol, sample_indices=idx,
                            engine=cfg.ransac_engine, top_j=cfg.refine_starts)
        res = tpipeline.estimate_from_flow(flow, INTR, GAMMA, cfg,
                                           sample_indices=idx)
        fits[form] = [rr.v, rr.w, rr.num_inliers, rr.top_v, res.v, res.w,
                      res.k, res.num_inliers, res.depth_map]
    for form, got in fits.items():
        for a, b in zip(got, fits["tensor"]):
            assert torch.equal(a, b), form


def test_unported_options_raise():
    flow = torch.from_numpy(_rs_flow(24, 32))
    for change in (dict(refine_winnow2_iters=4),):
        cfg = dataclasses.replace(tconfig.GT_FLOW_CONFIG, **change)
        with pytest.raises(NotImplementedError):
            tpipeline.estimate_from_flow(flow, INTR, GAMMA, cfg,
                                         torch.Generator().manual_seed(0))
