"""Accuracy gates of the port against a known truth, pure torch on the CPU
(no JAX): the castle gate at 270x480 and the twins of
tests/test_feedback.py's corrupted-band tests at 96x128.

  * The castle gate runs the body of tests/test_fullhd_flow.py::_gate
    (rs_sfm_tpu_torch.eval.gate) on the clean castle at 270x480 with the
    variational preset and the production estimation.  Its thresholds are
    the JAX package's values from one run of that body at this size (EPE
    median 0.1057 px, err_v 0.02569 rad, err3d 0.2688, depth RMSE 0.6863)
    with the full-HD gate's ~50 % margin.
  * The feedback twins keep tests/test_feedback.py's thresholds.  The port
    draws its own RANSAC stream (a torch.Generator, not a JAX key) and runs
    the fused refinement (refine_engine="pallas"); the second twin runs
    each re-estimation mode ("refine" and "full") as a test of its own.

`tests/test_torch_cuda.py` runs the feedback twins on the card through
`check_feedback_recovers_band` and `check_feedback_config_pass`.
"""

import numpy as np
import torch

from rs_sfm_tpu_torch.config import E2E_CONFIG, PipelineConfig
from rs_sfm_tpu_torch.eval.gate import castle_truth, production_gate
from rs_sfm_tpu_torch.eval.metrics import translation_error
from rs_sfm_tpu_torch.flow.feedback import model_feedback
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.models import get_flow_preset
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.pipeline import (estimate_from_flow,
                                              estimate_with_feedback)

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

# 1.5x the JAX package's values at 270x480 (module docstring).
CASTLE_270_GATES = {"epe_median": 0.16, "err_v": 0.039, "err3d": 0.40,
                    "depth_rmse": 1.03}

FH, FW, F, GAMMA = 96, 128, 110.0, 0.9
V_BAND = (0.03, -0.01, 0.02)
W_BAND = (0.002, -0.001, 0.003)


def test_castle_gate_270x480():
    truth = castle_truth(270, 480, device="cpu")
    got = production_gate(truth, truth.i2, get_flow_preset("variational"),
                          E2E_CONFIG, torch.Generator().manual_seed(0))
    for name, gate in CASTLE_270_GATES.items():
        assert got[name] <= gate, (name, got[name], gate)


def _gt_flow(depth, device):
    """(intrinsics, (FH, FW, 2) float32 RS flow of the band scene): the
    fixed point of the flow's own y component, as test_feedback._gt_flow."""
    intr = Intrinsics(fx=F, fy=F, cx=FW / 2.0, cy=FH / 2.0)
    ys, xs = np.meshgrid(np.arange(FH, dtype=np.float64),
                         np.arange(FW, dtype=np.float64), indexing="ij")
    coords = torch.tensor(np.stack([(xs - intr.cx) / F, (ys - intr.cy) / F],
                                   -1).reshape(-1, 2), dtype=torch.float32,
                          device=device)
    rho = torch.tensor((1.0 / depth).reshape(-1), dtype=torch.float32,
                       device=device)
    v = torch.tensor(V_BAND, dtype=torch.float32, device=device)
    w = torch.tensor(W_BAND, dtype=torch.float32, device=device)
    ysf = torch.tensor(ys.reshape(-1), dtype=torch.float32, device=device)
    fl = torch.zeros((FH * FW, 2), dtype=torch.float32, device=device)
    for _ in range(6):
        fl = predict_flow(coords, rho, v, w, 0.0,
                          get_alpha(fl[:, 1] * F, FH, GAMMA),
                          get_alpha_k(ysf, fl[:, 1] * F, FH, GAMMA))
    return intr, (fl * F).reshape(FH, FW, 2)


def _band_scene(seed, cols, device):
    """(intrinsics, true flow, flow with a (6, -3) px band, band mask) on
    8x8-pixel depth blocks in [4, 8]."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(4.0, 8.0, (FH // 8 + 1, FW // 8 + 1))
    depth = np.kron(base, np.ones((8, 8)))[:FH, :FW].astype(np.float32)
    intr, gt = _gt_flow(depth, device)
    band = torch.zeros((FH, FW), dtype=torch.bool, device=device)
    band[:, cols[0]:cols[1]] = True
    corrupted = gt.clone()
    corrupted[band] += torch.tensor([6.0, -3.0], device=device)
    return intr, gt, corrupted, band


def check_feedback_recovers_band(device):
    """test_feedback.py::test_feedback_recovers_corrupted_band on `device`:
    the feedback pass flags the band and replaces its flow with the rigid
    model's, to under 1 px."""
    intr, gt, corrupted, band = _band_scene(3, (48, 60), device)
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                         refine_iterations=20, refine_starts=2,
                         refine_engine="pallas")
    gen = torch.Generator(device=device).manual_seed(0)
    res = estimate_from_flow(corrupted, intr, GAMMA, cfg, gen)
    fb = model_feedback(corrupted, torch.zeros_like(band), res, intr, GAMMA,
                        cfg)
    flagged = (fb.outlier | fb.depth_outlier).float()
    assert float(flagged[band].mean()) > 0.9, float(flagged[band].mean())
    assert float(flagged[~band].mean()) < 0.1, float(flagged[~band].mean())
    epe_before = torch.linalg.vector_norm(corrupted - gt, dim=-1)
    epe_after = torch.linalg.vector_norm(fb.flow - gt, dim=-1)
    assert float(epe_before[band].mean()) > 6.0
    assert float(epe_after[band].mean()) < 1.0, float(epe_after[band].mean())
    assert float(epe_after[~band].max()) < 0.3


def check_feedback_config_pass(device, mode="refine"):
    """test_feedback.py::test_estimate_with_feedback_config_pass on
    `device`: feedback_passes = 0 is the single pass, and one feedback pass
    in `mode` ("refine": warm-started; "full": the whole schedule again on
    the cleaned mask) is no worse than it and under 0.02 rad."""
    intr, _, corrupted, _ = _band_scene(5, (40, 56), device)
    base_cfg = dict(ransac_trials=64, ransac_tol=0.01, refine_iterations=20,
                    refine_starts=2, refine_loss_delta_px=3.0,
                    refine_engine="pallas")
    cfg0 = PipelineConfig(**base_cfg)

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    res0 = estimate_with_feedback(corrupted, intr, GAMMA, cfg0, gen())
    res0_direct = estimate_from_flow(corrupted, intr, GAMMA, cfg0, gen())
    assert torch.equal(res0.v, res0_direct.v)
    err0 = float(translation_error(res0.v, V_BAND))
    cfg1 = PipelineConfig(**base_cfg, feedback_passes=1,
                          feedback_mode=mode)
    res1 = estimate_with_feedback(corrupted, intr, GAMMA, cfg1, gen())
    err1 = float(translation_error(res1.v, V_BAND))
    assert err1 <= err0 + 1e-4, (mode, err0, err1)
    assert err1 < 0.02, (mode, err1)


def test_feedback_recovers_corrupted_band():
    check_feedback_recovers_band(torch.device("cpu"))


def test_estimate_with_feedback_config_pass():
    check_feedback_config_pass(torch.device("cpu"))


def test_estimate_with_feedback_config_pass_full_mode():
    check_feedback_config_pass(torch.device("cpu"), "full")
