"""The castle truth gate: the production path on the rendered castle pair,
held to the renderer's truth (the body of the JAX package's full-HD gate,
tests/test_fullhd_flow.py:60-117, at any size and on any device).

Flow EPE against the true flow, the angle of v to the true v, the
scale-aligned mean 3D error of the rectified points and the scale-aligned
depth RMSE.  Both `chip_smoke.py` (full HD, on the card) and the CPU
tests (a reduced size) run this one body.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from rs_sfm_tpu_torch.geom.camera import Intrinsics

GAMMA = 0.9
V_TRUE = (0.35, -0.15, 0.25)
W_TRUE = (0.003, -0.002, 0.004)
# The photometric case: exposure gain, vignette and sensor noise
# (tests/test_fullhd_flow.py:134-136).
PHOTOMETRIC = dict(exposure=1.35, vignette=0.35, noise_sigma=0.005)


class CastleTruth(NamedTuple):
    intr: Intrinsics
    i1: torch.Tensor          # (H, W, 3) frame-1 RS image, float32
    i2: torch.Tensor          # (H, W, 3) frame-2 RS image
    gt_flow: torch.Tensor     # (H, W, 2) true RS->RS flow
    true_depth: torch.Tensor  # (H, W) frame-1 true depth (0 = void)
    poses_r: torch.Tensor     # (H, 3, 3) frame-1 true scanline poses
    poses_t: torch.Tensor     # (H, 3)


def castle_truth(rows: int, cols: int, device=None, k: float = 0.0,
                 scene=None) -> CastleTruth:
    """The castle pair rendered in float32 at (rows, cols) with γ 0.9, the
    gate's (v, w) and acceleration factor k, its true flow and true depth.
    `device` None means the CUDA device (raises without one); `scene`
    another scene of the castle's geometry (default: the castle)."""
    from rs_sfm_tpu_torch.data.dataset import true_depth_from_unprojection
    from rs_sfm_tpu_torch.data.synthetic import (castle_scene,
                                                 default_intrinsics,
                                                 render_pair)
    from rs_sfm_tpu_torch.flow.true_flow import true_flow

    intr = default_intrinsics(rows, cols)
    if scene is None:
        scene = castle_scene(torch.float32, device)
    pair = render_pair(scene, intr, rows, cols, gamma=GAMMA, k=k, v=V_TRUE,
                       w=W_TRUE, dtype=torch.float32)
    f1, f2 = pair.frame1, pair.frame2
    gt = true_flow(f1.rs_unproject, f2.poses_r, f2.poses_t, intr)
    td = true_depth_from_unprojection(f1.rs_unproject, f1.poses_r,
                                      f1.poses_t)
    return CastleTruth(intr, f1.rs_image, f2.rs_image, gt, td, f1.poses_r,
                       f1.poses_t)


def production_gate(truth: CastleTruth, i2, flow_cfg, est_cfg,
                    generator: Optional[torch.Generator] = None, *,
                    timer: Optional[Callable[[str], None]] = None) -> dict:
    """The production path from (truth.i1, i2): flow_forward_backward,
    estimate_with_feedback on the unoccluded pixels, scanline poses and
    the default (packed24) rectification; returns {"epe_median",
    "err_v", "err3d", "depth_rmse", "k"} as floats (k: the estimate).

    `timer`, if given, is called after each stage is issued: "flow_forward",
    "flow_backward" (dense flow), "estimate", "feedback" (the estimation),
    "rectify" and "metrics"."""
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

    mark = timer if timer is not None else (lambda _name: None)
    fb = flow_forward_backward(truth.i1, i2, flow_cfg, timer=mark)
    res = estimate_with_feedback(fb.flow, truth.intr, GAMMA, est_cfg,
                                 generator, pixel_mask=~fb.occlusion,
                                 timer=mark)
    return gate_metrics(truth, fb.flow, res, timer=mark)


def gate_metrics(truth: CastleTruth, flow, res, *,
                 timer: Optional[Callable[[str], None]] = None) -> dict:
    """The gate's metrics of a flow and the estimation on it: the flow's
    EPE median on the moving pixels, err_v, and through scanline poses and
    the default (packed24) rectification err3d and depth RMSE; returns
    {"epe_median", "err_v", "err3d", "depth_rmse", "k"} as floats.
    `timer`, if given, is called with "rectify" and "metrics"."""
    from rs_sfm_tpu_torch.eval.metrics import (depth_rmse,
                                               mean_reprojection_error,
                                               translation_error)
    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject

    mark = timer if timer is not None else (lambda _name: None)
    intr = truth.intr
    moving = torch.linalg.vector_norm(truth.gt_flow, dim=-1) > 0
    epe = torch.linalg.vector_norm(flow - truth.gt_flow, dim=-1)[moving]
    err_v = translation_error(res.v, V_TRUE)
    r_sl, t_sl = scanline_poses(res.v, res.w, res.k, truth.i1.shape[0], GAMMA,
                                dtype=torch.float32)
    rect = backproject(truth.i1, res.depth_map, r_sl, t_sl, intr)
    mark("rectify")
    err3d, _, _ = mean_reprojection_error(
        rect.coords_3d, rect.valid, truth.true_depth, truth.poses_r,
        truth.poses_t, intr)
    drmse, _ = depth_rmse(res.depth_map, truth.true_depth, res.inlier_mask)
    # numpy's median (the mean of the two middle values), as the JAX gate.
    epe_med = torch.quantile(epe.to(torch.float64), 0.5)
    mark("metrics")
    return {"epe_median": float(epe_med), "err_v": float(err_v),
            "err3d": float(err3d), "depth_rmse": float(drmse),
            "k": float(res.k)}
