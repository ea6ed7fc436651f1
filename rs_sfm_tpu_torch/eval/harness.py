"""Evaluation harness: the reference's evaluateVelocities protocol (port of
rs_sfm_tpu/eval/harness.py; error_measure::evaluateVelocities,
src/errorMeasure.cpp:41-254).

flow → N repeated evaluations of RANSAC + refinement (+ the feedback
passes) → per-run rotation / translation errors, depth map artifact,
back-projection, scale-aligned 3D error → averaged VelocityErrors.

Each evaluation draws RANSAC samples from its own torch.Generator on the
device, seeded from `seed` through numpy's SeedSequence (the JAX package
splits a PRNG key); `sample_indices` (N, trials, 9) replaces the draws
(the tests hand in the JAX package's).  On one card the batched form loops
over the evaluations: there is no device-wide map to fuse them into.
Everything runs on the flow's device: a tensor argument stays where it
is, arrays go to `device` (None = the CUDA device; raises without one).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.data.dataset import (PairData, to_numpy,
                                           true_depth_from_unprojection)
from rs_sfm_tpu_torch.eval import artifacts
from rs_sfm_tpu_torch.eval.metrics import (depth_rmse, mean_reprojection_error,
                                           rotation_error, translation_error)
from rs_sfm_tpu_torch.flow.dense import as_device_tensor
from rs_sfm_tpu_torch.flow.true_flow import true_flow
from rs_sfm_tpu_torch.geom.rspose import scanline_poses
from rs_sfm_tpu_torch.rectify.backproject import backproject
from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback


class VelocityErrors(NamedTuple):
    """Per-run arrays and means (reference VelocityErrors,
    src/errorMeasure.h:18-44)."""

    w: np.ndarray               # (3, num_evaluations)
    v: np.ndarray               # (3, num_evaluations)
    k: np.ndarray               # (num_evaluations,)
    error_w_vec: np.ndarray     # (num_evaluations,)
    error_v_vec: np.ndarray     # (num_evaluations,)
    error_reproject_vec: np.ndarray  # (num_evaluations,)
    error_w: float
    error_v: float
    error_reproject: float
    num_inliers: np.ndarray     # (num_evaluations,)
    # Depth-quality columns (batched harness only).
    error_reproject_ls_vec: np.ndarray = None  # LS gauge-scale err3d
    depth_rmse_vec: np.ndarray = None          # scale-aligned depth RMSE


def evaluation_generators(seed: int, count: int, device):
    """`count` torch.Generators on `device`, one an evaluation, seeded
    from `seed` through numpy's SeedSequence."""
    seeds = [int(s.generate_state(1, np.uint64)[0])
             for s in np.random.SeedSequence(seed).spawn(count)]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def unit_image(img, device):
    """A frame as a float32 tensor in [0, 1] (uint8 frames divided by 255)."""
    t = as_device_tensor(img, device)
    return (t.to(torch.float32) / 255.0 if t.dtype == torch.uint8
            else t.to(torch.float32))


def compute_flow(pair: PairData, use_deep_flow: bool = False,
                 dtype=torch.float32, flow_cfg=None, device=None):
    """Dense flow of a pair: the ground-truth reprojection flow or the
    dense estimate (src/errorMeasure.cpp:48-55).  flow_cfg: optional
    DenseFlowConfig of the dense path.  The dense estimate runs in
    float32 (its kernels') and is returned in `dtype`."""
    if use_deep_flow:
        from rs_sfm_tpu_torch.flow.dense import DenseFlowConfig, dense_flow

        i1 = unit_image(pair.frame1.rs_image, device)
        i2 = unit_image(pair.frame2.rs_image, i1.device)
        return dense_flow(i1, i2, flow_cfg or DenseFlowConfig()).to(dtype)
    if pair.frame1.rs_unproject is None:
        raise ValueError("ground-truth flow needs unprojection maps; "
                         "use use_deep_flow=True for real pairs")
    un = as_device_tensor(pair.frame1.rs_unproject, device, dtype)
    dev = un.device
    return true_flow(un, as_device_tensor(pair.frame2.poses_r, dev, dtype),
                     as_device_tensor(pair.frame2.poses_t, dev, dtype),
                     pair.intrinsics)


def pair_true_depth(pair, device, dtype):
    """Frame 1's true depth (true_depth_from_unprojection) on `device`."""
    f1 = pair.frame1
    return true_depth_from_unprojection(
        as_device_tensor(f1.rs_unproject, device, dtype),
        as_device_tensor(f1.poses_r, device, dtype),
        as_device_tensor(f1.poses_t, device, dtype))


def _runs(pair, cfg, gamma, flow_px, pixel_mask, rs_image, *, seed,
          num_evaluations, sample_indices, dtype):
    """(estimate, back-projection of frame 1 with it) of each evaluation
    in turn: its RANSAC draws from its own generator, or the i-th of
    `sample_indices`."""
    gens = evaluation_generators(seed, num_evaluations, flow_px.device)
    h = flow_px.shape[0]
    for i in range(num_evaluations):
        idx = None if sample_indices is None else sample_indices[i]
        res = estimate_with_feedback(
            flow_px, pair.intrinsics, gamma, cfg,
            gens[i] if idx is None else None, sample_indices=idx,
            pixel_mask=pixel_mask)
        r_sl, t_sl = scanline_poses(res.v, res.w, res.k, h, gamma,
                                    dtype=dtype)
        yield res, backproject(rs_image, res.depth_map, r_sl, t_sl,
                               pair.intrinsics)


def evaluate_velocities_batched(
        pair: PairData, cfg: PipelineConfig, *,
        gamma: Optional[float] = None, num_evaluations: int = 50,
        seed: int = 0, dtype=torch.float32, flow_px=None, true_depth=None,
        pixel_mask=None, sample_indices=None, device=None) -> VelocityErrors:
    """All evaluations of one pair, with the depth-quality columns (the
    JAX package's one-call form; here a loop on the device, one host read
    at the end).

    Pass flow_px / true_depth to skip recomputing them (e.g. an estimated
    flow field with its trusted `pixel_mask`, ~occlusion of
    flow.dense.flow_forward_backward, applied in every evaluation).  A
    uint8 frame-1 image is cast to `dtype` unscaled, as the JAX form does.
    """
    gamma = float(pair.gamma if gamma is None else gamma)
    if flow_px is None:
        flow_px = compute_flow(pair, False, dtype=dtype, device=device)
    flow_px = as_device_tensor(flow_px, device, dtype)
    dev = flow_px.device
    true_depth = (pair_true_depth(pair, dev, dtype) if true_depth is None
                  else as_device_tensor(true_depth, dev, dtype))
    f1 = pair.frame1
    rs_image = as_device_tensor(f1.rs_image, dev, dtype)
    poses_r = as_device_tensor(f1.poses_r, dev, dtype)
    poses_t = as_device_tensor(f1.poses_t, dev, dtype)
    v_true = as_device_tensor(pair.v, dev, dtype)
    w_true = as_device_tensor(pair.w, dev, dtype)
    if pixel_mask is not None:
        pixel_mask = as_device_tensor(pixel_mask, dev)
    rows = []
    for res, rect in _runs(pair, cfg, gamma, flow_px, pixel_mask, rs_image,
                           seed=seed, num_evaluations=num_evaluations,
                           sample_indices=sample_indices, dtype=dtype):
        err3d = mean_reprojection_error(rect.coords_3d, rect.valid,
                                        true_depth, poses_r, poses_t,
                                        pair.intrinsics)[0]
        err3d_ls = mean_reprojection_error(rect.coords_3d, rect.valid,
                                           true_depth, poses_r, poses_t,
                                           pair.intrinsics,
                                           scale_mode="ls")[0]
        drmse = depth_rmse(res.depth_map, true_depth, res.inlier_mask)[0]
        rows.append(torch.cat([t.reshape(-1).to(dtype) for t in (
            res.w, res.v, res.k, rotation_error(res.w, w_true),
            translation_error(res.v, v_true), err3d, res.num_inliers,
            err3d_ls, drmse)]))
    table = torch.stack(rows).cpu().numpy()
    w, v, k = table[:, 0:3].T, table[:, 3:6].T, table[:, 6]
    ew, ev, er = table[:, 7], table[:, 8], table[:, 9]
    return VelocityErrors(
        w=w, v=v, k=k, error_w_vec=ew, error_v_vec=ev,
        error_reproject_vec=er, error_w=float(np.mean(ew)),
        error_v=float(np.mean(ev)), error_reproject=float(np.nanmean(er)),
        num_inliers=table[:, 10].astype(np.int32),
        error_reproject_ls_vec=table[:, 11], depth_rmse_vec=table[:, 12])


def evaluate_velocities(
        pair: PairData, cfg: PipelineConfig, *,
        gamma: Optional[float] = None, num_evaluations: int = 2,
        use_deep_flow: bool = False, seed: int = 0,
        image_path: Optional[str] = None, dtype=torch.float32,
        flow_cfg=None, use_occlusion_mask: bool = False, pixel_mask=None,
        sample_indices=None, device=None) -> VelocityErrors:
    """The evaluateVelocities protocol on one pair.

    Args:
      pair: loaded pair with its GT (v, w from the task dir).
      cfg: pipeline configuration (the reference harness pins tolerance
        0.05, src/errorMeasure.cpp:45; pass it through cfg).
      gamma: readout ratio (default: the pair's GT gamma).
      num_evaluations: repetition count (reference NUM_EVALUATIONS).
      use_deep_flow: dense flow instead of the GT flow.
      seed: seeds the evaluations' generators (evaluation_generators).
      image_path: if given, write each run's depth map and PLY there
        (src/errorMeasure.cpp:199-230).
      flow_cfg: optional DenseFlowConfig of the dense path.
      use_occlusion_mask: with use_deep_flow, forward-backward flow and
        its occluded pixels left out of RANSAC and the refinement.
      pixel_mask: optional (H, W) bool mask of usable pixels, ANDed with
        the occlusion mask if both are given.
      sample_indices: optional (num_evaluations, trials, 9) RANSAC draws.
      device: where arrays go (None = the CUDA device).
    """
    gamma = float(pair.gamma if gamma is None else gamma)
    if use_deep_flow and use_occlusion_mask:
        from rs_sfm_tpu_torch.flow.dense import (DenseFlowConfig,
                                                 flow_forward_backward)

        i1 = unit_image(pair.frame1.rs_image, device)
        i2 = unit_image(pair.frame2.rs_image, i1.device)
        fb = flow_forward_backward(i1, i2, flow_cfg or DenseFlowConfig())
        flow_px = fb.flow.to(dtype)
        occ_free = ~fb.occlusion
        pixel_mask = (occ_free if pixel_mask is None
                      else as_device_tensor(pixel_mask, i1.device) & occ_free)
    else:
        flow_px = compute_flow(pair, use_deep_flow, dtype=dtype,
                               flow_cfg=flow_cfg, device=device)
    dev = flow_px.device
    if pixel_mask is not None:
        pixel_mask = as_device_tensor(pixel_mask, dev)
    v_true = as_device_tensor(pair.v, dev, dtype)
    w_true = as_device_tensor(pair.w, dev, dtype)
    f1 = pair.frame1
    true_depth = None
    if f1.rs_unproject is not None:
        true_depth = pair_true_depth(pair, dev, dtype)
        poses_r = as_device_tensor(f1.poses_r, dev, dtype)
        poses_t = as_device_tensor(f1.poses_t, dev, dtype)
    rs_image = as_device_tensor(f1.rs_image, dev)
    ws, vs, ks, ew, ev, er, ni = [], [], [], [], [], [], []
    runs = _runs(pair, cfg, gamma, flow_px, pixel_mask, rs_image, seed=seed,
                 num_evaluations=num_evaluations,
                 sample_indices=sample_indices, dtype=dtype)
    for run, (res, rect) in enumerate(runs):
        ws.append(to_numpy(res.w))
        vs.append(to_numpy(res.v))
        ks.append(float(res.k))
        ni.append(int(res.num_inliers))
        ew.append(float(rotation_error(res.w, w_true)))
        ev.append(float(translation_error(res.v, v_true)))
        # 3D error of the rectification with the estimate, against GT.
        if true_depth is not None:
            er.append(float(mean_reprojection_error(
                rect.coords_3d, rect.valid, true_depth, poses_r, poses_t,
                pair.intrinsics)[0]))
        else:
            er.append(float("nan"))
        if image_path:
            from rs_sfm_tpu_torch.data.ply import write_ply

            os.makedirs(image_path, exist_ok=True)
            artifacts.imwrite(os.path.join(image_path, f"depth_{run}.png"),
                              artifacts.depth_image(res.depth_map))
            # One point cloud an evaluation (src/errorMeasure.cpp:229-230).
            write_ply(os.path.join(image_path, f"point_cloud_{run}.ply"),
                      rect.coords_3d, f1.rs_image, mask=rect.valid)
    return VelocityErrors(
        w=np.stack(ws, axis=1), v=np.stack(vs, axis=1), k=np.asarray(ks),
        error_w_vec=np.asarray(ew), error_v_vec=np.asarray(ev),
        error_reproject_vec=np.asarray(er), error_w=float(np.mean(ew)),
        error_v=float(np.mean(ev)),
        error_reproject=float(np.nanmean(er)) if er else float("nan"),
        num_inliers=np.asarray(ni))
