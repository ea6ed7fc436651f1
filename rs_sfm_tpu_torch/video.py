"""Frame sequences: per-pair estimation with per-pair fault isolation
(port of rs_sfm_tpu/video.py).

A T-frame sequence is T-1 consecutive pairs: dense flow for each pair,
then the estimation on each flow.  The JAX package maps and vmaps over the
pairs; here a loop runs each pair through the same entry points as a
single pair (dense flow on B4-B6, the estimation on B1-B3), one after the
other on one card.

Fault isolation: a degenerate pair (no texture, zero flow, a broken frame)
must not poison the sequence.  Every pair carries an `ok` flag (finite v,
w and k, and at least `min_inliers` inliers); a pair that is not ok has
its motion, k and depth zeroed, and the trajectory holds its pose there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.flow.dense import as_device_tensor, dense_flow
from rs_sfm_tpu_torch.geom import so3
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver import pipeline


class VideoResult(NamedTuple):
    v: torch.Tensor            # (P, 3) per-pair linear velocity
    w: torch.Tensor            # (P, 3)
    k: torch.Tensor            # (P,)
    depth_maps: torch.Tensor   # (P, H, W)
    num_inliers: torch.Tensor  # (P,)
    ok: torch.Tensor           # (P,) bool: the pair gave a usable estimate


def pair_flows_dense(frames, flow_cfg: Optional[DenseFlowConfig] = None):
    """Dense flow of every consecutive pair of (T, H, W[, 3]) frames
    (a tensor stays on its device; an array goes to the CUDA device);
    returns (T-1, H, W, 2)."""
    cfg = flow_cfg or DenseFlowConfig()
    frames = as_device_tensor(frames, dtype=torch.float32)
    return torch.stack([dense_flow(frames[i], frames[i + 1], cfg)
                        for i in range(frames.shape[0] - 1)])


def estimate_video(flows, intr: Intrinsics, gamma, cfg: PipelineConfig,
                   generator: Optional[torch.Generator] = None, *,
                   sample_indices=None, min_inliers: int = 32) -> VideoResult:
    """Estimation on each of (P, H, W, 2) per-pair flows.

    Pair i runs `estimate_from_flow` with its own generator,
    pipeline.fold_generator(generator, i) (the JAX package splits its key
    into one a pair), or with sample_indices[i] when (P, trials, 9) draws
    are given (the tests hand over the JAX package's).
    """
    flows = as_device_tensor(flows, dtype=torch.float32)
    res = [pipeline.estimate_from_flow(
        flows[i], intr, gamma, cfg, pipeline.fold_generator(generator, i),
        sample_indices=None if sample_indices is None else sample_indices[i])
        for i in range(flows.shape[0])]
    v = torch.stack([r.v for r in res])
    w = torch.stack([r.w for r in res])
    k = torch.stack([r.k for r in res])
    depth = torch.stack([r.depth_map for r in res])
    num = torch.stack([r.num_inliers for r in res])
    ok = (torch.isfinite(v).all(dim=-1) & torch.isfinite(w).all(dim=-1)
          & torch.isfinite(k) & (num >= min_inliers))
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return VideoResult(v=torch.where(ok[:, None], v, zero),
                       w=torch.where(ok[:, None], w, zero),
                       k=torch.where(ok, k, zero),
                       depth_maps=torch.where(ok[:, None, None], depth, zero),
                       num_inliers=num, ok=ok)


def accumulate_trajectory(video: VideoResult, gamma, rows: int):
    """Chain the per-pair motions into a camera trajectory (first-order
    composition, constant velocity a pair): R_{i+1} = exp(ŵ_i) R_i,
    t_{i+1} = exp(ŵ_i) t_i + v_i, frame 0 at the identity.  A pair that
    is not ok contributes the identity (the pose holds).

    Returns (R (P+1, 3, 3), t (P+1, 3)), world->camera poses of each
    frame's scanline 0."""
    v = torch.as_tensor(video.v)
    w = torch.as_tensor(video.w, device=v.device)
    ok = torch.as_tensor(video.ok, device=v.device)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    rs = [eye]
    ts = [torch.zeros(3, dtype=v.dtype, device=v.device)]
    for i in range(v.shape[0]):
        dr = torch.where(ok[i], so3.exp_first_order(w[i]), eye)
        dv = torch.where(ok[i], v[i], torch.zeros_like(v[i]))
        rs.append(dr @ rs[-1])
        ts.append(dr @ ts[-1] + dv)
    return torch.stack(rs), torch.stack(ts)
