"""Ground truth of a synthetic frame (port of
rs_sfm_tpu/data/dataset.py::true_depth_from_unprojection; the dataset
readers are not ported)."""

from __future__ import annotations

import torch


def true_depth_from_unprojection(unproj, poses_r, poses_t):
    """GT depth map: camera z of each unprojection point under its scanline
    pose (RsFrame::setSyntheticDepthMapRs, src/rsframe.cc:565-615).

    unproj (H, W, 3) world points (0 = void), poses_r (H, 3, 3), poses_t
    (H, 3) world->camera per scanline; returns (H, W), 0 on void pixels.
    """
    r2 = poses_r[:, None, 2, :]  # (H, 1, 3): the z row of each scanline
    cam_z = (r2[..., 0] * unproj[..., 0] + r2[..., 1] * unproj[..., 1]
             + r2[..., 2] * unproj[..., 2]) + poses_t[:, None, 2]
    hit = torch.linalg.vector_norm(unproj, dim=-1) > 0
    return torch.where(hit, cam_z, torch.zeros_like(cam_z))
