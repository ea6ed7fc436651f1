"""Error metrics with the reference's evaluation semantics (port of
rs_sfm_tpu/eval/metrics.py).

  rotation_error           ‖vee(R_est·R_gtᵀ)‖ with R = I + ŵ small-angle
                           matrices (src/errorMeasure.cpp:179-184)
  translation_error        acos(v·v_gt / ‖v‖‖v_gt‖) (src/errorMeasure.cpp:186)
  mean_reprojection_error  scale-aligned mean 3D distance with the
                           reference's outlier rules (src/camera.cc:593-691)
  depth_rmse               scale-aligned depth RMSE
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.geom import so3
from rs_sfm_tpu_torch.geom.camera import Intrinsics, pixel_grid, plane_to_space
from rs_sfm_tpu_torch.geom.rspose import camera_to_world, relocate_poses


def _nonzero(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def rotation_error(w_est, w_true):
    """‖vee(R_est·R_trueᵀ)‖ with first-order rotation matrices, their
    product included as the reference computes it
    (src/errorMeasure.cpp:125-131,179-184)."""
    w_true = torch.as_tensor(w_true, dtype=w_est.dtype, device=w_est.device)
    eye = torch.eye(3, dtype=w_est.dtype, device=w_est.device)
    r_est = eye + so3.hat(w_est)
    r_true = eye + so3.hat(w_true)
    err = torch.einsum("...ij,...kj->...ik", r_est, r_true)
    return torch.linalg.vector_norm(so3.vee(err), dim=-1)


def translation_error(v_est, v_true):
    """Angle between translation directions (src/errorMeasure.cpp:186)."""
    v_true = torch.as_tensor(v_true, dtype=v_est.dtype, device=v_est.device)
    num = torch.einsum("...i,...i->...", v_est, v_true)
    den = (torch.linalg.vector_norm(v_est, dim=-1)
           * torch.linalg.vector_norm(v_true, dim=-1))
    return torch.arccos(torch.clamp(num / _nonzero(den), -1.0, 1.0))


def mean_reprojection_error(est_coords_3d, est_valid, true_depth, poses_r,
                            poses_t, intr: Intrinsics, *,
                            scale_outlier: float = 10.0,
                            dist_cap: float = 50.0,
                            relocate_skip_first_row: bool = False,
                            scale_mode: str = "ratio-mean"):
    """Scale-aligned mean 3D error (Camera::meanReprojectionError).

    Args:
      est_coords_3d: (H, W, 3) estimated world points (backproject's
        coords_3d; zeros where invalid); est_valid: (H, W) bool.
      true_depth: (H, W) ground-truth depth (camera z per pixel).
      poses_r, poses_t: (H, 3, 3), (H, 3) absolute GT scanline poses of
        the frame, relocated here as the reference does (src/camera.cc:610).
      scale_outlier: per-axis |est/true| ratio beyond which an entry leaves
        the mean scale (src/camera.cc:633-646).
      dist_cap: 3D distances >= this leave the mean (src/camera.cc:680).
      relocate_skip_first_row: the reference's relocatePose quirk.
      scale_mode: "ratio-mean" (the reference's mean of per-axis ratios)
        or "ls" (s* = Σ⟨e, t⟩ / Σ⟨t, t⟩ over the same entries).

    Returns (mean error, scale, true world points (H, W, 3)).
    """
    h, w_cols = true_depth.shape
    rel_r, rel_t = relocate_poses(poses_r, poses_t,
                                  skip_first_row=relocate_skip_first_row)
    grid = pixel_grid(h, w_cols, dtype=true_depth.dtype,
                      device=true_depth.device)
    cam = plane_to_space(grid, true_depth, intr)
    true_3d = camera_to_world(cam, rel_r[:, None], rel_t[:, None])

    # Per-axis scales est/true; entries that are 0, non-finite or beyond
    # the outlier ratio leave the mean scale (src/camera.cc:629-662).
    ratios = est_coords_3d / true_3d
    ok = (torch.isfinite(ratios) & (ratios != 0.0)
          & (torch.abs(ratios) <= scale_outlier) & est_valid[..., None])
    zero = torch.zeros_like(ratios)
    if scale_mode == "ls":
        num = torch.sum(torch.where(ok, est_coords_3d * true_3d, zero))
        den = torch.sum(torch.where(ok, true_3d * true_3d, zero))
        scale = num / _nonzero(den)
    elif scale_mode == "ratio-mean":
        scale = (torch.sum(torch.where(ok, ratios, zero))
                 / torch.clamp(torch.sum(ok), min=1))
    else:
        raise ValueError(f"unknown scale_mode {scale_mode!r}")

    dist = torch.linalg.vector_norm(est_coords_3d / _nonzero(scale)
                                    - true_3d, dim=-1)
    use = (torch.isfinite(dist) & (dist < dist_cap) & est_valid
           & torch.all(torch.isfinite(true_3d), dim=-1))
    n_used = torch.clamp(torch.sum(use), min=1)
    mean_err = torch.sum(torch.where(use, dist, torch.zeros_like(dist)))
    return mean_err / n_used, scale, true_3d


def depth_rmse(depth_est, true_depth, mask, *, scale_mode: str = "ls"):
    """Scale-aligned depth RMSE: the estimate's gauge scale s is fitted to
    the truth over the mask, "ls" (s* = Σ Z_est·Z_true / Σ Z_est²) or
    "median" (median of Z_true / Z_est).

    Returns (RMSE of s·Z_est − Z_true over the mask, s).
    """
    m = (mask & (depth_est != 0.0) & torch.isfinite(depth_est)
         & torch.isfinite(true_depth) & (true_depth > 0.0))
    zero = torch.zeros_like(depth_est)
    if scale_mode == "ls":
        num = torch.sum(torch.where(m, depth_est * true_depth, zero))
        den = torch.sum(torch.where(m, depth_est * depth_est, zero))
        s = num / _nonzero(den)
    elif scale_mode == "median":
        r = torch.where(m, true_depth / _nonzero(depth_est),
                        torch.full_like(depth_est, torch.nan))
        # numpy's median: the mean of the two middle values.
        s = torch.nanquantile(r.reshape(-1), 0.5)
    else:
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    d = s * depth_est - true_depth
    n = torch.clamp(torch.sum(m), min=1)
    return torch.sqrt(torch.sum(torch.where(m, d * d, zero)) / n), s
