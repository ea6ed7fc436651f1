"""Small-motion flow-based warping, the reference's alternative
rectification (port of rs_sfm_tpu/rectify/warp.py;
RsFrame::smallMotionWrapping, src/rsframe.cc:881-949).

Instead of back-projecting through the depth map, each pixel is shifted by
the model-predicted flow u = β₁(i)·(A·v/Z + B·w), rounded to whole pixels.
Conflicts resolve like backproject's "scatter" engine (minimum depth, ties
to the lowest source id).
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.geom.camera import (Intrinsics, normalize_coords,
                                          pixel_grid)
from rs_sfm_tpu_torch.geom.rspose import beta1
from rs_sfm_tpu_torch.ops.kernels.zbuffer import scatter_resolve
from rs_sfm_tpu_torch.rectify.backproject import (BackprojectResult,
                                                  _is_void_color)
from rs_sfm_tpu_torch.solver.flow_model import (rotational_flow,
                                                translational_flow)


def small_motion_warp(image, depth_map, v, w, k, gamma,
                      intr: Intrinsics) -> BackprojectResult:
    """Warp the RS image to scanline-0 time by the differential flow model:
    per pixel at row i, displacement −β₁(i)·(A·v/Z + B·w) in normalized
    units scaled to pixels, nearest-integer target.  coords_3d is zeros
    (this path makes no 3D points)."""
    h, w_cols = depth_map.shape
    dtype = depth_map.dtype
    device = depth_map.device
    grid = pixel_grid(h, w_cols, dtype=dtype, device=device)
    coords = normalize_coords(grid, intr)
    b1 = beta1(grid[..., 1], h, gamma, k)

    safe_z = torch.where(depth_map == 0.0, torch.ones_like(depth_map),
                         depth_map)
    rho = torch.where(depth_map == 0.0, torch.zeros_like(depth_map),
                      1.0 / safe_z)
    v = torch.as_tensor(v, device=device).to(dtype)
    w = torch.as_tensor(w, device=device).to(dtype)
    u = (translational_flow(coords, v) * rho[..., None]
         + rotational_flow(coords, w)) * b1[..., None]
    du = -u * torch.tensor([intr.fx, intr.fy], dtype=dtype, device=device)

    valid = (depth_map != 0.0) & ~_is_void_color(image)
    px = torch.floor(grid[..., 0] + du[..., 0] + 0.5).to(torch.int32)
    py = torch.floor(grid[..., 1] + du[..., 1] + 0.5).to(torch.int32)
    in_bounds = (px >= 0) & (px < w_cols) & (py >= 0) & (py < h)
    write = valid & in_bounds

    n = h * w_cols
    flat_idx = torch.where(write, py * w_cols + px, n).reshape(-1)
    src_depth = torch.where(write, depth_map, torch.inf).reshape(-1)
    gs_flat, hit = scatter_resolve(flat_idx.to(torch.int64), src_depth,
                                   image.reshape(n, 3), n)
    return BackprojectResult(
        gs_image=gs_flat.reshape(h, w_cols, 3),
        coords_3d=torch.zeros((h, w_cols, 3), dtype=dtype, device=device),
        valid=valid, scattered=hit.reshape(h, w_cols))
