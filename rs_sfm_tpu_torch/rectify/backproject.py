"""Z-buffered back-projection: RS image + depth + scanline poses →
rectified GS image + 3D point cloud (port of
rs_sfm_tpu/rectify/backproject.py:97-180,253-255, the "packed24" engine).

Per pixel: unproject through the depth map under its scanline pose to
world, reproject under the scanline-0 pose, round (src/rsframe.cc:803-839).
Conflicts resolve by minimum depth with ONE scatter-min on an int32 key
(7-bit quantized depth << 24 | 24-bit color): the winning color rides in
the key, ties at equal quantized depth break toward the smallest packed
color.  Void pixels (RGB(1,1,1) in uint8, src/rsframe.cc:815) and
zero-depth pixels are skipped.  The "packed", "sort", "scatter" and
z-buffer-kernel engines are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rs_sfm_tpu_torch.geom.camera import (Intrinsics, pixel_grid,
                                          plane_to_space, space_to_plane,
                                          true_div)
from rs_sfm_tpu_torch.geom.rspose import camera_to_world, world_to_camera

_SENTINEL = 2 ** 31 - 1


class BackprojectResult(NamedTuple):
    gs_image: torch.Tensor   # (H, W, 3) rectified global-shutter image
    coords_3d: torch.Tensor  # (H, W, 3) world coords per source RS pixel
    valid: torch.Tensor      # (H, W) bool — source pixels that back-projected
    scattered: torch.Tensor  # (H, W) bool — target pixels that got a color


def _is_void_color(image):
    """Color exactly RGB(1,1,1) in uint8 (uint8 or unit-float images)."""
    if image.is_floating_point():
        return torch.all(torch.abs(image * 255.0 - 1.0) < 0.5, dim=-1)
    return torch.all(image == 1, dim=-1)


def backproject(image, depth_map, poses_r, poses_t,
                intr: Intrinsics) -> BackprojectResult:
    """Rectify an RS image given per-pixel depth and per-scanline poses.

    Args:
      image: (H, W, 3) RS image (uint8 or float in [0, 1]).
      depth_map: (H, W) per-pixel depth (0 = unknown, skipped).
      poses_r, poses_t: (H, 3, 3)/(H, 3) relative scanline poses
        (world→camera; scanline 0 is the reprojection target).
    """
    h, w_cols = depth_map.shape
    device = depth_map.device
    grid = pixel_grid(h, w_cols, dtype=depth_map.dtype, device=device)
    valid = (depth_map != 0.0) & ~_is_void_color(image)

    cam = plane_to_space(grid, depth_map, intr)  # (H, W, 3)
    world = camera_to_world(cam, poses_r[:, None, :, :], poses_t[:, None, :])
    cam0 = world_to_camera(world, poses_r[0], poses_t[0])
    pt = space_to_plane(cam0, intr)

    # Rounding as in the reference: int(x + 0.5) (src/rsframe.cc:831).
    px = torch.floor(pt[..., 0] + 0.5).to(torch.int32)
    py = torch.floor(pt[..., 1] + 0.5).to(torch.int32)
    in_bounds = (px >= 0) & (px < w_cols) & (py >= 0) & (py < h)
    write = valid & in_bounds & torch.isfinite(pt).all(dim=-1)

    n = h * w_cols
    flat_idx = torch.where(write, py * w_cols + px, n).reshape(-1)
    src_depth = torch.where(write, cam0[..., 2], torch.inf).reshape(-1)
    colors = image.reshape(n, 3)

    if image.is_floating_point():
        c8 = torch.clip(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    else:
        c8 = colors.to(torch.int32)
    color24 = (c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]
    levels = 1 << 7
    finite = torch.isfinite(src_depth)
    dvals = torch.where(finite, src_depth, 0.0)
    dmin = torch.min(torch.where(finite, dvals, torch.inf))
    dmax = torch.max(torch.where(finite, dvals, -torch.inf))
    span = torch.clamp(dmax - dmin, min=1e-12)
    qd = torch.clip(((dvals - dmin) / span * (levels - 1)).to(torch.int32),
                    0, levels - 1)
    # qd=127 with pure white packs to exactly the sentinel; clamp live keys
    # to sentinel-1 (perturbs only the blue LSB of that one combination).
    live = finite & (flat_idx < n)
    packed = torch.where(live, torch.clamp((qd << 24) | color24,
                                           max=_SENTINEL - 1), _SENTINEL)
    buf = torch.full((n + 1,), _SENTINEL, dtype=torch.int32, device=device)
    buf.scatter_reduce_(0, flat_idx.to(torch.int64), packed, reduce="amin")
    buf = buf[:n]
    hit = buf != _SENTINEL
    win24 = torch.where(hit, buf & 0xFFFFFF, 0)
    c_out = torch.stack([(win24 >> 16) & 0xFF, (win24 >> 8) & 0xFF,
                         win24 & 0xFF], dim=-1)
    if image.is_floating_point():
        gs_image = true_div(c_out.to(image.dtype), 255.0).reshape(h, w_cols, 3)
    else:
        gs_image = c_out.to(image.dtype).reshape(h, w_cols, 3)
    scattered = hit.reshape(h, w_cols)

    coords_3d = torch.where(valid[..., None], world, torch.zeros_like(world))
    return BackprojectResult(gs_image=gs_image, coords_3d=coords_3d,
                             valid=valid, scattered=scattered)
