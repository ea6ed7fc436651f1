"""Z-buffered back-projection: RS image + depth + scanline poses →
rectified GS image + 3D point cloud (port of
rs_sfm_tpu/rectify/backproject.py).

Per pixel: unproject through the depth map under its scanline pose to
world, reproject under the scanline-0 pose, round (src/rsframe.cc:803-839).
Void pixels (RGB(1,1,1) in uint8, src/rsframe.cc:815) and zero-depth
pixels are skipped.  Conflicts resolve by minimum depth; the engines:

  * "packed24" (default): ONE scatter-min on an int32 key (7-bit quantized
    depth << 24 | 24-bit color); the winning color rides in the key, ties
    at equal quantized depth break toward the smallest packed color;
  * "packed": scatter-min on (quantized depth | source id) and one color
    gather; ties to the lowest id;
  * "scatter": two scatter-min passes on the exact float depth, ties to the
    lowest source id;
  * "sort": a stable sort of (target, quantized depth) keys and a binary
    search, no scatter;
  * "pallas": the z-buffer kernel (ops/kernels/zbuffer.py, csrc/zbuffer.cu
    on the card), exactly the "scatter" engine's result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rs_sfm_tpu_torch.geom.camera import (Intrinsics, pixel_grid,
                                          plane_to_space, space_to_plane,
                                          true_div)
from rs_sfm_tpu_torch.geom.rspose import camera_to_world, world_to_camera
from rs_sfm_tpu_torch.ops.kernels.zbuffer import scatter_resolve, zbuffer_splat

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


def _quantize(src_depth, levels: int):
    """(finite mask, depth quantized to `levels` over the finite span)."""
    finite = torch.isfinite(src_depth)
    dvals = torch.where(finite, src_depth, 0.0)
    dmin = torch.min(torch.where(finite, dvals, torch.inf))
    dmax = torch.max(torch.where(finite, dvals, -torch.inf))
    span = torch.clamp(dmax - dmin, min=1e-12)
    qd = torch.clip(((dvals - dmin) / span * (levels - 1)).to(torch.int32),
                    0, levels - 1)
    return finite, qd


def _resolve_sort(flat_idx, src_depth, colors, n: int, depth_bits: int = 9):
    """Scatter-free min-depth resolution (backproject.py:54-95): a stable
    sort of the (target, quantized depth) keys, then per target a binary
    search for its first key.  Returns (gs_flat (n, 3), hit (n,))."""
    levels = 1 << depth_bits
    finite, qd = _quantize(src_depth, levels)
    key = torch.where(finite & (flat_idx < n), flat_idx * levels + qd,
                      n * levels)
    sorted_key, sorted_src = torch.sort(key, stable=True)
    src_ids = torch.arange(n, dtype=key.dtype, device=key.device)
    pos = torch.searchsorted(sorted_key, src_ids * levels, side="left")
    pos_c = torch.clamp(pos, max=n - 1)
    hit = torch.div(sorted_key[pos_c], levels, rounding_mode="floor") == src_ids
    winner = sorted_src[pos_c]
    gs_flat = torch.where(hit[:, None], colors[winner],
                          torch.zeros_like(colors))
    return gs_flat, hit


def _project(image, depth_map, poses_r, poses_t, intr, use_fy,
             use_scanline_pose):
    """Per source pixel: (valid, world point, target-camera point, target
    (x, y), rounded target column and row, writes)."""
    h, w_cols = depth_map.shape
    grid = pixel_grid(h, w_cols, dtype=depth_map.dtype,
                      device=depth_map.device)
    valid = (depth_map != 0.0) & ~_is_void_color(image)
    cam = plane_to_space(grid, depth_map, intr)  # (H, W, 3)
    if use_scanline_pose:
        r_rows, t_rows = poses_r[:, None, :, :], poses_t[:, None, :]
    else:
        r_rows, t_rows = poses_r[0][None, None], poses_t[0][None, None]
    world = camera_to_world(cam, r_rows, t_rows)
    cam0 = world_to_camera(world, poses_r[0], poses_t[0])
    pt = space_to_plane(cam0, intr, use_fy=use_fy)
    # Rounding as in the reference: int(x + 0.5) (src/rsframe.cc:831).
    px = torch.floor(pt[..., 0] + 0.5).to(torch.int32)
    py = torch.floor(pt[..., 1] + 0.5).to(torch.int32)
    in_bounds = (px >= 0) & (px < w_cols) & (py >= 0) & (py < h)
    write = valid & in_bounds & torch.isfinite(pt).all(dim=-1)
    return valid, world, cam0, pt, px, py, write


def _splat_args(image, cam0, pt, write):
    """The z-buffer kernel's float32 inputs: target x, y and depth of the
    written sources (inf elsewhere) and the colors."""
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=pt.device)
    tx = torch.where(write, pt[..., 0].to(torch.float32), inf)
    ty = torch.where(write, pt[..., 1].to(torch.float32), inf)
    dz = torch.where(write, cam0[..., 2].to(torch.float32), inf)
    return tx, ty, dz, image.to(torch.float32).contiguous()


def splat_inputs(image, depth_map, poses_r, poses_t, intr: Intrinsics, *,
                 use_fy: bool = True, use_scanline_pose: bool = True):
    """(target_x, target_y, depth, colors): what backproject(method=
    "pallas") hands ops.kernels.zbuffer.zbuffer_splat."""
    _, _, cam0, pt, _, _, write = _project(image, depth_map, poses_r,
                                           poses_t, intr, use_fy,
                                           use_scanline_pose)
    return _splat_args(image, cam0, pt, write)


def backproject(image, depth_map, poses_r, poses_t, intr: Intrinsics, *,
                use_fy: bool = True, use_scanline_pose: bool = True,
                method: str = "packed24") -> BackprojectResult:
    """Rectify an RS image given per-pixel depth and per-scanline poses.

    Args:
      image: (H, W, 3) RS image (uint8 or float in [0, 1]).
      depth_map: (H, W) per-pixel depth (0 = unknown, skipped).
      poses_r, poses_t: (H, 3, 3)/(H, 3) relative scanline poses
        (world→camera; scanline 0 is the reprojection target).
      use_fy: False reproduces the reference's f_x-for-y quirk.
      use_scanline_pose: False gives the GS-assumption baseline
        (backProjectGs, src/rsframe.cc:842-878): unproject under the
        scanline-0 pose as well.
      method: the conflict-resolution engine (module docstring).
    """
    h, w_cols = depth_map.shape
    device = depth_map.device
    valid, world, cam0, pt, px, py, write = _project(
        image, depth_map, poses_r, poses_t, intr, use_fy, use_scanline_pose)
    n = h * w_cols
    flat_idx = torch.where(write, py * w_cols + px, n).reshape(-1)
    src_depth = torch.where(write, cam0[..., 2], torch.inf).reshape(-1)
    colors = image.reshape(n, 3)

    if method == "packed24":
        gs_flat, hit = _resolve_packed24(flat_idx, src_depth, colors, n,
                                         image)
    elif method == "packed":
        # One scatter-min on a (quantized depth | source id) int32 key and
        # one color gather; ties to the lowest source id.
        src_bits = (n - 1).bit_length()
        depth_bits = 30 - src_bits
        if depth_bits < 4:
            raise ValueError(f"image too large for packed z-buffer: {n}")
        finite, qd = _quantize(src_depth, 1 << depth_bits)
        src_ids = torch.arange(n, dtype=torch.int32, device=device)
        packed = torch.where(finite & (flat_idx < n),
                             qd * (1 << src_bits) + src_ids, _SENTINEL)
        buf = torch.full((n + 1,), _SENTINEL, dtype=torch.int32,
                         device=device)
        buf.scatter_reduce_(0, flat_idx.to(torch.int64), packed,
                            reduce="amin")
        hit = buf[:n] != _SENTINEL
        winner = torch.where(hit, buf[:n] & ((1 << src_bits) - 1), 0)
        gs_flat = torch.where(hit[:, None], colors[winner.to(torch.int64)],
                              torch.zeros_like(colors))
    elif method == "sort":
        gs_flat, hit = _resolve_sort(flat_idx.to(torch.int64),
                                     src_depth.to(torch.float32), colors, n)
    elif method == "scatter":
        gs_flat, hit = scatter_resolve(flat_idx.to(torch.int64), src_depth,
                                       colors, n)
    elif method == "pallas":
        gs_f, hit = zbuffer_splat(*_splat_args(image, cam0, pt, write))
        gs_flat = (torch.round(gs_f).to(image.dtype)
                   if not image.is_floating_point()
                   else gs_f.to(image.dtype)).reshape(n, 3)
        hit = hit.reshape(n)
    else:
        raise ValueError(f"unknown method {method!r}")
    gs_image = gs_flat.reshape(h, w_cols, 3)
    scattered = hit.reshape(h, w_cols)

    coords_3d = torch.where(valid[..., None], world, torch.zeros_like(world))
    return BackprojectResult(gs_image=gs_image, coords_3d=coords_3d,
                             valid=valid, scattered=scattered)


def _resolve_packed24(flat_idx, src_depth, colors, n: int, image):
    """The packed24 engine: ONE scatter-min on (7-bit quantized depth << 24
    | 24-bit color), gather-free.  Returns (gs_flat (n, 3), hit (n,))."""
    if image.is_floating_point():
        c8 = torch.clip(torch.round(colors * 255.0), 0, 255).to(torch.int32)
    else:
        c8 = colors.to(torch.int32)
    color24 = (c8[:, 0] << 16) | (c8[:, 1] << 8) | c8[:, 2]
    finite, qd = _quantize(src_depth, 1 << 7)
    # qd=127 with pure white packs to exactly the sentinel; clamp live keys
    # to sentinel-1 (perturbs only the blue LSB of that one combination).
    live = finite & (flat_idx < n)
    packed = torch.where(live, torch.clamp((qd << 24) | color24,
                                           max=_SENTINEL - 1), _SENTINEL)
    buf = torch.full((n + 1,), _SENTINEL, dtype=torch.int32,
                     device=src_depth.device)
    buf.scatter_reduce_(0, flat_idx.to(torch.int64), packed, reduce="amin")
    buf = buf[:n]
    hit = buf != _SENTINEL
    win24 = torch.where(hit, buf & 0xFFFFFF, 0)
    c_out = torch.stack([(win24 >> 16) & 0xFF, (win24 >> 8) & 0xFF,
                         win24 & 0xFF], dim=-1)
    if image.is_floating_point():
        return true_div(c_out.to(image.dtype), 255.0), hit
    return c_out.to(image.dtype), hit
