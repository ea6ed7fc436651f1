"""Geometry self-diagnostics (port of rs_sfm_tpu/geom/diagnostics.py).

Camera::testProjection (reference src/camera.cc:374-408) round-trips every
pixel through the five transforms and prints them; here it is a number a
test can hold.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.geom.camera import (Intrinsics, pixel_grid,
                                          plane_to_space, space_to_plane)
from rs_sfm_tpu_torch.geom.rspose import camera_to_world, world_to_camera


def projection_roundtrip_error(rows: int, cols: int, intr: Intrinsics,
                               poses_r, poses_t, depth=None,
                               dtype=torch.float64):
    """Max pixel error of plane → space → world → camera → plane under each
    scanline's pose (poses_r (rows, 3, 3), poses_t (rows, 3)), at depth 5
    or the given (rows, cols) depth: ~1e-9 for exactly invertible poses,
    growing with the non-orthogonality of first-order rotations."""
    dev = poses_r.device
    grid = pixel_grid(rows, cols, dtype=dtype, device=dev)
    z = (torch.full((rows, cols), 5.0, dtype=dtype, device=dev)
         if depth is None else torch.as_tensor(depth, device=dev).to(dtype))
    cam = plane_to_space(grid, z, intr)
    r, t = poses_r.to(dtype)[:, None], poses_t.to(dtype)[:, None]
    px = space_to_plane(world_to_camera(camera_to_world(cam, r, t), r, t),
                        intr)
    diff = px - grid
    return torch.max(torch.sqrt(torch.sum(diff * diff, dim=-1)))
