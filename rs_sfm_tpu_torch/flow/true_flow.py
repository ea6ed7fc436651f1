"""Ground-truth flow from unprojection maps and per-scanline poses (port of
rs_sfm_tpu/flow/true_flow.py; Camera::calculateTrueFlow,
src/camera.cc:209-249).

For every pixel of frame 1, project its ground-truth world point into
frame 2 under every scanline pose and keep the scanline whose projected y
best matches its own index (the implicit RS projection).  The JAX version
scans the H scanlines with all pixels projected at once; here a Python
loop over the rows does the same, keeping the running best per pixel, so
ties go to the first row as there.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.geom.camera import Intrinsics, pixel_grid, space_to_plane


def true_flow(unproj1, poses2_r, poses2_t, intr: Intrinsics,
              use_fy: bool = True, subscanline: bool = True):
    """Exact RS->RS flow field (H, W, 2) in pixels.

    Args:
      unproj1: (H, W, 3) frame-1 unprojection map (world coords; 0-norm
        rows mark void pixels).
      poses2_r, poses2_t: (H, 3, 3), (H, 3) frame-2 per-scanline
        world->camera poses.
      intr: pinhole intrinsics.
      use_fy: False reproduces the reference's f_x-for-y quirk.
      subscanline: interpolate the observation between the two scanlines
        that bracket the crossing y_proj(i) = i (first order in the
        scanline interval); False keeps the reference's discrete best
        scanline.

    Void pixels, pixels whose best projection lands exactly at (0, 0), and
    pixels with no finite projection get zero flow (src/camera.cc:231-240).
    """
    h, w_cols = unproj1.shape[:2]
    dtype = unproj1.dtype
    dev = unproj1.device
    grid = pixel_grid(h, w_cols, dtype=dtype, device=dev)
    points = unproj1.reshape(-1, 3)

    def project(i):
        cam = points @ poses2_r[i].transpose(0, 1) + poses2_t[i]
        return space_to_plane(cam.reshape(h, w_cols, 3), intr, use_fy=use_fy)

    # First pass: the best (discrete) scanline per pixel.
    best_diff = torch.full((h, w_cols), torch.inf, dtype=dtype, device=dev)
    best_pt = torch.zeros((h, w_cols, 2), dtype=dtype, device=dev)
    best_g = torch.zeros((h, w_cols), dtype=dtype, device=dev)
    best_row = torch.full((h, w_cols), -1.0, dtype=dtype, device=dev)
    for i in range(h):
        pt = project(i)
        g = pt[..., 1] - i  # signed crossing residual
        diff = torch.abs(g)
        diff = torch.where(torch.isfinite(diff), diff, torch.inf)
        closer = diff < best_diff
        best_pt = torch.where(closer[..., None], pt, best_pt)
        best_g = torch.where(closer, g, best_g)
        best_diff = torch.where(closer, diff, best_diff)
        best_row = torch.where(closer, float(i), best_row)

    if subscanline:
        # Second pass: the neighbour scanline on the crossing side, and pt
        # interpolated linearly in scanline time: g(i) = y_proj(i) − i is
        # locally affine, so the crossing sits at i* + τ with
        # τ = g(i*) / (g(i*) − g(i_nb)).
        side = torch.where(best_g > 0.0, 1.0, -1.0).to(dtype)
        nb_row = torch.clamp(best_row + side, 0.0, h - 1.0)
        nb_idx = nb_row.to(torch.int32)
        nb_pt = torch.zeros((h, w_cols, 2), dtype=dtype, device=dev)
        nb_g = torch.zeros((h, w_cols), dtype=dtype, device=dev)
        for i in range(h):
            pt = project(i)
            hit = nb_idx == i
            nb_pt = torch.where(hit[..., None], pt, nb_pt)
            nb_g = torch.where(hit, pt[..., 1] - i, nb_g)
        denom = best_g - nb_g
        tau = torch.where(torch.abs(denom) > 1e-12, best_g / denom,
                          torch.zeros_like(denom))
        # Interpolate only where the neighbour brackets the crossing (the
        # signs of g differ) and exists (not clipped onto the row itself).
        ok = ((torch.sign(nb_g) != torch.sign(best_g)) & (nb_row != best_row)
              & torch.isfinite(nb_g) & torch.isfinite(best_g))
        tau = torch.where(ok, torch.clamp(tau, 0.0, 1.0),
                          torch.zeros_like(tau))
        best_pt = best_pt + tau[..., None] * (nb_pt - best_pt)

    flow = best_pt - grid
    void = torch.linalg.vector_norm(unproj1, dim=-1) == 0.0
    degenerate = torch.linalg.vector_norm(best_pt, dim=-1) == 0.0
    zero = void | degenerate | ~torch.isfinite(best_diff)
    return torch.where(zero[..., None], torch.zeros_like(flow), flow)
