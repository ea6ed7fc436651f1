"""Crack filling for scatter-rectified images (port of
rs_sfm_tpu/rectify/crackfill.py; reference Camera::interpolateCrackyImage,
src/camera.cc:753-774).

Black pixels (‖RGB‖ ≤ threshold) inside a "colorful area" -- with non-black
4-neighbors at distance `offset` -- take the average of those non-black
neighbors.  Stencil ops only (rolls and selects).
"""

from __future__ import annotations

import torch


def fill_cracks(image, offset: int = 1, black_threshold: float = 15.0,
                require_all_neighbors: bool = True):
    """Fill scatter cracks by neighbor averaging.

    Args:
      image: (H, W, 3) uint8 or float image (float treated as [0, 1]).
      offset: neighbor distance (the reference calls offsets 1 then 2).
      black_threshold: ‖RGB‖ (uint8 scale) at or below which a pixel is
        "black" (src/camera.cc:700).
      require_all_neighbors: the reference's isColorfulArea demands all
        four neighbors non-black (src/camera.cc:703-711); False relaxes it
        to at least one.

    Returns:
      The image, same dtype, with cracks filled.
    """
    int_input = not image.is_floating_point()
    img = image.to(torch.float32)
    scale = 1.0 if int_input else 255.0
    sq = torch.sum((img * scale) ** 2, dim=-1)
    # The root in float64: PyTorch's float32 sqrt on the CPU is not
    # correctly rounded, and the threshold test must see JAX's value.
    norm = torch.sqrt(sq.to(torch.float64)).to(torch.float32)
    is_black = norm <= black_threshold

    neigh_sum = torch.zeros_like(img)
    neigh_cnt = torch.zeros(img.shape[:2], dtype=torch.float32,
                            device=img.device)
    all_colorful = torch.ones(img.shape[:2], dtype=torch.bool,
                              device=img.device)
    for dy, dx in ((-offset, 0), (offset, 0), (0, -offset), (0, offset)):
        sh = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
        sh_black = torch.roll(is_black, shifts=(dy, dx), dims=(0, 1))
        neigh_sum = neigh_sum + torch.where(sh_black[..., None], 0.0, sh)
        neigh_cnt = neigh_cnt + torch.where(sh_black, 0.0, 1.0)
        all_colorful = all_colorful & ~sh_black

    eligible = is_black & (all_colorful if require_all_neighbors
                           else (neigh_cnt > 0))
    avg = neigh_sum / torch.clamp(neigh_cnt, min=1.0)[..., None]
    out = torch.where(eligible[..., None], avg, img)
    return torch.round(out).to(image.dtype) if int_input else out.to(
        image.dtype)
