"""Flow self-checks: warp-based reconstruction error (port of
rs_sfm_tpu/flow/check.py).

The reference's testFlow (src/main.cc:563-609) forward-warps frame-1 pixels
by the rounded flow and shows the difference to frame 2; its
reconstructImageFromFlow (src/camera.cc:842-865) does the same warp.  Here
the check is a number: frame 2 backward-warped by the flow (the warp kernel
B4 on the card, its plain version on the CPU), against frame 1.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.ops.kernels import warp as kwarp


def reconstruct_from_flow(image2, flow_px):
    """Backward-warp image2 (H, W[, C]) by the flow (bilinear, edge
    clamped): the prediction of image1, in float32."""
    flow = flow_px.to(torch.float32)
    img = image2.to(torch.float32)
    if img.dim() == 3:
        return kwarp.warp(img.permute(2, 0, 1).contiguous(),
                          flow).permute(1, 2, 0)
    return kwarp.warp(img.contiguous(), flow)


def flow_consistency_error(image1, image2, flow_px, mask=None):
    """Mean absolute photometric error of the flow-warped reconstruction.

    Args:
      image1, image2: (H, W[, 3]) float images in [0, 1].
      flow_px: (H, W, 2) pixel flow from frame 1 to frame 2.
      mask: optional (H, W) bool region of interest.

    Returns the scalar mean |warp(image2, flow) − image1| over the mask
    (float32).
    """
    rec = reconstruct_from_flow(image2, flow_px)
    err = torch.abs(rec - image1.to(torch.float32))
    if err.dim() == 3:
        err = err.mean(dim=-1)
    if mask is None:
        return err.mean()
    m = mask.to(err.dtype)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
