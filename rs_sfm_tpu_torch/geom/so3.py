"""so(3) helpers: hat / vee maps and the first-order exponential
(port of rs_sfm_tpu/geom/so3.py).  All functions broadcast over leading
batch axes."""

from __future__ import annotations

import torch


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix ŵ with ŵ x = w × x."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m):
    """(..., 3, 3) -> (..., 3): inverse of hat, [m(2,1), m(0,2), m(1,0)]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def exp_first_order(w, scale=None):
    """First-order exponential map R ≈ I + scale·ŵ (src/rsframe.cc:794)."""
    m = hat(w)
    if scale is not None:
        m = m * scale[..., None, None]
    return torch.eye(3, dtype=m.dtype, device=m.device) + m


def rot_y(angle):
    """Rotation about +Y by `angle` (radians); broadcasts over batch."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(
        [
            torch.stack([c, zero, s], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-s, zero, c], dim=-1),
        ],
        dim=-2,
    )
