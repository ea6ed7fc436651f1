"""Rolling-shutter per-scanline pose model (port of rs_sfm_tpu/geom/rspose.py).

Scanline i of the first frame, read at normalized time τ = γ·i/H, has the
relative pose t_i = β₁(i)·v, R_i = I + β₁(i)·ŵ with
β₁ = (2/(2+k))·(τ + ½kτ²) (src/rsframe.cc:771-800).  Poses are
world->camera: X_cam = R X_world + t.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.geom import so3


def beta1(row, rows, gamma, k):
    """β₁ for scanline(s) `row` of the first frame (src/rsframe.cc:790)."""
    tau = gamma * row / rows
    return (2.0 / (2.0 + k)) * (tau + 0.5 * k * tau * tau)


def scanline_poses(v, w, k, rows, gamma, dtype=None):
    """All relative scanline poses (R (rows, 3, 3), t (rows, 3)) of a frame."""
    v = torch.as_tensor(v)
    if dtype is None:
        dtype = v.dtype
    device = v.device
    idx = torch.arange(rows, dtype=dtype, device=device)
    k = torch.as_tensor(k, device=device).to(dtype)
    b = beta1(idx, rows, gamma, k)  # (rows,)
    w = torch.as_tensor(w, device=device).to(dtype)
    r = so3.exp_first_order(w.expand(rows, 3), scale=b)
    t = b[:, None] * v.to(dtype)[None, :]
    return r, t


def _matvec(r, p, transpose: bool):
    """R p (or Rᵀ p) as explicit products summed in index order, so the
    result is the same on every device (no library reduction order)."""
    out = []
    for i in range(3):
        if transpose:
            terms = [r[..., j, i] * p[..., j] for j in range(3)]
        else:
            terms = [r[..., i, j] * p[..., j] for j in range(3)]
        out.append(terms[0] + terms[1] + terms[2])
    return torch.stack(out, dim=-1)


def world_to_camera(points, r, t):
    """X_cam = R X_world + t; broadcasts (..., 3) with (..., 3, 3)/(..., 3)."""
    return _matvec(r, points, transpose=False) + t


def camera_to_world(points, r, t):
    """X_world = Rᵀ (X_cam - t) (src/rsframe.cc:712-736)."""
    return _matvec(r, points - t, transpose=True)
