"""Pinhole camera model on dense pixel batches (port of rs_sfm_tpu/geom/camera.py).

Pure functions over (..., 2)/(..., 3) tensors.  `use_fy=False` reproduces
the reference's f_x-for-y projection quirk (src/rsframe.cc:639).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics f_x, f_y, c_x, c_y (a 3x3 K matrix's free entries)."""

    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_matrix(cls, k) -> "Intrinsics":
        """From a 3x3 K matrix (any nested sequence or array)."""
        return cls(fx=float(k[0][0]), fy=float(k[1][1]), cx=float(k[0][2]),
                   cy=float(k[1][2]))

    def matrix(self):
        """The 3x3 K matrix as nested lists of floats."""
        return [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0]]


def true_div(x, value: float):
    """x / value in IEEE division on every device.  On CUDA, PyTorch divides
    by a Python number as a product with its rounded reciprocal, one ulp
    away from the CPU's (and the JAX package's) quotient; a tensor divisor
    keeps the true quotient, so card and CPU round pixels alike."""
    return x / torch.tensor(value, dtype=x.dtype, device=x.device)


def space_to_plane(points, intr: Intrinsics, use_fy: bool = True):
    """Camera-frame 3D points (..., 3) -> pixel coordinates (..., 2)."""
    z = points[..., 2]
    x = points[..., 0] / z
    y = points[..., 1] / z
    fy = intr.fy if use_fy else intr.fx
    return torch.stack([x * intr.fx + intr.cx, y * fy + intr.cy], dim=-1)


def plane_to_space(pixels, z, intr: Intrinsics):
    """Pixel coordinates (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
    x = true_div(pixels[..., 0] - intr.cx, intr.fx)
    y = true_div(pixels[..., 1] - intr.cy, intr.fy)
    ones = torch.ones_like(x)
    return torch.stack([x, y, ones], dim=-1) * z[..., None]


def normalize_coords(pixels, intr: Intrinsics):
    """Pixel coordinates (..., 2) -> normalized image-plane coordinates."""
    x = true_div(pixels[..., 0] - intr.cx, intr.fx)
    y = true_div(pixels[..., 1] - intr.cy, intr.fy)
    return torch.stack([x, y], dim=-1)


def normalize_flow(flow_px, intr: Intrinsics, gamma=None):
    """Pixel flow (..., 2) -> normalized image-plane flow (no γ premultiply
    unless `gamma` is given; see the JAX module's docstring)."""
    scale = 1.0 if gamma is None else gamma
    return torch.stack(
        [true_div(flow_px[..., 0] * scale, intr.fx),
         true_div(flow_px[..., 1] * scale, intr.fy)],
        dim=-1)


def pixel_grid(rows: int, cols: int, dtype=torch.float32, device=None):
    """(rows, cols, 2) tensor of (x=col, y=row) pixel coordinates."""
    ys, xs = torch.meshgrid(
        torch.arange(rows, dtype=dtype, device=device),
        torch.arange(cols, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)
