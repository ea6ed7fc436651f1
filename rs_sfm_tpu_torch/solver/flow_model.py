"""Differential RS flow model u = β(k)·(A(x)·v·ρ + B(x)·w) (port of
rs_sfm_tpu/solver/flow_model.py; report eq. 5-12).

  A = [[1, 0, -x],            B = [[-x·y, 1+x², -y],
       [0, 1, -y]]                 [-(1+y²), x·y,  x]]
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.solver.beta import beta_factor


def flow_basis(coords):
    """(a, b), each (..., 2, 3): a @ v = A v and b @ w = B w."""
    x, y = coords[..., 0], coords[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    a = torch.stack(
        [torch.stack([one, zero, -x], dim=-1),
         torch.stack([zero, one, -y], dim=-1)], dim=-2)
    b = torch.stack(
        [torch.stack([-x * y, 1.0 + x * x, -y], dim=-1),
         torch.stack([-(1.0 + y * y), x * y, x], dim=-1)], dim=-2)
    return a, b


def translational_flow(coords, v):
    """A(x)·v (..., 2): image motion per unit inverse depth."""
    x, y = coords[..., 0], coords[..., 1]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([vx - x * vz, vy - y * vz], dim=-1)


def rotational_flow(coords, w):
    """B(x)·w (..., 2): rotation-induced image motion."""
    x, y = coords[..., 0], coords[..., 1]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [-x * y * wx + (1.0 + x * x) * wy - y * wz,
         -(1.0 + y * y) * wx + x * y * wy + x * wz], dim=-1)


def predict_flow(coords, inv_depth, v, w, k, alpha, alpha_k):
    """u_est = β(k)·(A·v·ρ + B·w) (src/minimal.cc:259-266)."""
    beta = beta_factor(alpha, alpha_k, k)
    trans = translational_flow(coords, v)
    rot = rotational_flow(coords, w)
    return beta[..., None] * (trans * inv_depth[..., None] + rot)


def flow_residual(coords, flow, inv_depth, v, w, k, alpha, alpha_k):
    """r = u_observed − u_est (src/nonlinearRefinement.cc:48-49)."""
    return flow - predict_flow(coords, inv_depth, v, w, k, alpha, alpha_k)
