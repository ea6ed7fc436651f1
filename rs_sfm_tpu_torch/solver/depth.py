"""Per-pixel inverse depth in closed form (port of rs_sfm_tpu/solver/depth.py).

The residual r(ρ) = u − β(A·v·ρ + B·w) is linear in ρ, so the
least-squares optimum is ρ* = ⟨g, u − β·B·w⟩ / ⟨g, g⟩ with g = β·A·v.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.solver.beta import beta_factor
from rs_sfm_tpu_torch.solver.flow_model import (rotational_flow,
                                                translational_flow)


def estimate_inverse_depth(coords, flow, v, w, k, alpha, alpha_k):
    """Closed-form least-squares inverse depth per pixel; 0 where
    ‖β·A·v‖ = 0 (the pixel carries no depth information)."""
    rho, _ = estimate_inverse_depth_info(coords, flow, v, w, k, alpha, alpha_k)
    return rho


def estimate_inverse_depth_info(coords, flow, v, w, k, alpha, alpha_k):
    """Like estimate_inverse_depth, but also returns the informative mask."""
    beta = beta_factor(alpha, alpha_k, k)
    g = beta[..., None] * translational_flow(coords, v)
    rhs = flow - beta[..., None] * rotational_flow(coords, w)
    gg = torch.sum(g * g, dim=-1)
    gr = torch.sum(g * rhs, dim=-1)
    informative = gg != 0.0
    safe = torch.where(informative, gg, torch.ones_like(gg))
    return torch.where(informative, gr / safe, torch.zeros_like(gr)), informative
