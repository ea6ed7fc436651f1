"""Deterministic k initialization by a 1-D grid scan (port of
rs_sfm_tpu/solver/kscan.py).

The constant-acceleration model's cost over k has a mirror basin near
k ≈ −1, where β(k) admits a sign-flipped (v, ρ) solution; an LM started
from a noisy RANSAC k̂ can fall into it in float32.  The scan evaluates the
refinement objective itself on a fixed k grid: for each k it alternates the
closed-form per-pixel depth with the exact linear least-squares (v, w)
re-fit (u = β(k)(Aρ·v + B·w) is linear in (v, w) given k and ρ), and hands
the grid point of least cost to the LM.

The grid is walked one point at a time, as the JAX package's `lax.map`
does: a batch over the grid would hold a (K, N, 2, 7) design matrix, 4 GB
in float64 at full HD.  J starts are scanned together along a leading
axis (the JAX package vmaps the scan over them).

Under scanline-block sharding (`group`) each rank holds its block of
pixels; the (J, 7, 7) Gram product of each fit and the masked cost are
summed over the group (one all-reduce each), so every rank solves the same
normal equations and picks the same grid point.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.ops import linalg
from rs_sfm_tpu_torch.parallel.distributed import psum
from rs_sfm_tpu_torch.solver.beta import beta_factor
from rs_sfm_tpu_torch.solver.depth import estimate_inverse_depth
from rs_sfm_tpu_torch.solver.flow_model import (rotational_flow,
                                                translational_flow)
from rs_sfm_tpu_torch.solver.refine import _gram


def _fit_vw(coords, flow, alpha, alpha_k, m, rho, k, group=None):
    """Exact linear least squares for (v, w) at fixed k and ρ (J, N): the
    masked normal equations Σ m GᵀG θ = Σ m Gᵀu with the per-pixel 2x6
    design G = β·[ρ·A | B], the sums taken over `group`'s pixels.  Returns
    v, w (J, 3)."""
    dt = coords.dtype
    beta = beta_factor(alpha, alpha_k, k)[..., None]  # (J, N, 1)
    eye = torch.eye(3, dtype=dt, device=coords.device)
    cols = ([beta * rho[..., None] * translational_flow(coords, eye[j])
             for j in range(3)]
            + [beta * rotational_flow(coords, eye[j]) for j in range(3)])
    g = torch.stack(torch.broadcast_tensors(*cols), dim=-1)  # (J, N, 2, 6)
    aug = torch.cat([g, flow.expand(g.shape[:-1])[..., None]], dim=-1)
    aug = aug * m[..., None, None]
    gram = psum(_gram(aug.reshape(aug.shape[0], -1, 7)), group)  # (J, 7, 7)
    gtg = gram[:, :6, :6] + 1e-12 * torch.eye(6, dtype=dt,
                                              device=coords.device)
    theta = linalg.gauss_solve(gtg, gram[:, :6, 6])
    return theta[:, :3], theta[:, 3:6]


def k_scan(coords, flow, alpha, alpha_k, mask, v0, w0, k_grid, *,
           iters: int = 3, group=None):
    """Scan the k grid; return (v, w, k, ρ, cost) of each start's winner.

    Args:
      coords, flow: (N, 2) normalized coordinates / flow.
      alpha, alpha_k: (N,) RS factors.
      mask: (N,) bool pixels taking part (the RANSAC inliers), or (J, N)
        for J starts.
      v0, w0: (3,) or (J, 3) initial motion (the RANSAC hypothesis): the
        alternation's seed, which keeps the scan in that hypothesis' v
        basin.
      k_grid: (K,) k values.
      iters: alternations of closed-form ρ and linear (v, w) per k.
      group: process group when the pixels are this rank's scanline block
        (None = the whole image); ρ stays local, every other output is the
        same on all ranks.

    Returns (v, w, k, rho, cost) of the grid point of least masked cost
    (the first on ties; a non-finite cost never wins unless all are), with
    the leading J axis when the starts were given batched.
    """
    batched = mask.dim() == 2
    m = mask.reshape(-1, coords.shape[0]).to(coords.dtype)
    v0 = v0.reshape(-1, 1, 3)
    w0 = w0.reshape(-1, 1, 3)
    best = None
    for i in range(k_grid.shape[0]):
        k = k_grid[i]
        v, w = v0, w0
        rho = estimate_inverse_depth(coords, flow, v, w, k, alpha, alpha_k)
        for _ in range(iters):
            v, w = _fit_vw(coords, flow, alpha, alpha_k, m, rho, k, group)
            v, w = v[:, None], w[:, None]
            rho = estimate_inverse_depth(coords, flow, v, w, k, alpha,
                                         alpha_k)
        beta = beta_factor(alpha, alpha_k, k)[..., None]
        r = flow - beta * (translational_flow(coords, v) * rho[..., None]
                           + rotational_flow(coords, w))
        cost = psum(torch.sum(m * torch.sum(r * r, dim=-1), dim=-1),
                    group)  # (J,)
        cost = torch.where(torch.isfinite(cost), cost, torch.inf)
        k_j = k.expand(cost.shape)
        if best is None:
            best = [v[:, 0], w[:, 0], k_j, rho, cost]
        else:
            better = cost < best[4]
            best = [torch.where(better[:, None], v[:, 0], best[0]),
                    torch.where(better[:, None], w[:, 0], best[1]),
                    torch.where(better, k_j, best[2]),
                    torch.where(better[:, None], rho, best[3]),
                    torch.where(better, cost, best[4])]
    if not batched:
        best = [b[0] for b in best]
    return tuple(best)
