"""Joint nonlinear refinement of (v, w, k, inverse depths) by Schur-reduced
Levenberg–Marquardt (port of rs_sfm_tpu/solver/refine.py, the engine of
`refine_engine="xla"`).

The reference hands this to Ceres with DENSE_SCHUR
(src/nonlinearRefinement.cc:183-252).  The objective

    min Σ_i m_i · ‖u_i − β_i(k)·(A_i v ρ_i + B_i w)‖²

(or its Huber form) is minimized with closed-form per-pixel 2x8
Jacobians; the per-pixel depth blocks are scalars, so the Schur complement
of the depth block is a 7x7 system assembled from masked pixel sums, and
after each step ρ is re-eliminated in closed form (variable projection).

Plain tensor ops in the flow's dtype, on the flow's device: no kernel lies
behind this engine (the fused engine is `refine_fused`).  J starts run
batched along a leading axis (the JAX package vmaps `refine`); each start
keeps its own damping, accept decisions and stopping flag.

Under scanline-block sharding (`group`) each rank holds its block of
pixels: the cost and, per iteration, the two Gram products of the Schur
system (the augmented [Jθ | r] Gram and the ρ-elimination's Y Gram, packed
into one buffer) are summed over the group, one all-reduce each, so every
rank takes the same step and stops at the same iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rs_sfm_tpu_torch.ops import linalg
from rs_sfm_tpu_torch.parallel.distributed import psum
from rs_sfm_tpu_torch.solver.beta import beta_factor, beta_factor_dk
from rs_sfm_tpu_torch.solver.depth import estimate_inverse_depth_info
from rs_sfm_tpu_torch.solver.flow_model import (rotational_flow,
                                                translational_flow)


class RefineResult(NamedTuple):
    v: torch.Tensor          # (3,) or (J, 3)
    w: torch.Tensor
    k: torch.Tensor          # () or (J,)
    inv_depth: torch.Tensor  # (N,) or (J, N) refined ρ (unchanged off-mask)
    cost: torch.Tensor       # final masked (robust) cost
    initial_cost: torch.Tensor


def _residual_and_jac(coords, flow, alpha, alpha_k, v, w, k, rho):
    """Residual r (..., N, 2) and Jacobian blocks of the masked LS problem
    for models v, w (..., 1, 3), k (..., 1) and depths rho (..., N).

    Returns (r, j_theta (..., N, 2, 7), j_rho (..., N, 2)); parameter
    order θ = [v(3), w(3), k].
    """
    x, y = coords[..., 0], coords[..., 1]
    beta = beta_factor(alpha, alpha_k, k)
    dbeta = beta_factor_dk(alpha, alpha_k, k)
    av = translational_flow(coords, v)
    bw = rotational_flow(coords, w)
    e = av * rho[..., None] + bw
    r = flow - beta[..., None] * e
    zero = torch.zeros_like(beta)
    # ∂r/∂v = −β·ρ·A ;  A = [[1,0,−x],[0,1,−y]]
    brho = beta * rho
    jv = torch.stack([torch.stack([-brho, zero, brho * x], dim=-1),
                      torch.stack([zero, -brho, brho * y], dim=-1)], dim=-2)
    # ∂r/∂w = −β·B ;  B = [[−xy, 1+x², −y], [−(1+y²), xy, x]]
    jw = torch.stack(
        [torch.stack([beta * x * y, -beta * (1.0 + x * x), beta * y], dim=-1),
         torch.stack([beta * (1.0 + y * y), -beta * x * y, -beta * x],
                     dim=-1)], dim=-2)
    # ∂r/∂k = −(dβ/dk)·e
    jk = -dbeta[..., None] * e
    j_theta = torch.cat([jv, jw, jk[..., None]], dim=-1)
    # ∂r/∂ρ = −β·A·v
    j_rho = -beta[..., None] * av
    return r, j_theta, j_rho


def _gram(x):
    """Σ over the pixel rows of xᵀx: x (J, R, C) -> (J, C, C).

    One (C, R) x (R, C) product per start.  A batched product of these
    shapes (C = 8, R = 4.1M: full HD, J = 4) took 117 ms in float32 on an
    NVIDIA H100 and was 1.7e-3 off float64 relative, against 1.42 ms and
    5.5e-7 for the products one by one."""
    return torch.stack([xj.T @ xj for xj in x])


def refine(coords, flow, alpha, alpha_k, mask, v0, w0, k0, rho0, *,
           optimize_k: bool, iterations: int = 50, init_lambda: float = 1e-6,
           rel_tol: float = 1e-8, loss_delta: float = 0.0,
           group=None) -> RefineResult:
    """Schur-reduced LM refinement (reference nonLinearRefinement,
    src/nonlinearRefinement.cc:183-252).

    Args:
      coords, flow: (N, 2) normalized coordinates / flow.
      alpha, alpha_k: (N,) RS factors.
      mask: (N,) bool pixels taking part (the RANSAC inliers), or (J, N)
        for J starts.
      v0, w0: (3,) or (J, 3); k0: () or (J,); rho0: (N,) or (J, N)
        initial model and inverse depths.
      optimize_k: k is a free parameter (frozen otherwise,
        src/nonlinearRefinement.cc:221-223).
      iterations: LM iterations (Ceres' default maximum is 50).
      rel_tol: a start stops after an accepted step whose relative cost
        decrease is at most this; 0 runs exactly `iterations` steps with no
        host sync, > 0 reads the stopping flags once per iteration.
      loss_delta: > 0 switches to the Huber loss on the per-pixel residual
        norm (lagged IRLS weights min(1, δ/‖r‖)); 0 is the reference's L2.
      group: process group when the pixels are this rank's scanline block
        (None = the whole image); ρ stays local, every other output is the
        same on all ranks.

    Returns a RefineResult, with a leading J axis on every field when the
    starts were given batched.  Depths outside the mask pass through.
    """
    dt = coords.dtype
    dev = coords.device
    batched = mask.dim() == 2
    as_t = lambda a: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    v = as_t(v0).reshape(-1, 3)
    w = as_t(w0).reshape(-1, 3)
    k = as_t(k0).reshape(-1)
    n_starts = v.shape[0]
    rho = as_t(rho0).reshape(n_starts, -1)
    mask = mask.reshape(n_starts, -1)
    m = mask.to(dt)
    robust = loss_delta > 0.0
    delta = torch.tensor(loss_delta, dtype=dt, device=dev)
    k_keep = 1.0 if optimize_k else 0.0

    def rho_loss(sq):
        """‖r‖² (L2) or Huber(‖r‖)."""
        if not robust:
            return sq
        nrm = torch.sqrt(sq + 1e-24)
        return torch.where(nrm <= delta, sq, 2.0 * delta * nrm - delta * delta)

    def irls_w(sq):
        """Lagged IRLS weight ρ'(‖r‖)/‖r‖ (1 inside the Huber knee)."""
        if not robust:
            return torch.ones_like(sq)
        nrm = torch.sqrt(sq + 1e-24)
        return torch.minimum(torch.ones_like(nrm), delta / nrm)

    def cost_fn(v, w, k, rho):
        beta = beta_factor(alpha, alpha_k, k[:, None])
        e = (translational_flow(coords, v[:, None]) * rho[..., None]
             + rotational_flow(coords, w[:, None]))
        r = flow - beta[..., None] * e
        return psum(torch.sum(m * rho_loss(torch.sum(r * r, dim=-1)),
                              dim=-1), group)

    def step(v, w, k, rho, lam, cost):
        r, j_theta, j_rho = _residual_and_jac(
            coords, flow, alpha, alpha_k, v[:, None], w[:, None],
            k[:, None], rho)
        # Freeze k by zeroing its Jacobian column (δk solves to 0 below).
        if not optimize_k:
            j_theta = torch.cat([j_theta[..., :6],
                                 torch.zeros_like(j_theta[..., 6:])], dim=-1)
        # The lagged IRLS weight folds into the mask; the augmented Gram
        # [Jθ | r] gives JᵀJ, Jᵀr and rᵀr in one product.
        m_eff = m * irls_w(torch.sum(r * r, dim=-1))
        mw = torch.sqrt(m_eff)[..., None]
        x_aug = torch.cat([j_theta * mw[..., None], (r * mw)[..., None]],
                          dim=-1).reshape(n_starts, -1, 8)
        c_i = torch.sum(j_theta * (j_rho * m_eff[..., None])[..., None],
                        dim=-2)                              # (J, N, 7)
        d_i = torch.sum(j_rho * j_rho, dim=-1) * m_eff       # (J, N)
        g_rho = torch.sum(j_rho * r, dim=-1) * m_eff         # (J, N)
        d_aug = d_i * (1.0 + lam[:, None])
        informative = d_aug > 0.0
        d_safe = torch.where(informative, d_aug, torch.ones_like(d_aug))
        # Augmented Schur product: Y = [c/√d̃ | g_ρ/√d̃] packs Σ c cᵀ/d̃ and
        # Σ c g_ρ/d̃ into one Gram matrix.
        inv_sqrt_d = torch.where(informative, 1.0 / torch.sqrt(d_safe),
                                 torch.zeros_like(d_safe))
        y_aug = torch.cat([c_i * inv_sqrt_d[..., None],
                           (g_rho * inv_sqrt_d)[..., None]], dim=-1)
        # Both Gram products are pixel sums of local terms (λ is the same
        # on every rank): ONE all-reduce of the two under `group`.
        grams = psum(torch.stack([_gram(x_aug), _gram(y_aug)]), group)
        gram, gram_y = grams[0], grams[1]
        h_tt = gram[:, :7, :7]
        g_t = gram[:, :7, 7]

        # Multiplicative (Marquardt) damping on the diagonals.
        diag = torch.diagonal(h_tt, dim1=-2, dim2=-1)
        h_aug = h_tt + torch.diag_embed(lam[:, None] * (diag + 1e-12))
        # Keep the frozen-k row/column invertible.
        h_aug[:, 6, 6] += 1.0 - k_keep
        h_red = h_aug - gram_y[:, :7, :7]
        g_red = g_t - gram_y[:, :7, 7]

        # GN step (JᵀJ)δ = −Jᵀr, Jacobi-preconditioned: the diagonal spans
        # about 4 orders of magnitude.
        d_pre = torch.diagonal(h_red, dim1=-2, dim2=-1)
        d_pre = torch.where(d_pre > 0.0, d_pre, torch.ones_like(d_pre))
        s_pre = 1.0 / torch.sqrt(d_pre)
        h_pre = h_red * s_pre[:, :, None] * s_pre[:, None, :]
        delta_theta = s_pre * linalg.gauss_solve(h_pre, -g_red * s_pre)

        v_new = v + delta_theta[:, :3]
        w_new = w + delta_theta[:, 3:6]
        k_new = k + delta_theta[:, 6]
        # Variable projection: ρ re-eliminated in closed form at the
        # candidate motion; masked-out and uninformative pixels keep theirs.
        rho_star, info = estimate_inverse_depth_info(
            coords, flow, v_new[:, None], w_new[:, None], k_new[:, None],
            alpha, alpha_k)
        rho_new = torch.where(mask & info, rho_star, rho)

        new_cost = cost_fn(v_new, w_new, k_new, rho_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        converged = accept & (cost - new_cost <= rel_tol * cost)
        sel = lambda a, b: torch.where(  # noqa: E731
            accept.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        lam_new = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12),
                              lam * 4.0)
        return (sel(v_new, v), sel(w_new, w), sel(k_new, k),
                sel(rho_new, rho), lam_new, sel(new_cost, cost), converged)

    lam = torch.full((n_starts,), init_lambda, dtype=dt, device=dev)
    cost0 = cost_fn(v, w, k, rho)
    cost = cost0
    done = torch.zeros((n_starts,), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        if rel_tol == 0.0:
            v, w, k, rho, lam, cost, _ = step(v, w, k, rho, lam, cost)
            continue
        if bool(torch.all(done)):
            break
        # A start that has stopped keeps its state (the JAX while_loop's).
        out = step(v, w, k, rho, lam, cost)
        live = ~done
        v, w, k, rho, lam, cost = (
            torch.where(live.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(out[:6], (v, w, k, rho, lam, cost)))
        done = done | (live & out[6])
    if not batched:
        return RefineResult(v=v[0], w=w[0], k=k[0], inv_depth=rho[0],
                            cost=cost[0], initial_cost=cost0[0])
    return RefineResult(v=v, w=w, k=k, inv_depth=rho, cost=cost,
                        initial_cost=cost0)
