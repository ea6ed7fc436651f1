"""Batched 9-point differential RS epipolar minimal solver (port of
rs_sfm_tpu/solver/minimal.py).

Recovers (v, w, k) from 9 normalized point/flow correspondences through
the RS differential epipolar constraint uᵀ v̂ x + β·xᵀ S x = 0 with
S = ½(v̂ŵ + ŵv̂) (report eq. 14, 21; src/minimal.cc:36-177).  With the
acceleration model (`use_k`) the factor k comes first, as a real root of
det Z(k) = 0 (src/minimal.cc:56-83).  Leading batch axes broadcast
throughout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rs_sfm_tpu_torch.geom import so3
from rs_sfm_tpu_torch.ops import linalg
from rs_sfm_tpu_torch.solver.beta import beta_factor

# Tolerances mirroring the reference (src/minimal.cc:39-40).
_THRESHOLD_LAMBDA = 1e-6
_TOL_IMAG = 1e-5

# Nodes for the exact recovery of the degree-6 polynomial det(p + κ·p_k):
# 7 Chebyshev points on [-3, 3], and the inverse of their Vandermonde
# matrix (computed as the JAX package computes it).
_K_NODES = 3.0 * np.cos(np.pi * (2 * np.arange(7) + 1) / 14.0)
_INV_VANDERMONDE = np.linalg.inv(np.vander(_K_NODES, 7, increasing=True))

# Starts of the float32 root engine's Newton iteration: the physically
# plausible k range (β's pole sits at k = −2; the reference's sweeps stop
# at 1.5).
_K_NEWTON_STARTS = (-1.5, -0.75, 0.0, 0.5, 1.0, 1.75)
_K_NEWTON_ITERS = 12


def build_z_columns(q, u):
    """Unscaled rows of the 9x9 Z matrix (src/minimal.cc:47-54): columns
    [−u_y, u_x, u_y·x − u_x·y, x², 2xy, 2x, y², 2y, 1]; columns 3..8 still
    lack their per-row β scaling."""
    x, y = q[..., 0], q[..., 1]
    ux, uy = u[..., 0], u[..., 1]
    one = torch.ones_like(x)
    return torch.stack(
        [-uy, ux, uy * x - ux * y, x * x, 2.0 * x * y, 2.0 * x, y * y,
         2.0 * y, one], dim=-1)


def estimate_k_roots(z, alpha, alpha_k):
    """All candidate k roots of det Z(k) = 0, a degree-6 polynomial.

    Returns (roots_re, roots_im), each (..., 6).  On a noise-free minimal
    sample several real roots may each interpolate the 9 constraints; only
    scoring on all pixels (RANSAC) tells the physical one.  The engine
    follows the dtype, as in the JAX package: float64 recovers the
    polynomial exactly from 7 determinants and roots it by Durand–Kerner;
    float32, where that recovery is ill-conditioned, runs Newton on
    det(p + κ·p_k) = 0 from fixed starts and flags a start that did not
    converge with imaginary part 1.
    """
    p, p_k = _k_pencil(z, alpha, alpha_k)
    if z.dtype == torch.float64:
        return _k_roots_polynomial(p, p_k)
    return _k_roots_newton(p, p_k)


def _k_pencil(z, alpha, alpha_k):
    """The 6x6 pencil (p, p_k) with det Z(k) ∝ det(p + k·p_k): the Schur
    complement of Z's leading 3x3 block a (src/minimal.cc:56-69)."""
    a = z[..., :3, :3]
    bc = z[..., :3, 3:]
    dg = z[..., 3:, :3]
    efhj = z[..., 3:, 3:]
    dga = dg @ linalg.gauss_inv(a)
    p = alpha[..., 3:, None] * efhj - (dga * alpha[..., None, :3]) @ bc
    p_k = alpha_k[..., 3:, None] * efhj - (dga * alpha_k[..., None, :3]) @ bc
    return p, p_k


def _k_roots_polynomial(p, p_k):
    dt, dev = p.dtype, p.device
    dets = torch.stack([linalg.gauss_det(p + float(node) * p_k)
                        for node in _K_NODES], dim=-1)
    scale = torch.amax(torch.abs(dets), dim=-1, keepdim=True)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    inv_v = torch.tensor(_INV_VANDERMONDE, dtype=dt, device=dev)
    coeffs = (dets / scale) @ inv_v.T
    return linalg.polyroots(coeffs)


def _k_newton_trace(p, p_k, k):
    """tr(M⁻¹ p_k) for M = p + κ·p_k at each start κ (..., 6): the
    derivative of log det M (Jacobi's formula)."""
    m = p[..., None, :, :] + k[..., None, None] * p_k[..., None, :, :]
    prod = linalg.gauss_inv(m) @ p_k[..., None, :, :]
    return torch.diagonal(prod, dim1=-2, dim2=-1).sum(dim=-1)


def _k_roots_newton(p, p_k):
    """Newton on det(p + κ·p_k) = 0 from the fixed starts, 12 iterations,
    steps clipped to ±1; a start converged when one more step is below
    1e-3·(1 + |κ|).

    In the convergent phase each step is far smaller than the one before.
    A start whose last step was already below that tolerance and whose
    next step is not smaller sits within rounding of its root, where the
    pencil is singular to working precision and its inverse is noise: it
    stops there, converged.  In op-by-op float32 such a noise step can
    throw a start to another root; the JAX package iterates on, and XLA's
    contracted arithmetic keeps those steps tiny on the CPU.
    """
    k = torch.tensor(_K_NEWTON_STARTS, dtype=p.dtype, device=p.device)
    k = k.expand(p.shape[:-2] + (6,))
    prev = torch.full(k.shape, torch.inf, dtype=p.dtype, device=p.device)
    stopped = torch.zeros(k.shape, dtype=torch.bool, device=p.device)
    for _ in range(_K_NEWTON_ITERS):
        tr = _k_newton_trace(p, p_k, k)
        flat = torch.abs(tr) < 1e-20
        step = torch.clip(-1.0 / torch.where(flat, torch.ones_like(tr), tr),
                          -1.0, 1.0)  # damp steps near critical points
        stopped = stopped | (~flat & (torch.abs(step) >= prev)
                             & (prev < 1e-3 * (1.0 + torch.abs(k))))
        move = ~(flat | stopped)
        k = torch.where(move, k + step, k)
        prev = torch.where(move, torch.abs(step), prev)
    tr = _k_newton_trace(p, p_k, k)
    safe = torch.where(torch.abs(tr) < 1e-20, torch.ones_like(tr), tr)
    ok = (stopped | (torch.abs(1.0 / safe) < 1e-3 * (1.0 + torch.abs(k)))) \
        & torch.isfinite(k)
    return (torch.where(ok, k, torch.zeros_like(k)),
            torch.where(ok, torch.zeros_like(k), torch.ones_like(k)))


def _real_roots(roots_re, roots_im):
    return (torch.abs(roots_im) < _TOL_IMAG) & torch.isfinite(roots_re)


def estimate_k(z, alpha, alpha_k, compat_negate: bool = False):
    """The acceleration factor k of each sample: the real root of
    det Z(k) = 0 of least magnitude (src/minimal.cc:74-80), 0 where no root
    is real (the reference's k = ∞ would only give NaNs downstream).  The
    reference takes k as an eigenvalue of p·p_k⁻¹, which is −root:
    `compat_negate` reproduces that sign."""
    roots_re, roots_im = estimate_k_roots(z, alpha, alpha_k)
    valid = _real_roots(roots_re, roots_im)
    mag = torch.where(valid, torch.abs(roots_re), torch.inf)
    best = torch.argmin(mag, dim=-1, keepdim=True)
    k = torch.take_along_dim(roots_re, best, dim=-1)[..., 0]
    k = torch.where(torch.any(valid, dim=-1), k, torch.zeros_like(k))
    return -k if compat_negate else k


def _sandwich(mat, rz, core):
    """mat · rz · core · matᵀ."""
    return mat @ rz @ core @ mat.transpose(-1, -2)


def recover_vw(z):
    """Steps 1-4 of the linear differential algorithm on a β-scaled Z
    (..., 9, 9).  Returns (w, v): v is the unit-normalized null-vector
    direction (scale/sign-ambiguous like the reference)."""
    dtype, device = z.dtype, z.device
    # Step 1: null vector e, normalized by ||e[:3]|| (src/minimal.cc:98-103).
    e = linalg.null_vector(z)
    norm_v0 = torch.sqrt(e[..., 0] ** 2 + e[..., 1] ** 2 + e[..., 2] ** 2)
    safe = torch.where(norm_v0 == 0.0, torch.ones_like(norm_v0), norm_v0)
    e = e / safe[..., None]
    v0 = e[..., :3]
    s = torch.stack(
        [torch.stack([e[..., 3], e[..., 4], e[..., 5]], dim=-1),
         torch.stack([e[..., 4], e[..., 6], e[..., 7]], dim=-1),
         torch.stack([e[..., 5], e[..., 7], e[..., 8]], dim=-1)], dim=-2)

    # Step 2: eigendecomposition of S, outer columns in descending order
    # (src/minimal.cc:111-118).
    lamb, vecs = linalg.eigh_small(s)
    v1 = torch.stack([vecs[..., :, 2], vecs[..., :, 1], vecs[..., :, 0]],
                     dim=-1)
    l0, l1, l2 = lamb[..., 0], lamb[..., 1], lamb[..., 2]
    sigma1 = (2.0 * l2 + l1 - l0) / 3.0
    sigma2 = (l2 + 2.0 * l1 + l0) / 3.0
    sigma3 = (-l2 + l1 + 2.0 * l0) / 3.0

    # Step 3: angle θ and the U/V bases (src/minimal.cc:120-133).
    lam = sigma1 - sigma3
    ratio = torch.clip(
        -sigma2 / torch.where(lam == 0.0, torch.ones_like(lam), lam),
        -1.0, 1.0)
    theta = torch.where(lam < _THRESHOLD_LAMBDA, torch.zeros_like(lam),
                        torch.arccos(ratio))
    r_v = so3.rot_y((theta - math.pi) / 2.0)
    r_u = so3.rot_y(theta)
    v_mat = v1 @ r_v.transpose(-1, -2)
    u_mat = -(v_mat @ r_u)

    sig1 = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dtype,
                                   device=device))
    rz1 = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                       dtype=dtype, device=device)  # RotZ(+π/2)
    rz2 = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                       dtype=dtype, device=device)  # RotZ(−π/2)
    hat_v1 = _sandwich(v_mat, rz1, sig1)
    hat_v2 = _sandwich(v_mat, rz2, sig1)
    hat_u1 = _sandwich(u_mat, rz1, sig1)
    hat_u2 = _sandwich(u_mat, rz2, sig1)

    # Step 4: pick the candidate maximizing v̂ᵀ·v0 (src/minimal.cc:146-157).
    v_vecs = torch.stack([so3.vee(hat_v1), so3.vee(hat_v2), so3.vee(hat_u1),
                          so3.vee(hat_u2)], dim=-2)  # (..., 4, 3)
    dots = torch.sum(v_vecs * v0[..., None, :], dim=-1)
    idx = torch.argmax(dots, dim=-1)

    # ω pairing is crossed (src/minimal.cc:159-173): v-candidates pair with
    # U-based ŵ and vice versa, scaled by λ.
    w_opts = torch.stack([hat_u1, hat_u2, hat_v1, hat_v2], dim=-3) \
        * lam[..., None, None, None]
    w_hat = torch.take_along_dim(w_opts, idx[..., None, None, None],
                                 dim=-3)[..., 0, :, :]
    return so3.vee(w_hat), v0


def _beta_scale_z(z, beta):
    """β-scale columns 3..8 of Z (src/minimal.cc:89-94)."""
    return torch.cat([z[..., :3], z[..., 3:] * beta[..., None]], dim=-1)


def calculate_velocities(q, u, alpha, alpha_k, use_k: bool,
                         compat_negate_k: bool = False):
    """9-point solve for (w, v, k) (src/minimal.cc:36-177).

    Args:
      q: (..., 9, 2) normalized coordinates; u: (..., 9, 2) normalized flow;
      alpha, alpha_k: (..., 9) RS correction factors.
      use_k: the constant-acceleration model, k by the min-|real root| rule
        (`estimate_k`); else k = 0 and β = α.
      compat_negate_k: the reference's sign of k (see `estimate_k`).

    Returns:
      (w, v, k): (..., 3), (..., 3), (...,).
    """
    z = build_z_columns(q, u)
    if use_k:
        k = estimate_k(z, alpha, alpha_k, compat_negate=compat_negate_k)
        beta = beta_factor(alpha, alpha_k, k[..., None])
    else:
        k = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
        beta = alpha
    w, v = recover_vw(_beta_scale_z(z, beta))
    return w, v, k


def calculate_velocities_all_k(q, u, alpha, alpha_k):
    """9-point solve with one (w, v) per root of det Z(k) = 0.

    On a minimal sample every real root interpolates the 9 constraints, so
    RANSAC scores all of them instead of trusting the min-|k| pick.

    Returns (w (..., 6, 3), v (..., 6, 3), k (..., 6), valid (..., 6)
    bool); a complex or non-finite root's slot has k = 0, valid False.
    """
    z = build_z_columns(q, u)
    roots_re, roots_im = estimate_k_roots(z, alpha, alpha_k)
    valid = _real_roots(roots_re, roots_im)
    k = torch.where(valid, roots_re, torch.zeros_like(roots_re))
    beta = beta_factor(alpha[..., None, :], alpha_k[..., None, :],
                       k[..., :, None])
    z6 = z[..., None, :, :].expand(beta.shape[:-1] + (9, 9))
    w, v = recover_vw(_beta_scale_z(z6, beta))
    return w, v, k, valid
