"""Batched 9-point differential RS epipolar minimal solver (port of
rs_sfm_tpu/solver/minimal.py:51-342, constant-velocity path).

Recovers (v, w) from 9 normalized point/flow correspondences through the RS
differential epipolar constraint uᵀ v̂ x + β·xᵀ S x = 0 with
S = ½(v̂ŵ + ŵv̂) (report eq. 14, 21; src/minimal.cc:36-177).  Leading batch
axes broadcast throughout.  The acceleration path (k from det Z(k) = 0,
`use_k=True`) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from rs_sfm_tpu_torch.geom import so3
from rs_sfm_tpu_torch.ops import linalg

# Tolerance mirroring the reference (src/minimal.cc:39).
_THRESHOLD_LAMBDA = 1e-6


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


def calculate_velocities(q, u, alpha, alpha_k, use_k: bool):
    """9-point solve for (w, v, k) (src/minimal.cc:36-177), constant-velocity
    model (k = 0).

    Args:
      q: (..., 9, 2) normalized coordinates; u: (..., 9, 2) normalized flow;
      alpha, alpha_k: (..., 9) RS correction factors.
      use_k: must be False (the k-root path is not ported yet).

    Returns:
      (w, v, k): (..., 3), (..., 3), (...,).
    """
    if use_k:
        raise NotImplementedError(
            "the acceleration (k-root) minimal solver is not ported yet")
    del alpha_k  # only the k-root path reads α̃
    z = build_z_columns(q, u)
    k = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
    w, v = recover_vw(_beta_scale_z(z, alpha))
    return w, v, k
