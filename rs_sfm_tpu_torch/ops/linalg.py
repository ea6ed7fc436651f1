"""Batched small-matrix linear algebra (port of rs_sfm_tpu/ops/linalg.py:24-123).

Stacks of tiny symmetric matrices ((..., n, n), n ≤ 9) for the minimal
solver: cyclic-Jacobi `eigh_small` and the `null_vector` built on it.  The
rotation sequence and arithmetic follow the JAX version step for step, so
the two agree to float64 rounding.  The pivoted Gauss solve, determinants
and polynomial roots (the k-root path) are not ported yet.
"""

from __future__ import annotations

import torch


def _jacobi_rotate(a, v, p, q):
    """One Jacobi rotation zeroing a[..., p, q] (p < q), in place on the
    caller's private copies of `a` and `v`."""
    apq = a[..., p, q].clone()
    app = a[..., p, p]
    aqq = a[..., q, q]
    small = torch.abs(apq) <= torch.finfo(a.dtype).tiny * 1e3
    safe_apq = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    # sign(0) == 0 would zero the rotation; tau == 0 must give t = 1.
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)
    s = torch.where(small, torch.zeros_like(s), s)

    ce = c[..., None]
    se = s[..., None]
    # Rows: A <- Jᵀ A
    row_p = a[..., p, :].clone()
    row_q = a[..., q, :].clone()
    a[..., p, :] = ce * row_p - se * row_q
    a[..., q, :] = se * row_p + ce * row_q
    # Cols: A <- A J
    col_p = a[..., :, p].clone()
    col_q = a[..., :, q].clone()
    a[..., :, p] = ce * col_p - se * col_q
    a[..., :, q] = se * col_p + ce * col_q
    # Exact zeros on the annihilated pair keep the off-diagonal decaying.
    a[..., p, q] = 0.0
    a[..., q, p] = 0.0
    # Eigenvector accumulation: V <- V J
    vp = v[..., :, p].clone()
    vq = v[..., :, q].clone()
    v[..., :, p] = ce * vp - se * vq
    v[..., :, q] = se * vp + ce * vq


def eigh_small(a):
    """Eigendecomposition of symmetric matrices by cyclic Jacobi (8 sweeps
    for n <= 4, else 12, as the JAX default).

    Returns (eigenvalues (..., n) ascending, eigenvectors (..., n, n) in
    columns) — the contract of torch.linalg.eigh.
    """
    n = a.shape[-1]
    sweeps = 8 if n <= 4 else 12
    a = (a + a.transpose(-1, -2)) * 0.5
    v = torch.zeros_like(a) + torch.eye(n, dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                _jacobi_rotate(a, v, p, q)
    w = torch.diagonal(a, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    v = torch.take_along_dim(v, order[..., None, :], dim=-1)
    return w, v


def null_vector(z):
    """Right-singular vector of z (..., m, n) for the smallest singular value:
    the eigenvector of zᵀz for the smallest eigenvalue (src/minimal.cc:98-101)."""
    ztz = torch.matmul(z.transpose(-1, -2), z)
    _, v = eigh_small(ztz)
    return v[..., :, 0]
