"""Batched small-matrix linear algebra (port of rs_sfm_tpu/ops/linalg.py:24-123).

Stacks of tiny symmetric matrices ((..., n, n), n ≤ 9) for the minimal
solver: cyclic-Jacobi `eigh_small` and the `null_vector` built on it, and
the pivoted Gauss-Jordan `gauss_solve` / `gauss_inv` (ops/linalg.py:125-197)
that the synthetic renderer inverts its scanline rotations with.  The
rotation and elimination sequences and their arithmetic follow the JAX
version step for step, so the two agree to float64 rounding.  Determinants
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


def _pivot_swap(a, k: int):
    """Swap row k with the largest-|a[:, k]| row at or below it (batched;
    the first such row on ties, as jnp.argmax)."""
    n = a.shape[-2]
    row_ids = torch.arange(n, device=a.device)
    col = torch.where(row_ids >= k, torch.abs(a[..., :, k]),
                      -torch.ones_like(a[..., :, k]))
    piv = torch.argmax(col, dim=-1)
    index = piv[..., None, None].expand(*a.shape[:-2], 1, a.shape[-1])
    p_row = torch.take_along_dim(a, index, dim=-2)[..., 0, :]
    k_row = a[..., k, :].clone()
    a = a.clone()
    a[..., k, :] = p_row
    # The old row k goes to the pivot's place (a no-op when piv == k).
    mask = row_ids[:, None] == piv[..., None, None]
    return torch.where(mask, k_row[..., None, :], a)


def gauss_solve(a, b):
    """Solve a @ x = b for tiny batched systems by Gauss-Jordan elimination
    with partial pivoting: a (..., n, n), b (..., n) or (..., n, m); x has
    b's shape."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    row_ids = torch.arange(n, device=a.device)
    aug = torch.cat([a, b], dim=-1)
    for k in range(n):
        aug = _pivot_swap(aug, k)
        pivval = aug[..., k, k]
        safe = torch.where(pivval == 0.0, torch.ones_like(pivval), pivval)
        aug[..., k, :] = aug[..., k, :] / safe[..., None]
        factors = torch.where(row_ids == k, torch.zeros_like(aug[..., :, k]),
                              aug[..., :, k])
        aug = aug - factors[..., None] * aug[..., k, :][..., None, :]
    x = aug[..., n:]
    return x[..., 0] if vec else x


def gauss_inv(a):
    """Inverse of tiny batched matrices (..., n, n) via Gauss-Jordan."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    return gauss_solve(a, eye)
