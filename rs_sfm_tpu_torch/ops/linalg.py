"""Batched small-matrix linear algebra (port of rs_sfm_tpu/ops/linalg.py).

Stacks of tiny matrices ((..., n, n), n ≤ 9) for the minimal solver and
the k-scan: cyclic-Jacobi `eigh_small` and the `null_vector` built on it;
pivoted elimination for `gauss_det`, `gauss_solve`, `gauss_inv` and
`solve_spd`, and the unpivoted `solve_pd_nopivot`; and the Durand–Kerner
`polyroots` that roots the k polynomial.  The rotation, elimination and
root-iteration sequences and their arithmetic follow the JAX version step
for step, so the two agree to float64 rounding.
"""

from __future__ import annotations

import math

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


def _pivot_swap(a, k: int, det_sign=None):
    """Swap row k with the largest-|a[:, k]| row at or below it (batched;
    the first such row on ties, as jnp.argmax).  With `det_sign` (...,),
    also returns it with the swap's sign folded in."""
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
    a = torch.where(mask, k_row[..., None, :], a)
    if det_sign is None:
        return a
    return a, det_sign * torch.where(piv == k, 1.0, -1.0).to(det_sign.dtype)


def gauss_det(a):
    """Determinant of (..., n, n) by partially pivoted elimination; a zero
    pivot after pivoting leaves its zero on the diagonal, so a singular
    matrix gives 0."""
    n = a.shape[-1]
    row_ids = torch.arange(n, device=a.device)
    sign = torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)
    for k in range(n - 1):
        a, sign = _pivot_swap(a, k, sign)
        pivval = a[..., k, k].clone()
        safe = torch.where(pivval == 0.0, torch.ones_like(pivval), pivval)
        factors = a[..., :, k] / safe[..., None]
        factors = torch.where(row_ids > k, factors, torch.zeros_like(factors))
        a = a - factors[..., None] * a[..., k, :][..., None, :]
        a[..., k, k] = pivval
    return sign * torch.prod(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)


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


def solve_spd(a, b, damping=0.0):
    """Solve (a + damping·I) x = b for symmetric positive-definite a, by
    the pivoted elimination (more forgiving near rank deficiency)."""
    n = a.shape[-1]
    if damping is not None:
        a = a + damping * torch.eye(n, dtype=a.dtype, device=a.device)
    return gauss_solve(a, b)


def solve_pd_nopivot(a, b):
    """Solve a @ x = b without pivoting, for damped positive-definite
    systems whose diagonal dominates: a (..., n, n), b (..., n) or
    (..., n, m); x has b's shape."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    n = a.shape[-1]
    aug = torch.cat([a, b], dim=-1)
    row_ids = torch.arange(n, device=a.device)
    for k in range(n):
        pivval = aug[..., k, k]
        safe = torch.where(pivval == 0.0, torch.ones_like(pivval), pivval)
        factors = torch.where(row_ids == k, torch.zeros_like(aug[..., :, k]),
                              aug[..., :, k])
        piv_row = aug[..., k, :] / safe[..., None]
        aug = torch.where((row_ids == k)[:, None], piv_row[..., None, :],
                          aug - factors[..., None] * piv_row[..., None, :])
    x = aug[..., n:]
    return x[..., 0] if vec else x


def polyroots(coeffs, iterations: int = 64):
    """All complex roots of real polynomials by Durand–Kerner (Weierstrass)
    iteration, batched.

    Args:
      coeffs: (..., n+1) coefficients in ascending order (c[0] + c[1] x +
        ... + c[n] x^n).  A near-zero leading coefficient gives roots of
        huge magnitude, which the min-|k| selection discards.
      iterations: fixed iteration count (64 is far past convergence for
        degree <= 6).

    Returns (roots_re, roots_im), each (..., n).  The starts (radius
    1 + max |c_i| of the monic polynomial, angles 2πj/n + 0.4) and every
    operation are the JAX function's.
    """
    c = coeffs
    deg = c.shape[-1] - 1
    lead = c[..., -1]
    safe_lead = torch.where(torch.abs(lead) < torch.finfo(c.dtype).tiny * 1e6,
                            torch.ones_like(lead), lead)
    monic = c / safe_lead[..., None]
    radius = 1.0 + torch.amax(torch.abs(monic[..., :-1]), dim=-1)
    angles = [2.0 * math.pi * j / deg + 0.4 for j in range(deg)]
    cos = torch.tensor([math.cos(t) for t in angles], dtype=c.dtype,
                       device=c.device)
    sin = torch.tensor([math.sin(t) for t in angles], dtype=c.dtype,
                       device=c.device)
    re = radius[..., None] * cos
    im = radius[..., None] * sin
    eye = torch.eye(deg, dtype=c.dtype, device=c.device)
    for _ in range(iterations):
        # Horner evaluation of the monic polynomial at re + i·im.
        pr = torch.ones_like(re)
        pi = torch.zeros_like(im)
        for j in range(deg - 1, -1, -1):
            pr, pi = (pr * re - pi * im + monic[..., j][..., None],
                      pr * im + pi * re)
        # The product over m != j of (z_j - z_m); the diagonal is 1 + 0i.
        dre = re[..., :, None] - re[..., None, :] + eye
        dim = im[..., :, None] - im[..., None, :]
        prod_re = torch.ones_like(re)
        prod_im = torch.zeros_like(im)
        for m in range(deg):
            a, b = dre[..., :, m], dim[..., :, m]
            prod_re, prod_im = (prod_re * a - prod_im * b,
                                prod_re * b + prod_im * a)
        den = prod_re * prod_re + prod_im * prod_im
        den = torch.where(den == 0.0, torch.ones_like(den), den)
        re = re - (pr * prod_re + pi * prod_im) / den
        im = im - (pi * prod_re - pr * prod_im) / den
    return re, im
