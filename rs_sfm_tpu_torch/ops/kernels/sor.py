"""Red-black SOR sweeps of the variational flow solver: the CUDA kernel
(csrc/sor.cu) and its plain PyTorch twin (port of
rs_sfm_tpu/ops/pallas/sor.py::sor_sweeps_pallas).

The formulation is the TPU kernel's: 8 packed coefficient planes in
absolute form,

    0 ix   1 iy   2 c    3 ixx  4 ixy  5 iyy  6 cgx  7 cgy

with the residuals r = ix·u + iy·v + c and (rgx, rgy) = (cgx, cgy) +
[[ixx, ixy], [ixy, iyy]]·(u, v), IEEE square roots and divisions.  The JAX
package's XLA loop (rs_sfm_tpu/flow/dense.py:655-706) writes the same
weights in delta form around the warp's flow and agrees with this to about
1e-3 px after 3 warps x 20 sweeps, as the JAX package's own kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from rs_sfm_tpu_torch.ops.kernels import _build


def _navg(z):
    """4-neighbour mean, Neumann edges: ((up + down) + left) + right."""
    up = torch.cat([z[:1], z[:-1]], 0)
    dn = torch.cat([z[1:], z[-1:]], 0)
    lf = torch.cat([z[:, :1], z[:, :-1]], 1)
    rt = torch.cat([z[:, 1:], z[:, -1:]], 1)
    return (up + dn + lf + rt) * 0.25


def _sqrt(x):
    """Correctly rounded float32 square root on every device.  PyTorch's
    vectorised float32 sqrt on the CPU is not (it misses on about 0.6 % of
    inputs); its float64 one rounds to the right float32."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def sor_sweeps_plain(coef, u, v, *, iters: int, omega: float, lam: float,
                     eps2: float, wbr: float, wgrad: float):
    """Plain PyTorch version, in the kernel's operation order.

    `wbr / s` is written `(1 / s) * wbr`, which is how PyTorch evaluates a
    number divided by a tensor; the kernel spells it the same way.  Every
    operation rounds as IEEE float32 does, so the CPU and the card give the
    same bits as the kernel.  Pixels of the other colour keep their values
    exactly.

    Returns the new (u, v); the inputs are not modified.
    """
    ix, iy, c, ixx, ixy, iyy, cgx, cgy = coef.unbind(0)
    h, w = u.shape
    ys = torch.arange(h, device=u.device)[:, None]
    xs = torch.arange(w, device=u.device)[None, :]
    checker = (ys + xs) % 2
    # Sweep-invariant bracketed terms (the kernel recomputes the same values).
    gxx = ixx * ixx + ixy * ixy
    gxy = ixx * ixy + ixy * iyy
    gyy = ixy * ixy + iyy * iyy
    hx = ixx * cgx + ixy * cgy
    hy = ixy * cgx + iyy * cgy
    for _ in range(iters):
        for color in (0, 1):
            r = ix * u + iy * v + c
            wd = torch.reciprocal(_sqrt(r * r + eps2)) * wbr
            rgx = cgx + ixx * u + ixy * v
            rgy = cgy + ixy * u + iyy * v
            wg = torch.reciprocal(_sqrt(rgx * rgx + rgy * rgy + eps2)) * wgrad
            ubar = _navg(u)
            vbar = _navg(v)
            a11 = lam + wd * ix * ix + wg * gxx
            a12 = wd * ix * iy + wg * gxy
            a22 = lam + wd * iy * iy + wg * gyy
            b1 = lam * ubar - wd * ix * c - wg * hx
            b2 = lam * vbar - wd * iy * c - wg * hy
            det = a11 * a22 - a12 * a12
            det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
            u_new = (a22 * b1 - a12 * b2) / det
            v_new = (a11 * b2 - a12 * b1) / det
            sel = checker == color
            u = torch.where(sel, u + omega * (u_new - u), u)
            v = torch.where(sel, v + omega * (v_new - v), v)
    return u, v


def _lib():
    lib = _build.load("sor")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sor_launch.argtypes = [p, p, p, i, i, i, f, f, f, f, f, p]
        lib.sor_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def sor_sweeps(coef, u, v, *, iters: int, omega: float, lam: float,
               eps2: float, wbr: float, wgrad: float):
    """`iters` red-black SOR sweeps.

    coef (8, H, W), u, v (H, W), all float32.  On CUDA tensors this runs
    the kernel of csrc/sor.cu on copies of (u, v): 2 * iters launches, one
    per colour of each sweep, each counted in `sor_sweeps.launches`.  On
    CPU tensors it runs `sor_sweeps_plain`.

    Returns the new (u, v).
    """
    h, w = u.shape
    if coef.shape != (8, h, w) or v.shape != (h, w):
        raise ValueError(f"coef (8, H, W) and u, v (H, W), got "
                         f"{tuple(coef.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("coef", coef), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} on {t.device}, u on {u.device}")
    params = dict(iters=iters, omega=omega, lam=lam, eps2=eps2, wbr=wbr,
                  wgrad=wgrad)
    if u.device.type == "cpu":
        return sor_sweeps_plain(coef, u, v, **params)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    coef = coef.contiguous()
    u = u.clone(memory_format=torch.contiguous_format)
    v = v.clone(memory_format=torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        _build.check(lib.sor_launch(
            coef.data_ptr(), u.data_ptr(), v.data_ptr(), h, w, iters,
            omega, lam, eps2, wbr, wgrad, stream), "sor_launch")
    sor_sweeps.launches += 2 * max(iters, 0)
    return u, v


sor_sweeps.launches = 0
