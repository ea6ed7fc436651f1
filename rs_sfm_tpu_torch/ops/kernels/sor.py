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


def sor_terms(coef):
    """The 8 planes of coef and the 5 sweep-invariant bracketed terms (the
    kernel recomputes the same values)."""
    ix, iy, c, ixx, ixy, iyy, cgx, cgy = coef.unbind(0)
    return (ix, iy, c, ixx, ixy, iyy, cgx, cgy,
            ixx * ixx + ixy * ixy, ixx * ixy + ixy * iyy,
            ixy * ixy + iyy * iyy, ixx * cgx + ixy * cgy,
            ixy * cgx + iyy * cgy)


def sor_colour_pass(terms, u, v, sel, *, omega: float, lam: float,
                    eps2: float, wbr: float, wgrad: float):
    """One colour pass of the plain version on `sor_terms(coef)`: the point
    solve at every pixel of (u, v), kept where `sel` holds.  The
    4-neighbour means take a missing neighbour as the pixel itself (Neumann
    at the array's edges).

    `wbr / s` is written `(1 / s) * wbr`, which is how PyTorch evaluates a
    number divided by a tensor; the kernel spells it the same way.  Every
    operation rounds as IEEE float32 does, so the CPU and the card give the
    same bits as the kernel.  Returns the new (u, v)."""
    ix, iy, c, ixx, ixy, iyy, cgx, cgy, gxx, gxy, gyy, hx, hy = terms
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
    return (torch.where(sel, u + omega * (u_new - u), u),
            torch.where(sel, v + omega * (v_new - v), v))


def sor_sweeps_plain(coef, u, v, *, iters: int, omega: float, lam: float,
                     eps2: float, wbr: float, wgrad: float):
    """Plain PyTorch version, in the kernel's operation order: `iters`
    sweeps of `sor_colour_pass`, colour 0 then colour 1.  Pixels of the
    other colour keep their values exactly.

    Returns the new (u, v); the inputs are not modified.
    """
    h, w = u.shape
    ys = torch.arange(h, device=u.device)[:, None]
    xs = torch.arange(w, device=u.device)[None, :]
    checker = (ys + xs) % 2
    terms = sor_terms(coef)
    prm = dict(omega=omega, lam=lam, eps2=eps2, wbr=wbr, wgrad=wgrad)
    for _ in range(iters):
        for color in (0, 1):
            u, v = sor_colour_pass(terms, u, v, checker == color, **prm)
    return u, v


# Tile plan of csrc/sor.cu.  A block holds the 10 planes (8 coefficients,
# u, v) of its tile and a halo of 2 * SWEEPS_PER_LAUNCH pixels in shared
# memory: 40 bytes a pixel, at most the card's opt-in shared memory per
# block.  TILE was the fastest plan timed at full HD; a plane with fewer
# TILE tiles than the card has SMs takes TILE_SMALL instead, which spreads
# it over more of them (phase 3 of chip_smoke.py times both at every level
# of the pyramid).
SWEEPS_PER_LAUNCH = 4
TILE = (40, 80)  # interior rows x columns of a block
TILE_SMALL = (24, 48)
# (SMs, opt-in shared-memory bytes per block) of an H100: the limits a plan
# is made for when no card is named (the CPU tests).
H100_LIMITS = (132, 232448)


def card_limits(device) -> tuple[int, int]:
    """(SMs, opt-in shared-memory bytes per block) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def smem_bytes(h: int, w: int, tile_h: int, tile_w: int, halo: int) -> int:
    """Shared-memory bytes of one block (csrc/sor.cu's sor_launch)."""
    return 10 * 2 * min(h, tile_h + 2 * halo) * (
        (min(w, tile_w + 2 * halo) + 1) // 2) * 4


def tile_plan(h: int, w: int, iters: int, limits=H100_LIMITS):
    """(tile_h, tile_w, halo, sweeps per launch) of csrc/sor.cu for an
    (h, w) plane and `iters` sweeps on a card of `limits` (`card_limits`):
    the whole plane in one block and one launch when it fits, else TILE (or
    TILE_SMALL on a plane of fewer tiles than SMs) with a halo of
    2 * SWEEPS_PER_LAUNCH."""
    sms, smem = limits
    if smem_bytes(h, w, h, w, 0) <= smem:
        return h, w, 0, max(iters, 1)
    k = SWEEPS_PER_LAUNCH
    tiles = -(-h // TILE[0]) * -(-w // TILE[1])
    return (*(TILE if tiles >= sms else TILE_SMALL), 2 * k, k)


def launches_per_call(h: int, w: int, iters: int, limits=H100_LIMITS) -> int:
    """Kernel launches of one `sor_sweeps` call on a CUDA tensor of a card
    of `limits`."""
    return -(-max(iters, 0) // tile_plan(h, w, iters, limits)[3])


def sor_launch(coef, u, v, u_out, v_out, plan, *, iters: int, omega: float,
               lam: float, eps2: float, wbr: float, wgrad: float) -> int:
    """`iters` sweeps of csrc/sor.cu on (tile_h, tile_w, halo, sweeps) =
    `plan`, from contiguous CUDA (coef, u, v) into (u_out, v_out); returns
    the launches it made (not counted in `sor_sweeps.launches`)."""
    h, w = u.shape
    two = -(-iters // plan[3]) > 1
    u_tmp = torch.empty_like(u) if two else u_out
    v_tmp = torch.empty_like(v) if two else v_out
    launches = ctypes.c_int(0)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = _lib().sor_launch(
            coef.data_ptr(), u.data_ptr(), v.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), u_tmp.data_ptr(), v_tmp.data_ptr(), h, w,
            iters, *plan, omega, lam, eps2, wbr, wgrad,
            ctypes.byref(launches), stream)
    _build.check(err, "sor_launch")
    return launches.value


def _lib():
    lib = _build.load("sor")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sor_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   f, f, f, f, f, p, p]
        lib.sor_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def sor_sweeps(coef, u, v, *, iters: int, omega: float, lam: float,
               eps2: float, wbr: float, wgrad: float):
    """`iters` red-black SOR sweeps.

    coef (8, H, W), u, v (H, W), all float32.  On CUDA tensors this runs
    the kernel of csrc/sor.cu on the plan of `tile_plan` for its card:
    `launches_per_call(H, W, iters, card_limits(device))` launches, each
    counted in `sor_sweeps.launches`.  On CPU tensors it runs
    `sor_sweeps_plain`.

    Returns the new (u, v); the inputs are not modified.
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
    coef, u, v = coef.contiguous(), u.contiguous(), v.contiguous()
    if iters <= 0:
        return u.clone(), v.clone()
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    plan = tile_plan(h, w, iters, card_limits(u.device))
    sor_sweeps.launches += sor_launch(coef, u, v, u_out, v_out, plan,
                                      **params)
    return u_out, v_out


sor_sweeps.launches = 0
