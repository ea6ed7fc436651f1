"""RANSAC hypothesis scoring: the CUDA kernel (csrc/score.cu) and its plain
PyTorch twin (port of rs_sfm_tpu/ops/pallas/score.py).

Layouts are the JAX kernel's: pixel fields packed as (8, N) float32 rows
[x, y, ux, uy, alpha, alpha_k, valid, unused]; hypotheses as (T, 8)
float32 rows [vx, vy, vz, wx, wy, wz, k, unused].  N needs no padding (the
kernel masks the ragged edge); a JAX record padded to its tile is accepted
as it is, since padded pixels carry valid = 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rs_sfm_tpu_torch.ops.kernels import _build


def _fields(px):
    return [px[i:i + 1, :] for i in range(7)]


# Hypotheses the plain version evaluates at once: bounds its (chunk, N)
# temporaries (about 20 of them, 133 MB each at full HD).
_PLAIN_CHUNK = 16


def squared_residuals_plain(px, hyps):
    """The squared residual norms ex^2 + ey^2 of the plain version, in its
    operations: one (chunk, N) float32 tensor per chunk of hypotheses."""
    x, y, ux, uy, alpha, alpha_k, _ = _fields(px)
    for h0 in range(0, hyps.shape[0], _PLAIN_CHUNK):
        hc = hyps[h0:h0 + _PLAIN_CHUNK]
        vx, vy, vz, wx, wy, wz, k = (hc[:, i:i + 1] for i in range(7))
        beta = (alpha + k * alpha_k) * (2.0 / (2.0 + k))
        ax = vx - x * vz
        ay = vy - y * vz
        bx = -x * y * wx + (1.0 + x * x) * wy - y * wz
        by = -(1.0 + y * y) * wx + x * y * wy + x * wz
        gx = beta * ax
        gy = beta * ay
        rx = ux - beta * bx
        ry = uy - beta * by
        gg = gx * gx + gy * gy
        gr = gx * rx + gy * ry
        zero = gg == 0.0
        rho = torch.where(zero, 0.0, gr / torch.where(zero, 1.0, gg))
        ex = ux - beta * (ax * rho + bx)
        ey = uy - beta * (ay * rho + by)
        yield ex * ex + ey * ey


def score_hypotheses_plain(px, hyps, tol: float):
    """Plain PyTorch version of the scoring kernel, same operation order.

    Args:
      px: (8, N) float32 packed pixel fields; hyps: (T, 8) float32.
      tol: inlier tolerance on the residual norm.

    Returns:
      (num_inliers (T,) float32, inlier_error (T,) float32).
    """
    ok = px[6:7, :] > 0.5
    nums, errs = [], []
    for sq in squared_residuals_plain(px, hyps):
        err = torch.sqrt(sq)
        inl = (err < tol) & ok
        nums.append(inl.sum(dim=1).to(torch.float32))
        errs.append(torch.where(inl, err, 0.0).sum(dim=1))
    return torch.cat(nums), torch.cat(errs)


@functools.lru_cache(maxsize=64)
def sq_threshold(tol: float) -> float:
    """s*: the least float32 s with sqrt_rn(s) >= float32(tol).

    sqrt_rn (IEEE, correctly rounded) is monotone, so for a float32
    s = ex^2 + ey^2 the plain version's test sqrt(s) < tol holds exactly
    when s < s*; the kernel tests that.  Found by bisection over the
    float32 bit patterns of [+0, +inf] with numpy's correctly rounded
    float32 square root (PyTorch's on the CPU is not).  A tol that is not
    positive (or NaN) gives 0: no s is below it, as no root is below tol.
    """
    tol32 = np.float32(tol)
    if not tol32 > 0:
        return 0.0
    lo, hi = 0, int(np.float32(np.inf).view(np.uint32))
    while lo < hi:
        mid = (lo + hi) // 2
        if np.sqrt(np.uint32(mid).view(np.float32)) >= tol32:
            hi = mid
        else:
            lo = mid + 1
    return float(np.uint32(lo).view(np.float32))


def _lib():
    lib = _build.load("score")
    if not getattr(lib, "_typed", False):
        lib.score_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.score_launch.restype = ctypes.c_int
        lib.score_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.score_blocks.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _blocks(device_index: int, n: int, t: int) -> int:
    """Pixel blocks of the grid that csrc/score.cu sizes for n pixels and
    t hypotheses on this device."""
    lib = _lib()
    with torch.cuda.device(device_index):
        blocks = lib.score_blocks(n, t)
    if blocks <= 0:
        raise RuntimeError("score_blocks: CUDA error")
    return blocks


def _check_inputs(px, hyps):
    if px.device != hyps.device:
        raise ValueError(f"px on {px.device}, hyps on {hyps.device}")
    for name, t in (("px", px), ("hyps", hyps)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if px.dim() != 2 or px.shape[0] != 8:
        raise ValueError(f"px must be (8, N), got {tuple(px.shape)}")
    if hyps.dim() != 2 or hyps.shape[1] != 8 or hyps.shape[0] == 0:
        raise ValueError(f"hyps must be (T, 8), got {tuple(hyps.shape)}")


def score_hypotheses(px, hyps, tol: float):
    """Score all hypotheses against all pixels.

    On CUDA tensors this launches the kernel of csrc/score.cu (and counts
    the launch in `score_hypotheses.launches`), which tests the squared
    residual against `sq_threshold(tol)`; on CPU tensors it runs
    `score_hypotheses_plain`.

    Returns:
      (num_inliers (T,) float32, inlier_error (T,) float32).
    """
    _check_inputs(px, hyps)
    if px.device.type == "cpu":
        return score_hypotheses_plain(px, hyps, tol)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    lib = _lib()
    n = px.shape[1]
    t = hyps.shape[0]
    blocks = _blocks(px.device.index, n, t)
    with torch.cuda.device(px.device):
        partial = torch.empty((blocks, 2, t), dtype=torch.float32,
                              device=px.device)
        stream = torch.cuda.current_stream(px.device).cuda_stream
        _build.check(lib.score_launch(
            px.data_ptr(), n, n, hyps.data_ptr(), t, sq_threshold(tol),
            partial.data_ptr(), blocks, stream), "score_launch")
    score_hypotheses.launches += 1
    sums = partial.sum(dim=0)
    return sums[0], sums[1]


score_hypotheses.launches = 0


def pack_pixels(coords, flow, alpha, alpha_k, valid):
    """(N,2)/(N,) tensors -> (8, N) float32 packed pixel fields."""
    f32 = torch.float32
    return torch.stack([
        coords[:, 0].to(f32), coords[:, 1].to(f32), flow[:, 0].to(f32),
        flow[:, 1].to(f32), alpha.to(f32), alpha_k.to(f32), valid.to(f32),
        torch.zeros_like(alpha, dtype=f32)])


def pack_hyps(v, w, k):
    """(T,3),(T,3),(T,) -> (T, 8) float32."""
    f32 = torch.float32
    return torch.cat([v.to(f32), w.to(f32), k.to(f32)[:, None],
                      torch.zeros_like(k, dtype=f32)[:, None]], dim=1)
