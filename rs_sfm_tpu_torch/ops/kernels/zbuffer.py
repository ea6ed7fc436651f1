"""Exact z-buffered splat of the rectification: the CUDA kernel
(csrc/zbuffer.cu) and its plain PyTorch twin (port of
rs_sfm_tpu/ops/pallas/zbuffer.py::zbuffer_splat, held to
rs_sfm_tpu/rectify/backproject.py's exact "scatter" engine).

Each source pixel splats to its rounded target; per target the minimum
depth wins, ties to the lowest source id, and the winner's colour is
written.  The TPU kernel's target-side window search, which misses the
sources that stray from their block's consensus, is not reproduced.
"""

from __future__ import annotations

import ctypes

import torch

from rs_sfm_tpu_torch.ops.kernels import _build


def scatter_resolve(flat_idx, src_depth, colors, n: int):
    """Two-pass scatter-min conflict resolution (backproject.py:230-249).

    flat_idx (n,) int64 target per source, `n` = dropped; src_depth (n,)
    (inf = dropped); colors (n, 3).  Pass 1 finds each target's minimum
    depth, pass 2 the lowest source id among the sources at that depth
    (== treats -0.0 and +0.0 alike).

    Returns (gs_flat (n, 3) in colors' dtype, scattered (n,) bool).
    """
    device = src_depth.device
    zbuf = torch.full((n + 1,), torch.inf, dtype=src_depth.dtype,
                      device=device)
    zbuf.scatter_reduce_(0, flat_idx, src_depth, reduce="amin")
    is_winner = src_depth == zbuf[flat_idx]
    src_ids = torch.arange(n, dtype=torch.int64, device=device)
    winner_id = torch.full((n + 1,), n, dtype=torch.int64, device=device)
    winner_id.scatter_reduce_(0, flat_idx, torch.where(is_winner, src_ids, n),
                              reduce="amin")
    final = (winner_id[flat_idx] == src_ids) & (flat_idx < n)
    slot = torch.where(final, flat_idx, n)
    gs_flat = torch.zeros((n + 1, 3), dtype=colors.dtype, device=device)
    gs_flat[slot] = colors
    scattered = torch.zeros((n + 1,), dtype=torch.bool, device=device)
    scattered[slot] = True
    return gs_flat[:n], scattered[:n]


def splat_targets(target_x, target_y, depth):
    """(flat target index (H*W,) int64 with H*W = dropped, depth (H*W,)
    with inf = dropped) of the sources that splat: finite coordinates and
    depth, and a rounded target floor(t + 0.5) inside the image."""
    h, w = depth.shape
    n = h * w
    finite = (torch.isfinite(target_x) & torch.isfinite(target_y)
              & torch.isfinite(depth))
    fx = torch.floor(torch.where(finite, target_x, -1.0) + 0.5)
    fy = torch.floor(torch.where(finite, target_y, -1.0) + 0.5)
    live = finite & (fx >= 0.0) & (fx < w) & (fy >= 0.0) & (fy < h)
    flat = torch.where(live, fy.to(torch.int64) * w + fx.to(torch.int64), n)
    return flat.reshape(-1), torch.where(live, depth, torch.inf).reshape(-1)


def zbuffer_splat_plain(target_x, target_y, depth, colors):
    """Plain PyTorch version of `zbuffer_splat`: the scatter engine."""
    h, w = depth.shape
    flat, d = splat_targets(target_x, target_y, depth)
    gs, hit = scatter_resolve(flat, d, colors.reshape(h * w, 3), h * w)
    return gs.reshape(h, w, 3), hit.reshape(h, w)


def _lib():
    lib = _build.load("zbuffer")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.zbuffer_splat_launch.argtypes = [p, p, p, p, i, i, p, p, p, p]
        lib.zbuffer_splat_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def zbuffer_splat(target_x, target_y, depth, colors):
    """Z-buffered splat of source pixels to their rounded targets.

    Args:
      target_x, target_y: (H, W) float32 target coordinates per source pixel
        (non-finite or outside the image after rounding = no splat).
      depth: (H, W) float32 target-camera depth per source (non-finite = no
        splat); the minimum wins, ties to the lowest source id.
      colors: (H, W, 3) float32 source colours.

    On CUDA tensors this launches the kernels of csrc/zbuffer.cu (counted in
    `zbuffer_splat.launches`); on CPU tensors it runs `zbuffer_splat_plain`.

    Returns (gs_image (H, W, 3) float32, scattered (H, W) bool).
    """
    if depth.dim() != 2:
        raise ValueError(f"depth must be (H, W), got {tuple(depth.shape)}")
    h, w = depth.shape
    for name, t in (("target_x", target_x), ("target_y", target_y),
                    ("depth", depth), ("colors", colors)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != depth.device:
            raise ValueError(f"{name} on {t.device}, depth on {depth.device}")
    if target_x.shape != (h, w) or target_y.shape != (h, w):
        raise ValueError("target_x and target_y must have depth's shape")
    if colors.shape != (h, w, 3):
        raise ValueError(f"colors must be ({h}, {w}, 3)")
    if depth.device.type == "cpu":
        return zbuffer_splat_plain(target_x, target_y, depth, colors)
    if depth.device.type != "cuda":
        raise ValueError(f"unsupported device {depth.device}")
    if h * w >= 2 ** 32:
        raise ValueError("the source id must fit in 32 bits")
    tx, ty, d, c = (t.contiguous() for t in (target_x, target_y, depth,
                                               colors))
    lib = _lib()
    dev = depth.device
    with torch.cuda.device(dev):
        keys = torch.empty((h * w,), dtype=torch.int64, device=dev)
        gs = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
        hit = torch.empty((h, w), dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.zbuffer_splat_launch(
            tx.data_ptr(), ty.data_ptr(), d.data_ptr(), c.data_ptr(), h, w,
            keys.data_ptr(), gs.data_ptr(), hit.data_ptr(), stream),
            "zbuffer_splat_launch")
    zbuffer_splat.launches += 1
    return gs, hit


zbuffer_splat.launches = 0
