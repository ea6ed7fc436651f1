"""3x3 edge-clamped median of planes: the CUDA kernel (csrc/median.cu) and
its plain PyTorch twin (port of rs_sfm_tpu/ops/pallas/median.py, whose
exact XLA twin is rs_sfm_tpu/flow/dense.py::_median3).

Min and max only, so the kernel, the plain version and JAX agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from rs_sfm_tpu_torch.ops import stencil
from rs_sfm_tpu_torch.ops.kernels import _build

# The optimal 9-input median network (19 comparators), dense.py:384-386.
PAIRS = ((0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
         (6, 7), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
         (4, 2), (6, 4), (4, 2))


def median3_plain(planes):
    """Plain PyTorch 3x3 median of (..., H, W) planes, edge-clamped."""
    h, w = planes.shape[-2:]
    p = stencil.pad_edge(planes, 1)
    # dense.py's input order: _shift2(x, dy, dx) for dy, dx in (-1, 0, 1).
    v = [p[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for a, b in PAIRS:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v[4].contiguous()


def _lib():
    lib = _build.load("median")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.median3_launch.argtypes = [p, p, i, i, i, p]
        lib.median3_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def median3_planes(planes):
    """3x3 edge-clamped median of (P, H, W) float32 planes.

    On CUDA tensors this launches the kernel of csrc/median.cu (counted in
    `median3_planes.launches`); on CPU tensors it runs `median3_plain`.
    """
    if planes.dim() != 3:
        raise ValueError(f"planes must be (P, H, W), got {tuple(planes.shape)}")
    if planes.dtype != torch.float32:
        raise TypeError(f"planes must be float32, got {planes.dtype}")
    if planes.device.type == "cpu":
        return median3_plain(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    x = planes.contiguous()
    n_planes, h, w = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.median3_launch(x.data_ptr(), out.data_ptr(),
                                        n_planes, h, w, stream),
                     "median3_launch")
    median3_planes.launches += 1
    return out


median3_planes.launches = 0
