"""3x3 edge-clamped median of planes: the CUDA kernel (csrc/median.cu) and
its plain PyTorch twin (port of rs_sfm_tpu/ops/pallas/median.py, whose
exact XLA twin is rs_sfm_tpu/flow/dense.py::_median3).

Min and max only, so the kernel, the plain version and JAX agree bit for bit.
`median3_planes` is the counterpart of the JAX function; `median3_flow` is
the flow solver's entry point, which reads a flow's two planes where they
lie and writes a contiguous (H, W, 2) flow.
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
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.median3_launch.argtypes = [p, ll, ll, i, p, ll, ll, i, i, i, i, p]
        lib.median3_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(src, in_plane, in_row, in_pair, out, out_plane, out_row,
            out_pair, planes, h, w):
    """One launch of the kernel of csrc/median.cu, counted in
    `median3_planes.launches` whichever entry point made it; strides in
    elements."""
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.check(lib.median3_launch(
            src.data_ptr(), in_plane, in_row, int(in_pair), out.data_ptr(),
            out_plane, out_row, int(out_pair), planes, h, w, stream),
            "median3_launch")
    median3_planes.launches += 1


def _check(t, name, dims):
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def median3_planes(planes):
    """3x3 edge-clamped median of (P, H, W) float32 planes.

    On CUDA tensors this launches the kernel of csrc/median.cu (counted in
    `median3_planes.launches`); on CPU tensors it runs `median3_plain`.
    """
    _check(planes, "planes", 3)
    if planes.device.type == "cpu":
        return median3_plain(planes)
    x = planes.contiguous()
    n_planes, h, w = x.shape
    out = torch.empty_like(x)
    _launch(x, h * w, w, False, out, h * w, w, False, n_planes, h, w)
    return out


median3_planes.launches = 0


def _pair_layout(u, v):
    """How the kernel reads the planes u, v (H, W) where they lie:
    ("pair", row stride) for the two planes of one (H, W, 2) tensor,
    ("planes", plane stride, row stride) for planes with unit column
    stride (the plane stride is the distance from u to v, in elements), or
    None.  The stride of a dimension of size 1 is never used."""
    h, w = u.shape
    d = v.data_ptr() - u.data_ptr()

    def strides(t):
        r, c = t.stride()
        return (r if h > 1 else None), (c if w > 1 else None)

    (ru, cu), (rv, cv) = strides(u), strides(v)
    if ru != rv or cu != cv:
        return None
    if (cu in (2, None) and d == 4 and u.data_ptr() % 8 == 0
            and (ru is None or ru % 2 == 0)):
        return ("pair", 2 * w if ru is None else ru)
    if cu in (1, None) and d % 4 == 0:
        return ("planes", d // 4, w if ru is None else ru)
    return None


def median3_flow(u, v):
    """3x3 edge-clamped median of a flow's two (H, W) float32 planes, read
    where they lie, into a new contiguous (H, W, 2) flow.

    u, v: the planes flow[..., 0] and flow[..., 1] of an (H, W, 2) tensor,
    or two planes with unit column stride and one row stride anywhere on
    the same device (the SOR solver's u and v); other layouts are copied
    first.  On CUDA tensors this is one launch of the kernel of
    csrc/median.cu, counted in `median3_planes.launches`; on CPU tensors it
    is `median3_plain` of the two planes, as an (H, W, 2) flow.
    """
    _check(u, "u", 2)
    _check(v, "v", 2)
    if u.shape != v.shape or u.device != v.device:
        raise ValueError(f"u {tuple(u.shape)} on {u.device} and v "
                         f"{tuple(v.shape)} on {v.device} differ")
    if u.device.type == "cpu":
        return median3_plain(torch.stack([u, v])).permute(1, 2, 0).contiguous()
    h, w = u.shape
    layout = _pair_layout(u, v)
    if layout is None:
        u = torch.stack([u, v])[0]
        layout = ("planes", h * w, w)
    out = torch.empty((h, w, 2), dtype=torch.float32, device=u.device)
    if layout[0] == "pair":
        _launch(u, 0, layout[1], True, out, 0, 2 * w, True, 2, h, w)
    else:
        _launch(u, layout[1], layout[2], False, out, 0, 2 * w, True, 2, h, w)
    return out
