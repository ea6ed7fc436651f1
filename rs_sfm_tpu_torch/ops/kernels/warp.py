"""Bilinear warp of planes by flow fields: the CUDA kernel (csrc/warp.cu)
and its plain PyTorch twin.

Port of rs_sfm_tpu/ops/pallas/warp.py::bilinear_warp, held to its exact
twin rs_sfm_tpu/flow/dense.py::_warp: the TPU kernel's window clamp for
residual displacements beyond `warp_radius` is a workaround for the TPU's
gather and is not carried over.

Shapes: `img` is one plane (H, W) or P planes (P, H, W); `flow` one field
(H, W, 2) or K fields (K, H, W, 2), flow[..., 0] along x.  A single plane
warps by each of K fields, P planes by a single field, or plane i by field
i when P == K.  The result is (H, W) for one plane and one field, else
(max(P, K), H, W).
"""

from __future__ import annotations

import ctypes

import torch

from rs_sfm_tpu_torch.ops.kernels import _build


def _batched(img, flow):
    """(img (Pi, H, W), flow (Ki, H, W, 2), batch, squeeze) after checks."""
    if img.dim() not in (2, 3) or flow.dim() not in (3, 4):
        raise ValueError(f"img (H, W) or (P, H, W) and flow (H, W, 2) or "
                         f"(K, H, W, 2), got {tuple(img.shape)} and "
                         f"{tuple(flow.shape)}")
    img3 = img if img.dim() == 3 else img[None]
    flow4 = flow if flow.dim() == 4 else flow[None]
    if flow4.shape[-1] != 2 or flow4.shape[1:3] != img3.shape[1:]:
        raise ValueError(f"flow {tuple(flow.shape)} does not match img "
                         f"{tuple(img.shape)}")
    p, k = img3.shape[0], flow4.shape[0]
    if p != k and min(p, k) != 1:
        raise ValueError(f"{p} planes against {k} flows")
    for name, t in (("img", img), ("flow", flow)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if img.device != flow.device:
        raise ValueError(f"img on {img.device}, flow on {flow.device}")
    squeeze = img.dim() == 2 and flow.dim() == 3
    return img3, flow4, max(p, k), squeeze


def warp_plain(img, flow):
    """Plain PyTorch version: dense.py::_warp's operation order."""
    img3, flow4, b, squeeze = _batched(img, flow)
    h, w = img3.shape[1:]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    x = torch.clamp(xs + flow4[..., 0], 0.0, w - 1.0)
    y = torch.clamp(ys + flow4[..., 1], 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - x0f
    fy = y - y0f
    flat = img3.reshape(img3.shape[0], h * w).expand(b, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(yy.shape[0], h * w).expand(b, h * w)
        return torch.gather(flat, 1, idx).reshape(b, h, w)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return out[0] if squeeze else out


def aligned8(t):
    """`t` contiguous and 8-byte aligned (the kernels read flows as
    float2)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 8 else t


def _lib():
    lib = _build.load("warp")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.warp_launch.argtypes = [p, ll, p, ll, p, i, i, i, p]
        lib.warp_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def warp(img, flow):
    """Bilinear sample of img at x + flow(x), coordinates clamped to the
    edge (see the module docstring for the shapes).

    On CUDA tensors this launches the kernel of csrc/warp.cu (counted in
    `warp.launches`); on CPU tensors it runs `warp_plain`.
    """
    img3, flow4, b, squeeze = _batched(img, flow)
    if img.device.type == "cpu":
        return warp_plain(img, flow)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    img3 = img3.contiguous()
    flow4 = aligned8(flow4)
    h, w = img3.shape[1:]
    lib = _lib()
    with torch.cuda.device(img.device):
        out = torch.empty((b, h, w), dtype=torch.float32, device=img.device)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        _build.check(lib.warp_launch(
            img3.data_ptr(), h * w if img3.shape[0] > 1 else 0,
            flow4.data_ptr(), 2 * h * w if flow4.shape[0] > 1 else 0,
            out.data_ptr(), b, h, w, stream), "warp_launch")
    warp.launches += 1
    return out[0] if squeeze else out


warp.launches = 0
