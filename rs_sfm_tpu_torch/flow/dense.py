"""Dense optical flow: pyramidal coarse-to-fine variational estimation
(port of rs_sfm_tpu/flow/dense.py).

Per pair: a Gaussian pyramid over both frames; an exhaustive integer search
at the coarsest level and a warp-local integer search at the small levels
(DeepFlow's matching-term role); at every level several warps, each
warp -> linearised brightness + gradient constancy -> red-black SOR sweeps
-> 3x3 median; finally the forward-backward occlusion test.  Boundaries
replicate the edge everywhere.

Every discrete search, warp, SOR solve and median goes through the
wrappers of the hand-written kernels of ops/kernels (csrc/match.cu,
warp.cu, sor.cu, median.cu): the kernel on a CUDA tensor, its plain twin
on a CPU tensor.  The config's
warp_engine / sor_engine keep their JAX values only so a configuration
moves across; both values take this one path.  Unlike the TPU kernels, the
CUDA kernels take every pyramid shape
(the TPU's size thresholds are not carried over) and the warp is exact
everywhere (no `warp_radius` window).  The SOR twin is the TPU kernel's
absolute form, which agrees with the JAX XLA loop to about 1e-3 px
(ops/kernels/sor.py).

`lax.scan` over the discrete-search candidates becomes one launch of the
search kernel (ops/kernels/match.py), which scans the candidates in the
JAX order.

The relock pass (flow/relock.py) gives dense flow a prior, an (H, W, 2)
flow that breaks the discrete searches' exact ties toward itself (the
search kernel's prior), and the anchored pass (`anchor_ambiguous`) zeroes
the data term at the pixels the searches found ambiguous, so the
smoothness term fills them from their unambiguous neighbours.

The census data term (`census_weight` > 0: 8 soft-sign neighbour
channels, each with its own Charbonnier weight) goes to the SOR kernel as
24 more sweep-invariant planes; the JAX package runs it on its XLA loop
only, which the SOR twin is held to as without census.  The shifted
refine (`refine_shifted`) warps I2 once by the flow (the warp kernel) and
runs the search kernel's shifted mode: candidate d's cost is read at
integer shifts of that plane (DIS-style).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.ops import resample, stencil
from rs_sfm_tpu_torch.ops.kernels import match as kmatch
from rs_sfm_tpu_torch.ops.kernels import median as kmedian
from rs_sfm_tpu_torch.ops.kernels import sor as ksor
from rs_sfm_tpu_torch.ops.kernels import warp as kwarp


def check_supported(cfg: DenseFlowConfig) -> None:
    """Raise ValueError for an engine name the JAX package does not have."""
    for name in ("warp_engine", "sor_engine"):
        if getattr(cfg, name) not in ("xla", "pallas"):
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")


_shift = stencil.shift


def _to_gray(img):
    if img.dim() == 3:
        return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return img


_gauss_blur = resample.gauss_blur
_downsample = resample.down2_blur
_up2 = resample.up2


def _resize_bilinear(x, shape):
    """jax.image.resize(method="bilinear") of the last two axes for an
    upsample: half-pixel centres, edge samples clamped, rows then columns.

    The sample positions and weights are computed in float64 on the host:
    F.interpolate's float32 source index drifts by up to 1.5e-5 of a value
    at a 68 -> 135 ratio, 40x the error of the JAX resize.
    """
    for axis, n in ((-2, shape[0]), (-1, shape[1])):
        m = x.shape[axis]
        if m == n:
            continue
        s = np.clip((np.arange(n) + 0.5) * (m / n) - 0.5, 0.0, m - 1.0)
        i0 = np.floor(s).astype(np.int64)
        i1 = np.minimum(i0 + 1, m - 1)
        frac = torch.from_numpy(s - i0).to(device=x.device, dtype=x.dtype)
        if axis == -2:
            frac = frac[:, None]
        a = x.index_select(axis, torch.from_numpy(i0).to(x.device))
        b = x.index_select(axis, torch.from_numpy(i1).to(x.device))
        x = a * (1.0 - frac) + b * frac
    return x


def _upsample_flow(flow, shape):
    """Resize an (h, w, 2) flow to `shape` and scale its vectors; the 2x
    (+1 on odd sizes) case takes the exact interleave, any other ratio a
    bilinear resize."""
    h, w = shape
    fh, fw = flow.shape[:2]
    planes = flow.permute(2, 0, 1)
    if 0 <= h - 2 * fh <= 1 and 0 <= w - 2 * fw <= 1:
        out = _up2(planes)
        if h - 2 * fh or w - 2 * fw:
            iy = torch.arange(h, device=flow.device).clamp_(max=2 * fh - 1)
            ix = torch.arange(w, device=flow.device).clamp_(max=2 * fw - 1)
            out = out.index_select(-2, iy).index_select(-1, ix)
    else:
        out = _resize_bilinear(planes, (h, w))
    scale = torch.tensor([w / fw, h / fh], dtype=flow.dtype,
                         device=flow.device)
    return out.permute(1, 2, 0) * scale


def _gradients(img):
    """Central differences over the last two axes, edge-clamped."""
    gx = (_shift(img, -1, -1) - _shift(img, 1, -1)) * 0.5
    gy = (_shift(img, -1, -2) - _shift(img, 1, -2)) * 0.5
    return gx, gy


# The census channels' neighbour offsets (dy, dx), in the JAX order
# (rs_sfm_tpu/flow/dense.py:345).
_CENSUS_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1))


def _census_channels(img, sigma: float):
    """Soft ternary census: (8, H, W) channels d / sqrt(d^2 + sigma^2) of
    the neighbour differences d = I(x + n) - I(x), edge-clamped shifts (a
    correctly rounded square root, as ops/kernels/sor._sqrt)."""
    c = torch.stack([_shift(_shift(img, dy, -2), dx, -1) - img
                     for dy, dx in _CENSUS_OFFSETS])
    return c / ksor._sqrt(c * c + sigma * sigma)


def census_planes(cen1, i2w, flow, sigma: float):
    """The census term's 24 SOR planes (ops/kernels/sor.py): cjx, cjy (the
    gradients of I2w's census channels) and their constant parts ccc =
    (cen2w - cen1) - cjx u0 - cjy v0 in absolute flow, linearised around
    `flow` with I2 already warped by it; cen1: `_census_channels` of I1."""
    cen2w = _census_channels(i2w, sigma)
    cjx, cjy = _gradients(cen2w)
    ccc = (cen2w - cen1) - cjx * flow[..., 0] - cjy * flow[..., 1]
    return torch.cat([cjx, cjy, ccc])


def _local_contrast_norm(x, eps: float):
    """(x - mu) / sqrt(var + eps^2) with local (double-5-tap) mean and
    variance: invariant to smooth gain and offset fields."""
    mu = _gauss_blur(_gauss_blur(x))
    d = x - mu
    var = _gauss_blur(_gauss_blur(d * d))
    return d * torch.rsqrt(var + eps * eps)


def _median_flow(u, v):
    """3x3 median of a flow's planes u, v (H, W), read where they lie (the
    two planes of an (H, W, 2) flow, or SOR's u and v): a contiguous
    (H, W, 2) flow."""
    return kmedian.median3_flow(u, v)


def _match_planes(i1, i2, cfg):
    """Discrete-matching preprocessing: locally mean-removed planes, or
    contrast-normalised ones under gain_correct."""
    both = torch.stack([i1, i2])
    if cfg.gain_correct:
        out = _local_contrast_norm(both, 0.05)
    else:
        out = both - _gauss_blur(both)
    return out[0], out[1]


def _coarse_init(i1, i2, radius: int, cfg, prior=None):
    """Exhaustive integer search in [-radius, radius]^2 at the coarsest
    level (5x5 box-filtered squared differences), median-cleaned; `prior`
    (this level's) breaks ties toward itself.
    Returns (flow, second, ambiguous)."""
    i1m, i2m = _match_planes(i1, i2, cfg)
    fallback = (torch.zeros(i1m.shape + (2,), dtype=i1m.dtype,
                            device=i1m.device)
                if cfg.match_ratio > 0.0 else None)
    best, second, amb = kmatch.match_search(i1m, i2m, None, radius,
                                            cfg.match_ratio, fallback, prior)
    return _median_flow(best[..., 0], best[..., 1]), second, amb


def _discrete_refine(i1, i2, flow, radius: int, cfg, prior=None):
    """Warp-local integer search: candidate flow + d for d in
    [-radius, radius]^2, best box-filtered SSD per pixel; `prior` (this
    level's) breaks ties toward itself.  Exact mode re-warps I2 for each
    candidate; with cfg.refine_shifted I2 is warped once by `flow` and
    candidate d's cost read at the integer shift d of that plane.
    Returns (median-cleaned flow, second, ambiguous)."""
    i1m, i2m = _match_planes(i1, i2, cfg)
    if cfg.refine_shifted:
        i2m = kwarp.warp(i2m, flow)
    best, second, amb = kmatch.match_search(
        i1m, i2m, flow, radius, cfg.match_ratio, flow, prior,
        shifted=cfg.refine_shifted)
    return _median_flow(best[..., 0], best[..., 1]), second, amb


def _sor(coef, u, v, iters: int, cfg, census=None):
    return ksor.sor_sweeps(coef, u, v, iters=iters, omega=float(cfg.omega),
                           lam=float(cfg.smoothness),
                           eps2=float(cfg.eps * cfg.eps),
                           wbr=float(cfg.brightness_weight),
                           wgrad=float(cfg.gamma_grad), census=census,
                           census_weight=float(cfg.census_weight))


def _level_solve(i1, i2, flow, cfg: DenseFlowConfig, *, finest: bool = True,
                 data_mask=None):
    """Warping + red-black SOR solves at one pyramid level.

    data_mask: optional (H, W) float in {0, 1}; where it is 0 all 8
    coefficient planes (and the census planes) are zeroed, so SOR's point
    solve there is the smoothness term's neighbour average alone (the
    anchored pass)."""
    warps = cfg.warps if finest or cfg.warps_coarse <= 0 else \
        cfg.warps_coarse
    iters = cfg.iters if finest or cfg.iters_coarse <= 0 else \
        cfg.iters_coarse
    g1 = _gradients(i1)
    cen1 = (_census_channels(i1, cfg.census_sigma)
            if cfg.census_weight > 0.0 else None)
    for _ in range(warps):
        i2w = kwarp.warp(i2, flow)
        if cfg.gain_correct:
            # Aligned-pair gain refinement at this level's grid scale.
            b1 = _gauss_blur(_gauss_blur(_gauss_blur(_gauss_blur(i1))))
            b2 = _gauss_blur(_gauss_blur(_gauss_blur(_gauss_blur(i2w))))
            i2w = i2w * torch.clamp((b1 + 1e-2) / (b2 + 1e-2), 0.7, 1.4)
        coef = linearize(i1, i2w, flow, g1)
        census = (census_planes(cen1, i2w, flow, cfg.census_sigma)
                  if cen1 is not None else None)
        if data_mask is not None:
            coef = coef * data_mask
            if census is not None:
                census = census * data_mask
        u, v = _sor(coef, flow[..., 0], flow[..., 1], iters, cfg, census)
        flow = (_median_flow(u, v) if cfg.median
                else torch.stack([u, v], dim=-1))
    return flow


def linearize(i1, i2w, flow, g1=None):
    """The 8 SOR coefficient planes (ix, iy, c, ixx, ixy, iyy, cgx, cgy) of
    brightness and gradient constancy, linearised around `flow` with I2
    already warped by it; the constant parts are in absolute flow (u, v).
    g1: _gradients(i1), if the caller has it."""
    g1x, g1y = _gradients(i1) if g1 is None else g1
    ix, iy = _gradients(i2w)
    it = i2w - i1
    # Gradient constancy: second derivatives of the warped image.
    gtx = ix - g1x
    gty = iy - g1y
    ixx, ixy = _gradients(ix)
    iyy = (_shift(iy, -1, -2) - _shift(iy, 1, -2)) * 0.5
    u0 = flow[..., 0]
    v0 = flow[..., 1]
    c = it - ix * u0 - iy * v0
    cgx = gtx - ixx * u0 - ixy * v0
    cgy = gty - ixy * u0 - iyy * v0
    return torch.stack([ix, iy, c, ixx, ixy, iyy, cgx, cgy])


class FlowAux(NamedTuple):
    flow: torch.Tensor       # (H, W, 2) pixel flow
    ambiguous: torch.Tensor  # (H, W) bool: no informative discrete lock
    alt_flow: torch.Tensor = None  # (H, W, 2) best >= 2 px-away alternative


def _upsample_mask(mask, shape):
    """jax.image.resize(method="nearest") of a bool plane: source index
    floor((i + 0.5) * m / n), in float32 as JAX computes it."""
    out = mask
    for axis, n in ((0, shape[0]), (1, shape[1])):
        m = out.shape[axis]
        if m == n:
            continue
        idx = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5))
                       * np.float32(m) / np.float32(n)).astype(np.int64)
        out = out.index_select(axis, torch.from_numpy(idx).to(mask.device))
    return out


def pyramid_levels(h: int, w: int, levels: int) -> int:
    """Number of pyramid levels (dense.py:761-766)."""
    count = 1
    while min(h, w) >= 24 and count < levels:
        h, w = h // 2, w // 2
        count += 1
    return count


def as_device_tensor(x, device=None, dtype=None):
    """`x` as a tensor (of `dtype`, if given).  A tensor stays on its
    device, which is the caller's choice (the CPU tests pass CPU tensors);
    anything else goes to `device`, by default the CUDA device, and without
    one this raises rather than running on the CPU unasked."""
    if not torch.is_tensor(x) and device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for a non-tensor input; pass torch tensors "
                "on the device to run on (CPU tensors run the kernels' plain "
                "versions)")
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(x, device=device)
    return t if dtype is None or t.dtype == dtype else t.to(dtype)


def _halve_flow(flow):
    """A flow field blur-downsampled like the images, its values halved
    (the pixel units of the next pyramid level)."""
    return _downsample(flow.permute(2, 0, 1)).permute(1, 2, 0) * 0.5


def dense_flow_aux(image1, image2, cfg: DenseFlowConfig = DenseFlowConfig(),
                   prior=None) -> FlowAux:
    """Dense flow from image1 to image2 plus the discrete-matching
    ambiguity mask.

    Args:
      image1, image2: (H, W[, 3]) float32 images in [0, 1]: tensors on the
        device to run on, or arrays, which go to the CUDA device.
      cfg: DenseFlowConfig.
      prior: optional (H, W, 2) pixel flow (the relock pass's model flow).
        Every discrete search multiplies each candidate's selection cost by
        a penalty growing with its distance to the prior (at that level's
        scale), so exact photometric ties resolve toward it; the
        match_ratio fallback is then skipped.

    Returns:
      FlowAux(flow (H, W, 2), ambiguous (H, W) bool, alt_flow (H, W, 2)).
    """
    check_supported(cfg)
    i1 = _to_gray(as_device_tensor(image1, dtype=torch.float32))
    i2 = _to_gray(as_device_tensor(image2, i1.device, torch.float32))
    if cfg.lcn > 0.0:
        i1 = _local_contrast_norm(i1, cfg.lcn)
        i2 = _local_contrast_norm(i2, cfg.lcn)
    if cfg.struct_texture > 0.0:
        i1 = i1 - cfg.struct_texture * _gauss_blur(_gauss_blur(i1))
        i2 = i2 - cfg.struct_texture * _gauss_blur(_gauss_blur(i2))
    h, w = i1.shape
    n_levels = pyramid_levels(h, w, cfg.levels)
    p1, p2 = [i1], [i2]
    for _ in range(n_levels - 1):
        both = _downsample(torch.stack([p1[-1], p2[-1]]))
        p1.append(both[0])
        p2.append(both[1])
    priors = [None] * n_levels
    if prior is not None:
        priors[0] = as_device_tensor(prior, i1.device, i1.dtype)
        for lvl in range(1, n_levels):
            priors[lvl] = _halve_flow(priors[lvl - 1])

    # Ambiguity export: OR over the searched discrete scales; the
    # alternative lock from the finest scale that flagged each pixel.
    # The anchored pass keeps the current level's mask (amb_lv): the
    # coarse search's, nearest-upsampled level by level and OR'ed with
    # each level's refine mask.
    amb_full = torch.zeros((h, w), dtype=torch.bool, device=i1.device)
    alt_full = None
    amb_lv = None
    if cfg.init_search_radius > 0:
        flow, alt_c, amb_c = _coarse_init(p1[-1], p2[-1],
                                          cfg.init_search_radius, cfg,
                                          priors[-1])
        amb_lv = amb_c if cfg.anchor_ambiguous else None
        amb_full = _upsample_mask(amb_c, (h, w))
        alt_full = torch.where(amb_full[..., None],
                               _upsample_flow(alt_c, (h, w)),
                               torch.zeros((h, w, 2), dtype=i1.dtype,
                                           device=i1.device))
    else:
        flow = torch.zeros(p1[-1].shape + (2,), dtype=i1.dtype,
                           device=i1.device)
    for lvl in range(n_levels - 1, -1, -1):
        shape_l = tuple(p1[lvl].shape)
        if lvl != n_levels - 1:
            flow = _upsample_flow(flow, shape_l)
            if amb_lv is not None:
                amb_lv = _upsample_mask(amb_lv, shape_l)
        if lvl != 0:
            if (cfg.refine_search_radius > 0
                    and min(shape_l) <= cfg.refine_max_size):
                radius = cfg.refine_search_radius
            else:
                radius = cfg.refine_fine_radius
            if radius > 0:
                flow, alt, amb = _discrete_refine(p1[lvl], p2[lvl], flow,
                                                  radius, cfg, priors[lvl])
                amb_up = _upsample_mask(amb, (h, w))
                amb_full = amb_full | amb_up
                if cfg.anchor_ambiguous:
                    amb_lv = amb if amb_lv is None else amb_lv | amb
                alt_up = _upsample_flow(alt, (h, w))
                alt_full = (torch.where(amb_up[..., None], alt_up, alt_full)
                            if alt_full is not None else alt_up)
        data_mask = None
        if amb_lv is not None:
            data_mask = 1.0 - amb_lv.to(i1.dtype)
        flow = _level_solve(p1[lvl], p2[lvl], flow, cfg, finest=(lvl == 0),
                            data_mask=data_mask)
    if alt_full is None:
        alt_full = flow
    return FlowAux(flow=flow, ambiguous=amb_full, alt_flow=alt_full)


def dense_flow(image1, image2, cfg: DenseFlowConfig = DenseFlowConfig(),
               prior=None):
    """Dense flow from image1 to image2 (pixels); see dense_flow_aux."""
    return dense_flow_aux(image1, image2, cfg, prior=prior).flow


class FlowWithOcclusion(NamedTuple):
    flow: torch.Tensor       # (H, W, 2) forward flow (frame 1 -> frame 2)
    backward: torch.Tensor   # (H, W, 2) backward flow (frame 2 -> frame 1)
    occlusion: torch.Tensor  # (H, W) bool: forward flow unreliable
    ambiguous: torch.Tensor = None  # (H, W) bool (FlowAux.ambiguous)
    alt_flow: torch.Tensor = None   # (H, W, 2) (FlowAux.alt_flow), forward


def flow_forward_backward(image1, image2,
                          cfg: DenseFlowConfig = DenseFlowConfig(),
                          prior=None, *,
                          timer: Optional[Callable[[str], None]] = None,
                          ) -> FlowWithOcclusion:
    """Forward + backward flow with the Sundaram-Brox occlusion test:
    x is occluded where |w_f(x) + w_b(x + w_f(x))|^2 >
    occ_rel (|w_f|^2 + |w_b(x + w_f)|^2) + occ_abs.

    With backward_scale = 2^s the backward flow is computed on frames
    downsampled s times and upsampled back.  `prior` (an (H, W, 2) pixel
    flow; see dense_flow_aux) guides the forward flow; the backward flow
    takes it negated, blur-downsampled and halved s times (an anchor for
    the tie-break, read at the same pixel).  `timer`, if given, is called
    with "flow_forward" once the forward flow has been enqueued and with
    "flow_backward" once the backward flow and the test have (stage timing
    with CUDA events; nothing is synchronised here).
    """
    mark = timer if timer is not None else (lambda _name: None)
    image1 = as_device_tensor(image1, dtype=torch.float32)
    image2 = as_device_tensor(image2, image1.device, torch.float32)
    bw_prior = None
    if prior is not None:
        prior = as_device_tensor(prior, image1.device, torch.float32)
        bw_prior = -prior
    fw_aux = dense_flow_aux(image1, image2, cfg, prior)
    fw = fw_aux.flow
    mark("flow_forward")
    if cfg.backward_scale > 1:
        if cfg.backward_scale & (cfg.backward_scale - 1):
            raise ValueError(
                f"backward_scale must be a power of two (got "
                f"{cfg.backward_scale}): it is realized as log2(scale) "
                f"pyramid downsamples")
        g = torch.stack([_to_gray(image1), _to_gray(image2)])
        for _ in range(cfg.backward_scale.bit_length() - 1):
            g = _downsample(g)
            if bw_prior is not None:
                bw_prior = _halve_flow(bw_prior)
        bw_lo = dense_flow_aux(g[1], g[0], cfg, bw_prior).flow
        bw = _upsample_flow(bw_lo, fw.shape[:2])
    else:
        bw = dense_flow_aux(image2, image1, cfg, bw_prior).flow
    # Backward flow sampled at x + w_f(x), both planes in one warp.
    bw_at_fw = kwarp.warp(bw.permute(2, 0, 1).contiguous(),
                          fw).permute(1, 2, 0)
    rt = fw + bw_at_fw
    sq = torch.sum(rt * rt, dim=-1)
    mag = (torch.sum(fw * fw, dim=-1)
           + torch.sum(bw_at_fw * bw_at_fw, dim=-1))
    occ = sq > cfg.occ_rel * mag + cfg.occ_abs
    if cfg.occ_photo > 0.0:
        n1 = _local_contrast_norm(_to_gray(image1), 0.05)
        n2 = _local_contrast_norm(_to_gray(image2), 0.05)
        n2w = kwarp.warp(n2, fw)
        occ = occ | (torch.abs(n2w - n1) > cfg.occ_photo)
    mark("flow_backward")
    return FlowWithOcclusion(flow=fw, backward=bw, occlusion=occ,
                             ambiguous=fw_aux.ambiguous,
                             alt_flow=fw_aux.alt_flow)
