"""Automatic flow-preset selection, `--flow-model auto` (port of
rs_sfm_tpu/flow/auto.py).

The LCN-robust preset costs accuracy on clean scenes, while the plain
variational preset breaks under photometric nuisance.  `probe_flow_preset`
picks one per pair from a cheap probe at 1/8 scale:

  * a small plain forward-backward flow (`DenseFlowConfig(levels=4,
    iters=12, warps=2)`, through the kernels B4, B5 and B6 on the card);
  * the share of pixels the forward-backward test flags as occluded;
  * the aligned log-gain field log(blur(I1) / blur(I2 warped by the flow))
    on the unoccluded pixels: a photometric change shows as a biased
    (|median|) or spread (90th - 10th percentile) field.

The thresholds are the JAX package's (its module docstring gives the
measured per-scene values they separate); the occlusion trigger is off.
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.flow.dense import (_downsample, _gauss_blur, _to_gray,
                                         as_device_tensor,
                                         flow_forward_backward)
from rs_sfm_tpu_torch.ops.kernels import warp as kwarp

OCC_THRESHOLD = None
GAIN_SPREAD_THRESHOLD = 0.04
GAIN_BIAS_THRESHOLD = 0.015
PROBE_CONFIG = DenseFlowConfig(levels=4, iters=12, warps=2)


def _probe_stats(i1, i2, cfg: DenseFlowConfig = PROBE_CONFIG):
    """(occluded share, |median log-gain|, 90th - 10th percentile log-gain)
    of the gray (H, W) float32 pair, as float32 tensors () on its device.

    The quantiles are the JAX function's: the log-gain of occluded pixels
    is set to +inf, the field sorted, and quantile p read at index
    int(float32(p) * float32(n_ok)) (at most the last), n_ok the
    unoccluded count (at least 1)."""
    fb = flow_forward_backward(i1, i2, cfg)
    occ_frac = torch.mean(fb.occlusion.to(torch.float32))
    i2w = kwarp.warp(i2, fb.flow)
    b1 = _gauss_blur(_gauss_blur(i1))
    b2 = _gauss_blur(_gauss_blur(i2w))
    lg = torch.log((b1 + 1e-2) / (b2 + 1e-2))
    m = ~fb.occlusion
    n_ok = torch.clamp(torch.sum(m), min=1).to(torch.float32)
    flat = torch.where(m, lg, torch.inf).reshape(-1)
    srt = torch.sort(flat).values
    last = flat.shape[0] - 1

    def q(p):
        at = (torch.tensor(p, dtype=torch.float32, device=flat.device)
              * n_ok).to(torch.int64)
        return srt[torch.clamp(at, max=last)]

    return occ_frac, torch.abs(q(0.5)), q(0.9) - q(0.1)


def probe_flow_preset(image1, image2, *, downsamples: int = 3,
                      occ_threshold: float = OCC_THRESHOLD,
                      gain_spread_threshold: float = GAIN_SPREAD_THRESHOLD,
                      gain_bias_threshold: float = GAIN_BIAS_THRESHOLD,
                      return_stats: bool = False):
    """Choose "variational" (plain) or "robust" (LCN) for this pair.

    Args:
      image1, image2: (H, W[, 3]) float frames in [0, 1]: tensors on the
        device to run on, or arrays, which go to the CUDA device (without
        one this raises).
      downsamples: pyramid downsamples before the probe (3 = 1/8 scale);
        it stops early below 64 pixels a side.

    Returns the preset name, or (name, stats dict) with return_stats.
    """
    i1 = _to_gray(as_device_tensor(image1, dtype=torch.float32))
    i2 = _to_gray(as_device_tensor(image2, i1.device, torch.float32))
    for _ in range(downsamples):
        if min(i1.shape) < 64:
            break  # keep the probe statistically meaningful on small pairs
        i1 = _downsample(i1)
        i2 = _downsample(i2)
    occ_frac, bias, spread = (float(x) for x in _probe_stats(i1, i2))
    robust = (spread > gain_spread_threshold
              or bias > gain_bias_threshold
              or (occ_threshold is not None and occ_frac > occ_threshold))
    name = "robust" if robust else "variational"
    if return_stats:
        return name, {"occ_frac": occ_frac, "gain_bias": bias,
                      "gain_spread": spread}
    return name
