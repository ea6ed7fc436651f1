"""Model-feedback occlusion masking and flow correction (port of
rs_sfm_tpu/flow/feedback.py).

Background pixels next to a moving foreground edge inherit the foreground's
flow (the occlusion smear band), and the forward-backward test agrees with
that wrong flow.  The rigid rolling-shutter model does not: such pixels
are its outliers.  `model_feedback` extends the untrusted mask by the
model's outliers (tight-consensus residual, RANSAC outliers, and a
near-side depth-coherence test against a coarse neighbourhood) and
replaces their flow by the model's prediction from push-pull-inpainted
inverse depth.  `estimate_with_feedback` (solver/pipeline.py) re-estimates
on the surviving pixels.

The flow's prepared inputs (`prepare_flow_inputs`) are computed once and
shared; the decimated inpainting (`feedback_fast_inpaint`) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.flow.dense import (_downsample, _gauss_blur,
                                         _resize_bilinear)
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.depth import estimate_inverse_depth
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.pipeline import (EstimationResult,
                                              prepare_flow_inputs)


class FeedbackResult(NamedTuple):
    flow: torch.Tensor           # (H, W, 2) corrected pixel flow
    occlusion: torch.Tensor      # (H, W) bool: extended untrusted mask
    model_flow: torch.Tensor     # (H, W, 2) rigid-model flow
    outlier: torch.Tensor        # (H, W) bool: model-outlier extension
    depth_outlier: torch.Tensor  # (H, W) bool: depth-coherence extension
    trusted_depth: torch.Tensor  # (H, W) bool: inliers surviving both


def _coarse_smooth(values, weights, down: int = 3, blurs: int = 3):
    """Normalised convolution at a coarse scale (aperture ~ 2^down * 2 *
    blurs px), wider than a smear band; numerator and denominator run as
    one (2, H, W) batch."""
    nd = torch.stack([values * weights, weights])
    shapes = []
    for _ in range(down):
        shapes.append(tuple(nd.shape[-2:]))
        nd = _downsample(_gauss_blur(nd))
    for _ in range(blurs):
        nd = _gauss_blur(nd)
    sm = nd[0] / torch.clamp(nd[1], min=1e-9)
    for shape in reversed(shapes):
        sm = _resize_bilinear(sm, shape)
    return sm


def _push_pull_fill(values, weights, levels: int = 6):
    """Normalised-convolution push-pull inpainting: weight-0 pixels take the
    finest scale's weighted average that has support."""
    nd = torch.stack([values * weights, weights])
    stack = []
    for _ in range(levels):
        nd = _gauss_blur(nd)
        stack.append(nd)
        nd = nd[:, ::2, ::2]
    fill = nd[0] / torch.clamp(nd[1], min=1e-12)
    for nd_l in reversed(stack):
        up = _resize_bilinear(fill, tuple(nd_l.shape[-2:]))
        fill = torch.where(nd_l[1] > 1e-6,
                           nd_l[0] / torch.clamp(nd_l[1], min=1e-12), up)
    return fill


def model_feedback(flow_px, occlusion, res: EstimationResult,
                   intr: Intrinsics, gamma, cfg: PipelineConfig, *,
                   fill_levels: int = 6, depth_tau: float = 0.5,
                   depth_rounds: int = 2, residual_tol_px: float = 2.0,
                   prepared=None) -> FeedbackResult:
    """Extend the occlusion mask by the model's outliers and correct their
    flow (rs_sfm_tpu/flow/feedback.py:139-252).

    Args:
      flow_px: (H, W, 2) first-pass dense flow (pixels).
      occlusion: (H, W) bool first-pass untrusted mask.
      res: the estimation on this flow.
      intr, gamma, cfg: the estimation context.
      depth_tau: relative near-side inverse-depth inflation flagged as
        incoherent; depth_rounds: peel iterations (0 disables the test).
      residual_tol_px: the tight product tolerance.
      prepared: optional `prepare_flow_inputs(flow_px, intr, gamma, cfg)`.
    """
    if cfg.feedback_fast_inpaint:
        raise NotImplementedError("the decimated feedback inpainting is not "
                                  "ported")
    h, w_cols = flow_px.shape[:2]
    dtype = flow_px.dtype
    dev = flow_px.device

    depth = res.depth_map
    inl = res.inlier_mask & (depth != 0.0)
    rho_pix = torch.where(
        inl, 1.0 / torch.where(depth == 0.0, torch.ones_like(depth), depth),
        0.0)

    # Depth-coherence peeling (signed near-side test).
    trust = inl
    depth_out = torch.zeros_like(inl)
    for _ in range(depth_rounds):
        rho_sm = _coarse_smooth(rho_pix, trust.to(dtype))
        bad = trust & (rho_pix > rho_sm * (1.0 + depth_tau))
        depth_out = depth_out | bad
        trust = trust & ~bad

    # Inpainted inverse depth from the surviving anchors.
    rho_fill = _push_pull_fill(rho_pix, trust.to(dtype), levels=fill_levels)

    # Rigid-model flow at every pixel, with one re-evaluation of alpha at
    # the model's own y flow.
    if prepared is None:
        prepared = prepare_flow_inputs(flow_px, intr, gamma, cfg)
    coords, flow_obs_n, alpha, alpha_k, _ = prepared
    rho_flat = rho_fill.reshape(-1)
    fscale = torch.tensor([intr.fx, intr.fy], dtype=dtype, device=dev)
    grid_y = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(
        h, w_cols).reshape(-1)
    model_n = predict_flow(coords, rho_flat, res.v, res.w, res.k, alpha,
                           alpha_k)
    fy_px = model_n[:, 1] * intr.fy
    alpha2 = get_alpha(fy_px, h, gamma)
    if cfg.use_global_shutter:
        alpha2 = torch.ones_like(alpha2)
    alpha_k2 = get_alpha_k(grid_y, fy_px, h, gamma)
    model_n = predict_flow(coords, rho_flat, res.v, res.w, res.k, alpha2,
                           alpha_k2)
    model_px = (model_n * fscale).reshape(h, w_cols, 2)

    # Model-outlier extension: RANSAC outliers among the valid pixels, and
    # pixels whose best-depth residual exceeds the tight tolerance.
    rho_best = estimate_inverse_depth(coords, flow_obs_n, res.v, res.w,
                                      res.k, alpha, alpha_k)
    u_best = predict_flow(coords, rho_best, res.v, res.w, res.k, alpha,
                          alpha_k)
    fmean = torch.sqrt(torch.tensor(intr.fx * intr.fy, dtype=dtype,
                                    device=dev))
    diff = u_best - flow_obs_n
    resid_px = (torch.sqrt(torch.sum(diff * diff, dim=-1))
                * fmean).reshape(h, w_cols)
    tight_out = res.valid_mask & (resid_px > residual_tol_px)
    outlier = (res.valid_mask & ~res.inlier_mask) | tight_out
    occ_ext = occlusion | outlier | depth_out

    flow_out = torch.where(occ_ext[..., None], model_px, flow_px)
    return FeedbackResult(flow=flow_out, occlusion=occ_ext,
                          model_flow=model_px, outlier=outlier,
                          depth_outlier=depth_out, trusted_depth=trust)
