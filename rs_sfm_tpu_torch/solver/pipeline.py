"""End-to-end motion/depth estimation from a dense flow field (port of
rs_sfm_tpu/solver/pipeline.py).

flatten → normalize → α/α̃ → RANSAC → fused Schur-LM refinement (one start,
or J diversity starts winnowed to one) → sign flip → depth export
(src/main.cc:398-509), and `estimate_with_feedback`, the production entry
point that adds the model-feedback passes (flow/feedback.py) with
warm-started refinement.  Every tensor stays on the flow field's device; on
the card the scoring and LM iterations run the hand-written kernels.

Under scanline-block sharding (`group`, parallel/api.py::estimate_sharded)
each rank runs this function on its block of rows: RANSAC shares its
sample pool and votes, the refinement all-reduces its sums, and the
re-votes, inlier counts and sign flip sum over the group, so every scalar
output is the same on all ranks and the per-pixel outputs are the rank's
rows.

Not ported yet: the acceleration model and its k-scan, the second winnow
stage, the two-stage prescore, the XLA-style refinement engine, and of the
feedback options the basin re-vote, the decimated inpainting and the
"full" re-estimation mode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.geom.camera import (Intrinsics, normalize_coords,
                                          normalize_flow, pixel_grid)
from rs_sfm_tpu_torch.parallel.distributed import psum
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.ransac import (RansacResult, _score_hypotheses,
                                            ransac)
from rs_sfm_tpu_torch.solver.refine_fused import (
    refine_pallas, refine_pallas_multi, refine_pallas_multi_sharded)


class EstimationResult(NamedTuple):
    v: torch.Tensor            # (3,)
    w: torch.Tensor            # (3,)
    k: torch.Tensor            # ()
    depth_map: torch.Tensor    # (H, W) Z = 1/ρ at exported pixels, 0 elsewhere
    inlier_mask: torch.Tensor  # (H, W) bool
    valid_mask: torch.Tensor   # (H, W) bool (|flow|² > threshold)
    num_inliers: torch.Tensor  # () int32
    ransac_v: torch.Tensor     # (3,) pre-refinement estimates
    ransac_w: torch.Tensor
    ransac_k: torch.Tensor
    refine_cost: torch.Tensor  # () final refinement cost (0 without refinement)
    # Row 0 is the exported model; rows 1.. the winnow-stage refined
    # diversity starts (multi-start path only; not sign-flipped).
    top_v: torch.Tensor
    top_w: torch.Tensor
    top_k: torch.Tensor


def prepare_flow_inputs(flow_px, intr: Intrinsics, gamma, cfg: PipelineConfig,
                        *, row_offset=None, total_rows: Optional[int] = None):
    """Flatten + normalize the flow grid and compute the RS factors
    (src/main.cc:398-434; flow normalized without the γ premultiply).

    Args:
      row_offset: global row of this block's first row under scanline-block
        sharding (the grid's y and α̃ use global rows); None = the block is
        the whole image.
      total_rows: the image's row count for the α/α̃ readout-time scaling
        (default: the block's own height, right only when unsharded).

    Returns (coords (N,2), flow_n (N,2), alpha (N,), alpha_k (N,),
    valid (N,) bool).
    """
    h, w_cols = flow_px.shape[:2]
    grid = pixel_grid(h, w_cols, dtype=flow_px.dtype, device=flow_px.device)
    if row_offset is not None:
        grid[..., 1] += row_offset
    rows = total_rows if total_rows is not None else h
    coords = normalize_coords(grid, intr).reshape(-1, 2)
    flow_n = normalize_flow(flow_px, intr).reshape(-1, 2)
    fpx = flow_px.reshape(-1, 2)
    valid = torch.sum(fpx * fpx, dim=-1) > cfg.flow_threshold
    alpha = get_alpha(fpx[:, 1], rows, gamma)
    alpha_k = get_alpha_k(grid[..., 1].reshape(-1), fpx[:, 1], rows, gamma)
    if cfg.use_global_shutter:
        alpha = torch.ones_like(alpha)  # GS baseline (src/errorMeasure.cpp:106-111)
    return coords, flow_n, alpha, alpha_k, valid


def _check_supported(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError for the options this port leaves out."""
    if cfg.use_acceleration and not cfg.use_global_shutter:
        raise NotImplementedError("the acceleration model is not ported yet")
    if cfg.ransac_prescore_subsample:
        raise NotImplementedError("the RANSAC prescore is not ported yet")
    if cfg.refine_winnow2_iters:
        raise NotImplementedError("the second winnow stage is not ported")
    if cfg.use_refinement and cfg.refine_engine != "pallas":
        raise NotImplementedError(
            "only the fused refinement (refine_engine='pallas') is ported")
    if cfg.feedback_passes > 0:
        if cfg.feedback_revote:
            raise NotImplementedError("the feedback basin re-vote is not "
                                      "ported")
        if cfg.feedback_fast_inpaint:
            raise NotImplementedError("the decimated feedback inpainting is "
                                      "not ported")
        if cfg.feedback_mode != "refine":
            raise NotImplementedError(
                f"feedback_mode {cfg.feedback_mode!r} is not ported (only "
                f"'refine')")


def estimate_from_flow(flow_px, intr: Intrinsics, gamma, cfg: PipelineConfig,
                       generator: Optional[torch.Generator] = None, *,
                       sample_indices=None, pixel_mask=None, warm_start=None,
                       prepared=None, group=None, row_offset=None,
                       total_rows: Optional[int] = None,
                       timer: Optional[Callable[[str], None]] = None,
                       ) -> EstimationResult:
    """Full estimation: flow grid → (v, w, k) + depth map.

    Args:
      flow_px: (H, W, 2) float32 dense pixel flow, on the device to run on.
      intr: intrinsics; gamma: readout ratio; cfg: configuration.
      generator: torch.Generator (on flow_px's device) for RANSAC sampling.
      sample_indices: optional (ransac_trials, 9) precomputed RANSAC draws;
        overrides `generator` (the tests inject the JAX package's draws).
      pixel_mask: optional (H, W) bool of trusted pixels (e.g. ~occlusion),
        ANDed into the validity mask before RANSAC and refinement.
      warm_start: optional (v, w, k) initial model.  Skips RANSAC and the
        multi-start schedule: the model is scored on all pixels for its
        inlier set and refined as a single start (the feedback passes).
      prepared: optional `prepare_flow_inputs(flow_px, intr, gamma, cfg)`
        result, computed once by a caller that needs it again.
      group: process group when flow_px is this rank's scanline block of a
        sharded image (None = the whole image); RANSAC draws from the
        shared pool of cfg.ransac_sample_pool pixels per rank.
      row_offset, total_rows: the block's first global row and the image's
        row count (see prepare_flow_inputs); needed with `group`.
      timer: optional callback, called with "prepare", "ransac" and
        "refine" as each stage has been issued (stage timing with CUDA
        events; nothing is synchronized here).
    """
    _check_supported(cfg)
    mark = timer if timer is not None else (lambda _name: None)
    h, w_cols = flow_px.shape[:2]
    use_k = False
    tol = cfg.ransac_tol
    if prepared is None:
        prepared = prepare_flow_inputs(flow_px, intr, gamma, cfg,
                                       row_offset=row_offset,
                                       total_rows=total_rows)
    coords, flow_n, alpha, alpha_k, valid = prepared
    if pixel_mask is not None:
        valid = valid & pixel_mask.reshape(-1)
    mark("prepare")

    if warm_start is not None:
        v_ws, w_ws, k_ws = (torch.as_tensor(a, device=coords.device).to(
            coords.dtype) for a in warm_start)
        num_ws, err_ws, rho_ws, inl_ws = _score_hypotheses(
            coords, flow_n, alpha, alpha_k, valid, v_ws[None], w_ws[None],
            k_ws.reshape(1), tol)
        rr = RansacResult(v=v_ws, w=w_ws, k=k_ws.reshape(()),
                          inv_depth=rho_ws[0], inlier_mask=inl_ws[0],
                          num_inliers=psum(num_ws[0], group),
                          inlier_error=psum(err_ws[0], group),
                          top_v=v_ws[None], top_w=w_ws[None],
                          top_k=k_ws.reshape(1))
    else:
        rr = ransac(coords, flow_n, alpha, alpha_k, valid, use_k=use_k,
                    trials=cfg.ransac_trials, tolerance=tol,
                    generator=generator, sample_indices=sample_indices,
                    chunk=cfg.ransac_chunk, engine=cfg.ransac_engine,
                    top_j=cfg.refine_starts if cfg.use_refinement else 1,
                    top_j_diversity=cfg.refine_start_diversity,
                    group=group, sample_pool=cfg.ransac_sample_pool)
    mark("ransac")

    # Huber knee in normalized units.
    loss_delta = (cfg.refine_loss_delta_px / float((intr.fx * intr.fy) ** 0.5)
                  if cfg.refine_loss_delta_px > 0.0 else 0.0)

    def score(vs, ws, ks):
        return _score_hypotheses(coords, flow_n, alpha, alpha_k, valid,
                                 vs, ws, ks, tol)

    def refine(masks, vs, ws, ks, rhos, iters):
        """J-start refinement: the sharded LM under `group`."""
        kwargs = dict(optimize_k=use_k, iterations=iters,
                      rel_tol=cfg.refine_rel_tol, loss_delta=loss_delta)
        if group is not None:
            return refine_pallas_multi_sharded(
                coords, flow_n, alpha, alpha_k, masks, vs, ws, ks, rhos,
                group=group, **kwargs)
        return refine_pallas_multi(coords, flow_n, alpha, alpha_k, masks, vs,
                                   ws, ks, rhos, **kwargs)

    no_cands = torch.zeros((0, 3), dtype=coords.dtype, device=coords.device)
    inlier_mask, num_inliers = rr.inlier_mask, rr.num_inliers
    if cfg.use_refinement and cfg.refine_starts > 1 and warm_start is None:
        # Multi-start: refine all top-J hypotheses as one batched problem,
        # re-score each refined model on all pixels, keep the exact
        # lexicographic best (#inliers desc, error asc; ties to the
        # earliest start).
        _, _, rho_j, inl_j = score(rr.top_v, rr.top_w, rr.top_k)
        winnow = (cfg.refine_winnow_iters
                  if 0 < cfg.refine_winnow_iters < cfg.refine_iterations
                  else 0)

        def rescore(ref):
            num_r, err_r, rho_r, inl_r = score(ref.v, ref.w, ref.k)
            if group is not None:
                # ONE all-reduce of the stacked vote table.
                votes = psum(torch.stack([num_r.to(err_r.dtype), err_r],
                                         dim=-1), group)
                num_r, err_r = votes[:, 0], votes[:, 1]
            num_g = num_r.to(err_r.dtype)
            err_g = torch.where(torch.isfinite(err_r), err_r, torch.inf)
            err_masked = torch.where(num_g == torch.max(num_g), err_g,
                                     torch.inf)
            return torch.argmin(err_masked), num_g, rho_r, inl_r

        ref = refine(inl_j, rr.top_v, rr.top_w, rr.top_k, rho_j,
                     winnow if winnow else cfg.refine_iterations)
        best_j, num_g, rho_r, inl_r = rescore(ref)
        cand_v, cand_w, cand_k = ref.v, ref.w, ref.k
        if winnow:
            # Finish the winner alone from its winnow-phase state.
            ref = refine(inl_r[best_j][None], ref.v[best_j][None],
                         ref.w[best_j][None], ref.k[best_j][None],
                         rho_r[best_j][None], cfg.refine_iterations - winnow)
            best_j, num_g, rho_r, inl_r = rescore(ref)
        v, w, k = ref.v[best_j], ref.w[best_j], ref.k[best_j]
        rho = rho_r[best_j]
        refine_cost = ref.cost[best_j]
        inlier_mask = inl_r[best_j]
        num_inliers = num_g[best_j].to(torch.int32)
    elif cfg.use_refinement:
        if group is not None:
            ref = refine(rr.inlier_mask[None], rr.v[None], rr.w[None],
                         rr.k.reshape(1), rr.inv_depth[None],
                         cfg.refine_iterations)
            ref = ref._replace(v=ref.v[0], w=ref.w[0], k=ref.k[0],
                               cost=ref.cost[0])
        else:
            ref = refine_pallas(coords, flow_n, alpha, alpha_k,
                                rr.inlier_mask, rr.v, rr.w, rr.k,
                                rr.inv_depth, optimize_k=use_k,
                                iterations=cfg.refine_iterations,
                                rel_tol=cfg.refine_rel_tol,
                                loss_delta=loss_delta)
        v, w, k = ref.v, ref.w, ref.k
        refine_cost = ref.cost
        cand_v = cand_w = no_cands
        cand_k = no_cands[:, 0]
        # Export the closed-form ρ at the refined motion with a re-scored
        # inlier set (the multi-start export semantics).
        num_1, _, rho_1, inl_1 = score(v[None], w[None], k[None])
        rho = rho_1[0]
        inlier_mask, num_inliers = inl_1[0], psum(num_1[0], group)
    else:
        v, w, k, rho = rr.v, rr.w, rr.k, rr.inv_depth
        refine_cost = torch.zeros((), dtype=coords.dtype,
                                  device=coords.device)
        cand_v = cand_w = no_cands
        cand_k = no_cands[:, 0]
    mark("refine")

    # Sign disambiguation: flip v and depths if the mean inlier depth is
    # negative (src/main.cc:466-478).
    safe_rho = torch.where(rho == 0.0, torch.ones_like(rho), rho)
    z = torch.where(rho == 0.0, torch.zeros_like(rho), 1.0 / safe_rho)
    m = inlier_mask.to(z.dtype)
    z_mean = (psum(torch.sum(z * m), group)
              / torch.clamp(psum(torch.sum(m), group), min=1.0))
    sign = torch.where(z_mean < 0.0, -1.0, 1.0).to(z.dtype)
    v = v * sign
    z = z * sign

    depth_sel = inlier_mask
    if cfg.depth_residual_px > 0.0:
        # Tight-consensus depth export: keep only inliers whose flow the
        # final model fits within depth_residual_px pixels.
        u_fin = predict_flow(coords, rho, v * sign, w, k, alpha, alpha_k)
        fmean = torch.sqrt(torch.tensor(intr.fx * intr.fy,
                                        dtype=coords.dtype,
                                        device=coords.device))
        diff = u_fin - flow_n
        resid_px = torch.sqrt(torch.sum(diff * diff, dim=-1)) * fmean
        depth_sel = depth_sel & (resid_px <= cfg.depth_residual_px)

    depth_map = torch.where(depth_sel, z, torch.zeros_like(z)).reshape(
        h, w_cols)
    return EstimationResult(
        v=v, w=w, k=k, depth_map=depth_map,
        inlier_mask=inlier_mask.reshape(h, w_cols),
        valid_mask=valid.reshape(h, w_cols),
        num_inliers=num_inliers, ransac_v=rr.v * sign, ransac_w=rr.w,
        ransac_k=rr.k, refine_cost=refine_cost,
        top_v=torch.cat([v[None], cand_v]),
        top_w=torch.cat([w[None], cand_w]),
        top_k=torch.cat([k[None], cand_k]))


def estimate_with_feedback(flow_px, intr: Intrinsics, gamma,
                           cfg: PipelineConfig,
                           generator: Optional[torch.Generator] = None, *,
                           sample_indices=None, pixel_mask=None,
                           timer: Optional[Callable[[str], None]] = None,
                           ) -> EstimationResult:
    """Estimation with the model-feedback passes (the production entry
    point; equals estimate_from_flow when cfg.feedback_passes = 0).

    Pass 1 is `estimate_from_flow` on the caller's trusted mask (with its
    `generator` / `sample_indices`).  Each feedback pass then extends the
    untrusted set with the tight-consensus, RANSAC and depth-coherence
    outliers of the current model (flow/feedback.py::model_feedback) and
    re-estimates on the surviving pixels, warm-started from the current
    model: one single-start refinement of cfg.feedback_refine_iterations
    iterations (cfg.refine_iterations if 0), no second RANSAC.  The flow's
    prepared inputs are computed once for all passes.

    `timer`, if given, is called with "estimate" after pass 1 and
    "feedback" after the last pass.
    """
    _check_supported(cfg)
    from rs_sfm_tpu_torch.flow.feedback import model_feedback

    mark = timer if timer is not None else (lambda _name: None)
    prepared = prepare_flow_inputs(flow_px, intr, gamma, cfg)
    res = estimate_from_flow(flow_px, intr, gamma, cfg, generator,
                             sample_indices=sample_indices,
                             pixel_mask=pixel_mask, prepared=prepared)
    mark("estimate")
    if cfg.feedback_passes <= 0:
        return res
    h, w_cols = flow_px.shape[:2]
    cfg_p = cfg
    if cfg.feedback_refine_iterations > 0:
        cfg_p = dataclasses.replace(
            cfg, refine_iterations=cfg.feedback_refine_iterations)
    for _ in range(cfg.feedback_passes):
        occ0 = (~pixel_mask if pixel_mask is not None else torch.zeros(
            (h, w_cols), dtype=torch.bool, device=flow_px.device))
        fbk = model_feedback(flow_px, occ0, res, intr, gamma, cfg,
                             residual_tol_px=cfg.feedback_residual_tol_px,
                             prepared=prepared)
        pixel_mask = ~fbk.occlusion
        res = estimate_from_flow(flow_px, intr, gamma, cfg_p,
                                 pixel_mask=pixel_mask,
                                 warm_start=(res.v, res.w, res.k),
                                 prepared=prepared)
    mark("feedback")
    return res
