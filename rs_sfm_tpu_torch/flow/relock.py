"""Periodic-texture disambiguation: model-guided flow relock (port of
rs_sfm_tpu/flow/relock.py).

On a strictly periodic texture every period-shifted displacement is a
perfect photometric match: the discrete searches lock on a wrong period,
the forward-backward test agrees with the wrong lock, and the wrong-locked
walls can out-vote the true motion in RANSAC.  The searches export where
they had no information (`FlowAux.ambiguous`) and the best alternative
lock (`alt_flow`), and `flow_with_relock` uses both:

  1. flow with its ambiguity mask; if at least `trigger_frac` of the
     pixels are ambiguous, the dominant period vector p̂ is the median of
     the sign-canonicalised separations alt_flow - flow over the
     ambiguous pixels, and the shift family flow + n p̂ (n = -2..2, on the
     ambiguous pixels only) is scored by a short estimation each; the
     first strict best (inliers, then least refinement cost) wins;
  2. the winner's rigid-model flow (flow/feedback.py::model_feedback)
     becomes the prior of a second dense-flow pass (the discrete searches'
     tie-break, ops/kernels/match.py), and the production estimation runs
     on that flow.

A scene under the trigger keeps the single pass, bit for bit.  The JAX
package records the full-HD periodic-texture probe (STRESS.md, "reptex")
as unsolved: the relock runs, but no n p̂ family contains the truth there.
tests/test_torch_relock.py holds this module to the JAX package's on the
CPU, with the JAX draws handed over.

Draws: the JAX package derives each stage's key from the caller's
(fold_in(key, 100 + n) for the shift family, fold_in(key, 7) for the final
estimation).  The port derives one generator per stage the same way
(solver/pipeline.fold_generator), or takes `sample_indices(stage, valid)`,
stage being the tuple of integers folded into the caller's key for that
draw.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.flow.dense import (FlowWithOcclusion, as_device_tensor,
                                         flow_forward_backward)
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver.pipeline import (EstimationResult,
                                              estimate_with_feedback,
                                              fold_generator)

# The shift family n p̂, in the order the vote visits it.
SHIFTS = (-2, -1, 0, 1, 2)


class RelockResult(NamedTuple):
    fb: FlowWithOcclusion         # the second pass's flow (pass 1's if the
    #                               trigger did not fire)
    result: EstimationResult      # the final estimation
    first_pass: EstimationResult  # the winning shift's estimation (pass 1)
    ambiguous_frac: torch.Tensor  # () share of pass 1's ambiguous pixels
    period: Optional[torch.Tensor] = None  # (2,) p̂ (None: no trigger)
    shift: Optional[int] = None   # the winning n (None: no trigger)
    prior: Optional[torch.Tensor] = None  # (H, W, 2) the second pass's
    #                               prior, the winner's model flow


def nanmedian(x):
    """The median of x's non-NaN values, the mean of the two middle ones
    for an even count (jnp.nanmedian's "midpoint": (lo + hi) * 0.5;
    torch.nanmedian returns the lower one); NaN if every value is NaN."""
    vals = torch.sort(x[~torch.isnan(x)]).values
    n = vals.numel()
    if n == 0:
        return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return (vals[(n - 1) // 2] + vals[n // 2]) * 0.5


def period_estimate(flow, alt_flow, ambiguous):
    """p̂ (2,): the per-axis median over the ambiguous pixels of the
    separations alt_flow - flow, each turned to point along +x
    (sign(dx + 1e-6 dy))."""
    sep = alt_flow - flow
    flip = torch.sign(sep[..., 0] + 1e-6 * sep[..., 1])
    sep_c = sep * flip[..., None]
    nan = torch.full_like(sep_c[..., 0], float("nan"))
    return torch.stack([nanmedian(torch.where(ambiguous, sep_c[..., i], nan))
                        for i in (0, 1)])


def flow_with_relock(image1, image2, flow_cfg: DenseFlowConfig,
                     intr: Intrinsics, gamma, cfg: PipelineConfig,
                     generator: Optional[torch.Generator] = None, *,
                     trigger_frac: float = 0.25, force: bool = False,
                     sample_indices: Optional[Callable] = None,
                     timer: Optional[Callable[[str], None]] = None,
                     ) -> RelockResult:
    """Two-pass flow with the rigid-model relock of ambiguous regions.

    Args:
      image1, image2: (H, W[, 3]) float frames in [0, 1] (tensors stay on
        their device; arrays go to the CUDA device).
      flow_cfg: dense-flow configuration.
      intr, gamma, cfg: the estimation context.
      generator: torch.Generator for RANSAC; each stage draws from
        fold_generator(generator, data), data as the JAX package folds
        into its key (100 + n, 7).
      trigger_frac: run the second pass only when at least this share of
        pass 1's pixels is ambiguous (a host check).
      force: always run the second pass.
      sample_indices: optional callable f(stage, valid) -> (trials, 9)
        draws that replace the generators': stage is the tuple of integers
        the JAX package folds into the caller's key for that draw ((),
        (100 + n,), (7,), and (..., 100 + p) for feedback pass p >= 1 of
        a "full" estimation), valid the (H*W,) bool pixels it draws from.
      timer: optional callback, called after each stage is issued with
        "flow1", then (when the second pass runs) "shift_scores",
        "model_feedback", "flow2", and "estimate" after the final
        estimation.

    Returns:
      RelockResult.  When the trigger does not fire, `fb` and `result` are
      pass 1's (the single-pass result, bit-identical).
    """
    from rs_sfm_tpu_torch.flow.feedback import model_feedback

    mark = timer if timer is not None else (lambda _name: None)

    def draws(stage):
        """The sample_indices of an estimate_with_feedback call whose key
        is the caller's folded by `stage`."""
        if sample_indices is None:
            return None
        return lambda p, valid: sample_indices(
            stage + ((100 + p,) if p else ()), valid)

    image1 = as_device_tensor(image1, dtype=torch.float32)
    image2 = as_device_tensor(image2, image1.device, torch.float32)
    fb1 = flow_forward_backward(image1, image2, flow_cfg)
    mark("flow1")
    amb = fb1.ambiguous
    amb_frac = amb.float().mean()
    if not force and float(amb_frac) < trigger_frac:
        res1 = estimate_with_feedback(fb1.flow, intr, gamma, cfg, generator,
                                      sample_indices=draws(()),
                                      pixel_mask=~fb1.occlusion)
        mark("estimate")
        return RelockResult(fb=fb1, result=res1, first_pass=res1,
                            ambiguous_frac=amb_frac)

    # The wrong lock differs from the truth by whole period vectors, and
    # the period is the separation of the searches' top two locks: score
    # the shift family flow + n p̂ by rigid consensus.
    p_hat = period_estimate(fb1.flow, fb1.alt_flow, amb)
    score_cfg = dataclasses.replace(
        cfg, ransac_trials=min(cfg.ransac_trials, 128), refine_starts=1,
        refine_iterations=8, feedback_passes=0)
    best = None
    for n in SHIFTS:
        flow_n = torch.where(amb[..., None], fb1.flow + float(n) * p_hat,
                             fb1.flow)
        # estimate_from_flow, with the draws on its trusted pixels (no
        # feedback pass in score_cfg).
        res_n = estimate_with_feedback(
            flow_n, intr, gamma, score_cfg,
            fold_generator(generator, 100 + n),
            sample_indices=draws((100 + n,)), pixel_mask=~fb1.occlusion)
        cand = (int(res_n.num_inliers), float(res_n.refine_cost), n, flow_n,
                res_n)
        if best is None or (cand[0], -cand[1]) > (best[0], -best[1]):
            best = cand
    n_win, flow_b, res1 = best[2], best[3], best[4]
    mark("shift_scores")

    # The winning model's flow everywhere (anchor-inpainted depth) is the
    # prior of the second pass: the searches' ties snap to the period the
    # model agrees with.
    fbk = model_feedback(flow_b, fb1.occlusion, res1, intr, gamma, cfg)
    mark("model_feedback")
    fb2 = flow_forward_backward(image1, image2, flow_cfg, prior=fbk.model_flow)
    mark("flow2")
    res2 = estimate_with_feedback(fb2.flow, intr, gamma, cfg,
                                  fold_generator(generator, 7),
                                  sample_indices=draws((7,)),
                                  pixel_mask=~fb2.occlusion)
    mark("estimate")
    return RelockResult(fb=fb2, result=res2, first_pass=res1,
                        ambiguous_frac=amb_frac, period=p_hat, shift=n_win,
                        prior=fbk.model_flow)
