"""Vectorized RANSAC over the 9-point minimal solver (port of
rs_sfm_tpu/solver/ransac.py:81-414).

Hypotheses are a batch axis: all trials run through the batched minimal
solver at once and are scored on every pixel, either by the scoring kernel
(engine "pallas": ops/kernels/score.py) or by plain tensor ops in chunks
(engine "xla").  The best hypothesis is the exact two-stage lexicographic
pick (#inliers desc, then inlier error asc, ties to the earliest trial —
src/minimal.cc:278); multi-start refinement gets the diversity-filtered
top-J.

Sampling draws from a `torch.Generator`.  Its stream differs from
jax.random's, so `sample_indices=` injects precomputed draws (the tests
hand both packages the JAX package's `sample_valid_indices`).

With the acceleration model (`use_k`) each sample gives either one
hypothesis, k by the reference's min-|real root| rule (k_mode "min"), or
one per root of det Z(k) = 0 (k_mode "score": 6 per sample, a complex
root's slot zeroed and voted −1).  The optional prescore ranks every
hypothesis on a stratified pixel subsample and scores only the best
`prescore_keep` on all pixels.

Under scanline-block sharding (`group`), hypotheses are drawn from a pool
of pixels shared by all ranks (`shared_sample_pool`; with the acceleration
model the pool carries α̃ and every rank expands the same samples into the
same all-k hypotheses), each rank scores them on its own pixels, and the
(T, 2) vote table is summed over the group in one all-reduce.  The
prescore does the same on each rank's stratified subsample of its block:
one all-reduce of its (T, 2) table ranks the hypotheses on the union of
the subsamples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rs_sfm_tpu_torch.config import CORE_DTYPE
from rs_sfm_tpu_torch.ops.kernels.score import (pack_hyps, pack_pixels,
                                                score_hypotheses)
from rs_sfm_tpu_torch.parallel.distributed import (axis_index, axis_size,
                                                   broadcast, psum)
from rs_sfm_tpu_torch.solver.depth import estimate_inverse_depth
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.minimal import (calculate_velocities,
                                             calculate_velocities_all_k)


class RansacResult(NamedTuple):
    """Best-hypothesis output (the reference's RansacValues,
    src/minimal.h:57-76, with masks instead of compacted inlier arrays)."""

    v: torch.Tensor            # (3,) linear velocity (unit-scale ambiguous)
    w: torch.Tensor            # (3,) angular velocity
    k: torch.Tensor            # () acceleration factor
    inv_depth: torch.Tensor    # (N,) closed-form ρ for every pixel
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    inlier_error: torch.Tensor  # () summed residual over inliers
    top_v: torch.Tensor = None  # (J, 3) multi-start inputs
    top_w: torch.Tensor = None  # (J, 3)
    top_k: torch.Tensor = None  # (J,)


def shared_sample_pool(coords, flow, alpha, alpha_k, valid, pool: int,
                       group):
    """The sample pool shared by the ranks of `group` (ransac.py:37-60).

    Each rank takes `pool` pixels of its block at a fixed stride and writes
    them to its slot of a zero array of S * pool rows; one all-reduce gives
    every rank the union.  Returns (coords (S*pool, 2), flow (S*pool, 2),
    alpha, alpha_k (S*pool,), valid (S*pool,) bool).
    """
    n = coords.shape[0]
    stride = max(n // pool, 1)
    idx = (torch.arange(pool, device=coords.device) * stride) % n
    slot = axis_index(group) * pool
    dt = coords.dtype
    local = torch.cat([coords[idx], flow[idx].to(dt), alpha[idx, None].to(dt),
                       alpha_k[idx, None].to(dt), valid[idx, None].to(dt)],
                      dim=1)
    full = torch.zeros((axis_size(group) * pool, 7), dtype=dt,
                       device=coords.device)
    full[slot:slot + pool] = local
    full = psum(full, group)
    return (full[:, 0:2], full[:, 2:4].to(flow.dtype),
            full[:, 4].to(alpha.dtype), full[:, 5].to(alpha_k.dtype),
            full[:, 6] > 0)


def sample_valid_indices(generator, valid_mask, trials: int, count: int = 9):
    """(trials, count) indices drawn uniformly from the valid pixels by
    inverse-CDF sampling over the mask (the JAX function's algorithm)."""
    counts = torch.cumsum(valid_mask.to(torch.int64), dim=0)
    total = counts[-1]
    u = torch.rand((trials, count), generator=generator,
                   device=valid_mask.device, dtype=torch.float32)
    targets = 1 + torch.floor(u * total).to(torch.int64)
    targets = torch.minimum(targets, total)
    return torch.searchsorted(counts, targets, side="left")


def _score_hypotheses(coords, flow, alpha, alpha_k, valid_mask, v, w, k, tol):
    """Score hypotheses (v, w (C, 3); k (C,)) against all pixels with plain
    tensor ops.  Returns (num_inliers (C,) int32, inlier_error (C,),
    inv_depth (C, N), inlier (C, N) bool)."""
    dt = coords.dtype
    vc = v.to(dt)[:, None, :]
    wc = w.to(dt)[:, None, :]
    kc = k.to(dt)[:, None]
    rho = estimate_inverse_depth(coords[None], flow[None], vc, wc, kc,
                                 alpha[None], alpha_k[None])
    u_est = predict_flow(coords[None], rho, vc, wc, kc, alpha[None],
                         alpha_k[None])
    diff = u_est - flow[None]
    err = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inlier = (err < tol) & valid_mask[None] & torch.isfinite(err)
    num = torch.sum(inlier, dim=-1).to(torch.int32)
    ierr = torch.sum(torch.where(inlier, err, 0.0), dim=-1)
    return num, ierr, rho, inlier


def _diverse_top_j(score, v_all, valid_h, top_j: int, diversity: float):
    """Greedy diversity-filtered top-J (ransac.py:363-392); only valid
    hypotheses fill a slot (an invalid root slot's v = 0 clashes with
    nothing).

    The scan is 512 strictly sequential steps over 512x3 floats; on the card
    each step would be a handful of tiny launches, so the candidates' order
    and directions are copied to the host once and the same greedy pick runs
    there in numpy.
    """
    order = torch.argsort(-score, stable=True)
    m_scan = min(score.shape[0], 512)
    norms = torch.sqrt(torch.sum(v_all * v_all, dim=-1, keepdim=True))
    vn = v_all / torch.clamp(norms, min=1e-12)
    order_h = order[:m_scan].cpu().numpy()
    vn_h = vn[order[:m_scan]].cpu().numpy()
    valid_h = valid_h[order[:m_scan]].cpu().numpy()
    cos_thr = np.cos(np.asarray(diversity, vn_h.dtype))
    sel = [int(order_h[0])] * top_j
    selv = np.zeros((top_j, 3), vn_h.dtype)
    cnt = 0
    for i in range(m_scan):
        if cnt == top_j:
            break
        cv = vn_h[i]
        if not valid_h[i] or np.any(np.abs(selv[:cnt] @ cv) > cos_thr):
            continue
        sel[cnt] = int(order_h[i])
        selv[cnt] = cv
        cnt += 1
    return torch.tensor(sel, dtype=torch.int64, device=score.device)


def _score_votes(coords, flow, alpha, alpha_k, valid_mask, v, w, k, tol,
                 chunk: int, kernel: bool):
    """(num_inliers (T,) int32, inlier_error (T,)) of hypotheses v, w (T, 3),
    k (T,): the scoring kernel (float32 error sums) when `kernel`, else the
    plain scoring in the pixels' dtype, `chunk` hypotheses at a time."""
    if kernel:
        px = pack_pixels(coords, flow, alpha, alpha_k, valid_mask)
        nums_f, ierrs = score_hypotheses(px, pack_hyps(v, w, k), float(tol))
        return nums_f.to(torch.int32), ierrs.to(coords.dtype)
    parts = [_score_hypotheses(coords, flow, alpha, alpha_k, valid_mask,
                               v[c:c + chunk], w[c:c + chunk],
                               k[c:c + chunk], tol)[:2]
             for c in range(0, v.shape[0], chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def prescore_votes(coords, flow, alpha, alpha_k, valid_mask, v, w, k, tol,
                   subsample: int, chunk: int = 64, group=None):
    """The prescore's vote table: (counts (T,) int32, error sums (T,),
    pixels voted) of hypotheses v, w (T, 3), k (T,) on `subsample` pixels
    at a fixed stride of this block (the kernel on CUDA tensors, else the
    plain scoring).  Under `group` the table is summed over the ranks in
    ONE all-reduce: the votes of the union of their subsamples."""
    n = coords.shape[0]
    stride = max(n // subsample, 1)
    sub = (torch.arange(subsample, device=coords.device) * stride) % n
    pn, pe = _score_votes(coords[sub], flow[sub], alpha[sub], alpha_k[sub],
                          valid_mask[sub], v, w, k, tol, chunk,
                          coords.is_cuda)
    if group is None:
        return pn, pe, subsample
    votes = psum(torch.stack([pn.to(pe.dtype), pe], dim=-1), group)
    return (votes[:, 0].to(torch.int32), votes[:, 1],
            subsample * axis_size(group))


def ransac(coords, flow, alpha, alpha_k, valid_mask, *, use_k: bool,
           trials: int, tolerance: float, generator=None,
           sample_indices=None, chunk: int = 64, k_mode: str = "score",
           engine: str = "xla", prescore_subsample: int = 0,
           prescore_keep: int = 16, compat_negate_k: bool = False,
           top_j: int = 1, top_j_diversity: float = 0.3, group=None,
           sample_pool: int = 1024, timer=None) -> RansacResult:
    """Batched RANSAC (reference minimal::ransac, src/minimal.cc:209-306).

    Args:
      coords, flow: (N, 2) normalized coordinates and flow.
      alpha, alpha_k: (N,) RS factors; valid_mask: (N,) bool.
      use_k: the constant-acceleration model (k per hypothesis).
      trials: number of samples; tolerance: inlier threshold.
      generator: torch.Generator on the pixels' device for the sampling;
        ignored when `sample_indices` ((trials, 9) indices, e.g. the JAX
        package's draws) is given.
      chunk: hypotheses per pass of the "xla" engine on CPU tensors.
      k_mode: with use_k, "score" expands each sample into a hypothesis
        per root of det Z(k) (6 a sample; a complex root's slot has zero
        motion and a vote of −1); "min" keeps the reference's min-|k| root.
      engine: "pallas" = the scoring kernel; "xla" = plain tensor ops in
        the pixels' dtype on CPU tensors, and the scoring kernel on CUDA
        tensors (its inlier counts are the plain version's, its error sums
        float32, as the "pallas" engine's are on either device).
      prescore_subsample: > 0 ranks all hypotheses on this many pixels at a
        fixed stride (the kernel on CUDA tensors, else the plain scoring,
        under either engine) and scores the best `prescore_keep` on all
        pixels; ranking is by count, then error sum, ties to the earliest.
        Under `group` each rank takes this many pixels of its block and
        the votes are summed over the group.
      compat_negate_k: the reference's sign of k (k_mode "min").
      top_j, top_j_diversity: multi-start outputs (RansacResult.top_*).
      group: process group when the pixels are this rank's scanline block
        of a sharded image (None = the whole image).  The draws then index
        `shared_sample_pool` (`sample_pool` pixels per rank; injected
        `sample_indices` index that pool too, and the generator's draws are
        broadcast from the group's first rank), votes are summed over the
        group, and every scalar output is the same on all ranks;
        inv_depth and inlier_mask stay local.
      timer: optional callback, called with "minimal" once the minimal
        solves and "scoring" once the scoring have been issued.

    The minimal solver runs in CORE_DTYPE (float64).
    """
    mark = timer if timer is not None else (lambda _name: None)
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown RANSAC engine {engine!r}")
    if k_mode not in ("score", "min"):
        raise ValueError(f"unknown k_mode {k_mode!r}")
    n = coords.shape[0]
    pc, pf, pa, pak, pv = coords, flow, alpha, alpha_k, valid_mask
    if group is not None:
        pc, pf, pa, pak, pv = shared_sample_pool(
            coords, flow, alpha, alpha_k, valid_mask, min(sample_pool, n),
            group)
    if sample_indices is None:
        idx = broadcast(sample_valid_indices(generator, pv, trials), group)
    else:
        # A tensor may lie on any device; numpy or list input is copied,
        # since torch cannot wrap a read-only array.
        if not torch.is_tensor(sample_indices):
            sample_indices = torch.from_numpy(np.array(sample_indices))
        idx = sample_indices.to(device=coords.device, dtype=torch.int64)
        if idx.shape != (trials, 9):
            raise ValueError(f"sample_indices must be ({trials}, 9), got "
                             f"{tuple(idx.shape)}")
    q = pc[idx].to(CORE_DTYPE)
    u = pf[idx].to(CORE_DTYPE)
    a9 = pa[idx].to(CORE_DTYPE)
    ak9 = pak[idx].to(CORE_DTYPE)
    if use_k and k_mode == "score":
        w_all, v_all, k_all, valid_h = calculate_velocities_all_k(q, u, a9,
                                                                  ak9)
        w_all = w_all.reshape(-1, 3)
        v_all = v_all.reshape(-1, 3)
        k_all = k_all.reshape(-1)
        valid_h = valid_h.reshape(-1)
        # A complex root's slot gets zero motion; its vote is forced to -1.
        w_all = torch.where(valid_h[:, None], w_all, 0.0)
        v_all = torch.where(valid_h[:, None], v_all, 0.0)
    else:
        w_all, v_all, k_all = calculate_velocities(
            q, u, a9, ak9, use_k, compat_negate_k=compat_negate_k)
        valid_h = torch.ones(k_all.shape, dtype=torch.bool,
                             device=k_all.device)
    mark("minimal")

    if prescore_subsample and prescore_subsample < n:
        # Stage 1: rank on a stratified subsample (the same pixels for all
        # hypotheses), keep the best prescore_keep.
        pn, pe, sub_total = prescore_votes(
            coords, flow, alpha, alpha_k, valid_mask, v_all, w_all, k_all,
            tolerance, prescore_subsample, chunk, group)
        pn = torch.where(valid_h, pn, -1)
        big_s = sub_total * tolerance + 1.0
        pre_score = pn.to(pe.dtype) * big_s - torch.where(
            torch.isfinite(pe), pe, big_s)
        top = torch.argsort(pre_score, descending=True,
                            stable=True)[:prescore_keep]
        w_all, v_all, k_all, valid_h = (w_all[top], v_all[top], k_all[top],
                                        valid_h[top])

    nums, ierrs = _score_votes(coords, flow, alpha, alpha_k, valid_mask,
                               v_all, w_all, k_all, tolerance, chunk,
                               engine == "pallas" or coords.is_cuda)
    n_total = n
    if group is not None:
        # ONE all-reduce of the stacked (T, 2) vote table; counts travel as
        # floats, exact below 2^24.
        votes = psum(torch.stack([nums.to(ierrs.dtype), ierrs], dim=-1),
                     group)
        nums = votes[:, 0].to(torch.int32)
        ierrs = votes[:, 1]
        n_total = n * axis_size(group)
    nums = torch.where(valid_h, nums, -1)
    mark("scoring")

    # Exact two-stage lexicographic best: max count, then min error among
    # the count winners; ties keep the earliest trial.  The composite score
    # is only used where a full ordering is needed (the top-J scan).
    big = torch.tensor(n_total * tolerance + 1.0, dtype=ierrs.dtype,
                       device=ierrs.device)
    finite = torch.isfinite(ierrs)
    score = nums.to(ierrs.dtype) * big - torch.where(finite, ierrs, big)
    err_clean = torch.where(finite, ierrs, torch.inf)
    best_num = torch.max(nums)
    best = torch.argmin(torch.where(nums == best_num, err_clean, torch.inf))

    v_b, w_b, k_b = v_all[best], w_all[best], k_all[best]
    num_b, ierr_b, rho_b, inlier_b = _score_hypotheses(
        coords, flow, alpha, alpha_k, valid_mask, v_b[None], w_b[None],
        k_b[None], tolerance)
    if group is not None:
        bvote = psum(torch.stack([num_b.to(ierr_b.dtype), ierr_b], dim=-1),
                     group)
        num_b = bvote[:, 0].to(torch.int32)
        ierr_b = bvote[:, 1]

    if top_j > 1:
        if top_j_diversity > 0.0:
            tops = _diverse_top_j(score, v_all, valid_h, top_j,
                                  top_j_diversity)
        else:
            j_eff = min(top_j, score.shape[0])
            tops = torch.argsort(-score, stable=True)[:j_eff]
            if j_eff < top_j:
                tops = torch.cat([tops, tops[-1:].repeat(top_j - j_eff)])
        top_v, top_w, top_k = v_all[tops], w_all[tops], k_all[tops]
    else:
        top_v, top_w, top_k = v_b[None], w_b[None], k_b[None]

    return RansacResult(v=v_b, w=w_b, k=k_b, inv_depth=rho_b[0],
                        inlier_mask=inlier_b[0], num_inliers=num_b[0],
                        inlier_error=ierr_b[0], top_v=top_v, top_w=top_w,
                        top_k=top_k)
