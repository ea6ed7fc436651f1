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

Under scanline-block sharding (`group`), hypotheses are drawn from a pool
of pixels shared by all ranks (`shared_sample_pool`), each rank scores them
on its own pixels, and the (T, 2) vote table is summed over the group in
one all-reduce.  The two-stage prescore and the all-k path are not ported
yet.
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
from rs_sfm_tpu_torch.solver.minimal import calculate_velocities


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


def _diverse_top_j(score, v_all, top_j: int, diversity: float):
    """Greedy diversity-filtered top-J (ransac.py:363-392).

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
    cos_thr = np.cos(np.asarray(diversity, vn_h.dtype))
    sel = [int(order_h[0])] * top_j
    selv = np.zeros((top_j, 3), vn_h.dtype)
    cnt = 0
    for i in range(m_scan):
        if cnt == top_j:
            break
        cv = vn_h[i]
        if np.any(np.abs(selv[:cnt] @ cv) > cos_thr):
            continue
        sel[cnt] = int(order_h[i])
        selv[cnt] = cv
        cnt += 1
    return torch.tensor(sel, dtype=torch.int64, device=score.device)


def ransac(coords, flow, alpha, alpha_k, valid_mask, *, use_k: bool,
           trials: int, tolerance: float, generator=None,
           sample_indices=None, chunk: int = 64, engine: str = "xla",
           top_j: int = 1, top_j_diversity: float = 0.3, group=None,
           sample_pool: int = 1024) -> RansacResult:
    """Batched RANSAC (reference minimal::ransac, src/minimal.cc:209-306).

    Args:
      coords, flow: (N, 2) normalized coordinates and flow.
      alpha, alpha_k: (N,) RS factors; valid_mask: (N,) bool.
      use_k: must be False (the acceleration path is not ported yet).
      trials: number of hypotheses; tolerance: inlier threshold.
      generator: torch.Generator on the pixels' device for the sampling;
        ignored when `sample_indices` ((trials, 9) indices, e.g. the JAX
        package's draws) is given.
      chunk: hypotheses per pass of the "xla" engine.
      engine: "pallas" = the scoring kernel; "xla" = plain tensor ops.
      top_j, top_j_diversity: multi-start outputs (RansacResult.top_*).
      group: process group when the pixels are this rank's scanline block
        of a sharded image (None = the whole image).  The draws then index
        `shared_sample_pool` (`sample_pool` pixels per rank; injected
        `sample_indices` index that pool too, and the generator's draws are
        broadcast from the group's first rank), votes are summed over the
        group, and every scalar output is the same on all ranks;
        inv_depth and inlier_mask stay local.

    The minimal solver runs in CORE_DTYPE (float64).
    """
    if use_k:
        raise NotImplementedError(
            "RANSAC with the acceleration model (all-k scoring) is not "
            "ported yet")
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
    w_all, v_all, k_all = calculate_velocities(q, u, a9, ak9, False)

    if engine == "pallas":
        px = pack_pixels(coords, flow, alpha, alpha_k, valid_mask)
        hy = pack_hyps(v_all, w_all, k_all)
        nums_f, ierrs = score_hypotheses(px, hy, float(tolerance))
        nums = nums_f.to(torch.int32)
        ierrs = ierrs.to(coords.dtype)
    elif engine == "xla":
        parts = [_score_hypotheses(coords, flow, alpha, alpha_k, valid_mask,
                                   v_all[c:c + chunk], w_all[c:c + chunk],
                                   k_all[c:c + chunk], tolerance)[:2]
                 for c in range(0, trials, chunk)]
        nums = torch.cat([p[0] for p in parts])
        ierrs = torch.cat([p[1] for p in parts])
    else:
        raise ValueError(f"unknown RANSAC engine {engine!r}")
    n_total = n
    if group is not None:
        # ONE all-reduce of the stacked (T, 2) vote table; counts travel as
        # floats, exact below 2^24.
        votes = psum(torch.stack([nums.to(ierrs.dtype), ierrs], dim=-1),
                     group)
        nums = votes[:, 0].to(torch.int32)
        ierrs = votes[:, 1]
        n_total = n * axis_size(group)

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
            tops = _diverse_top_j(score, v_all, top_j, top_j_diversity)
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
