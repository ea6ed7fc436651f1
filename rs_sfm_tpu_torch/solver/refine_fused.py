"""Fused Schur-LM refinement loops (port of
rs_sfm_tpu/solver/refine_pallas.py).

Same objective, update rule, damping and accept/reject logic as the JAX
functions: each LM iteration is one call of the fused iteration
(ops/kernels/refine_kernels: the CUDA kernel pair on the card, its plain
twin on the CPU), and the whole LM state lives in the 128-float vector that
call produces and consumes.  `iterations + 1` sweeps run: the bootstrap
sweep evaluates the initial state, each later sweep makes one accept
decision and one solve.  With `rel_tol == 0` the trip count is static and
nothing syncs with the host; with `rel_tol > 0` the loop reads the done
flags once per iteration.

Under scanline-block sharding (`refine_pallas_multi_sharded`) each
iteration is split: the sums of the rank's pixels, one all-reduce of the
(J, 71) sums over the group, and the decide step, replicated on every rank.

Float32 only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rs_sfm_tpu_torch.ops.kernels.refine_kernels import (S_ACCEPT, S_COST,
                                                         S_COST0, S_DONE,
                                                         S_KKEEP, S_LAM,
                                                         S_RELTOL, lm_decide,
                                                         lm_iter,
                                                         lm_iter_multi,
                                                         lm_sums_multi)
from rs_sfm_tpu_torch.parallel.distributed import psum


# LM damping of the first solve (the JAX functions' default).
INIT_LAMBDA = 1e-6


class RefineResult(NamedTuple):
    """rs_sfm_tpu/solver/refine.py:40."""

    v: torch.Tensor          # (3,) or (J, 3)
    w: torch.Tensor
    k: torch.Tensor
    inv_depth: torch.Tensor  # (N,) or (J, N) refined ρ
    cost: torch.Tensor       # final masked (robust) cost
    initial_cost: torch.Tensor


def initial_state(v0, w0, k0, *, optimize_k: bool, init_lambda: float,
                  rel_tol: float):
    """(J, 128) LM states for J starts (v0, w0 (J, 3); k0 (J,))."""
    f32 = torch.float32
    theta0 = torch.cat([v0.to(f32), w0.to(f32), k0.to(f32)[:, None]], dim=1)
    state = torch.zeros((theta0.shape[0], 128), dtype=f32,
                        device=theta0.device)
    state[:, 0:7] = theta0
    state[:, 7:14] = theta0
    # The bootstrap sweep trivially "accepts" the initial state
    # (cost_prev = inf), dividing lambda by 3; seed 3x the target so the
    # first real solve uses exactly init_lambda.
    state[:, S_LAM] = 3.0 * init_lambda
    state[:, S_COST] = torch.inf
    state[:, S_KKEEP] = 1.0 if optimize_k else 0.0
    state[:, S_ACCEPT] = 1.0
    state[:, S_RELTOL] = rel_tol
    return state


def _run(step, state, rho, iterations: int, rel_tol: float):
    rho_prev = rho_cand = rho
    for _ in range(iterations + 1):
        if rel_tol != 0.0 and bool(torch.all(state[..., S_DONE] > 0.5)):
            break
        state, rho_prev, rho_cand = step(state, rho_prev, rho_cand)
    return state, rho_prev, rho_cand


def refine_pallas(coords, flow, alpha, alpha_k, mask, v0, w0, k0, rho0, *,
                  optimize_k: bool, iterations: int = 50,
                  rel_tol: float = 1e-8,
                  loss_delta: float = 0.0) -> RefineResult:
    """Single-start fused refinement (the JAX `refine_pallas`).

    coords, flow (N, 2); alpha, alpha_k (N,); mask (N,) bool; v0, w0 (3,);
    k0 (); rho0 (N,).  loss_delta > 0 enables the Huber-IRLS objective.
    """
    f32 = torch.float32
    px = torch.stack([coords[:, 0], coords[:, 1], flow[:, 0], flow[:, 1],
                      alpha, alpha_k, mask.to(alpha.dtype),
                      torch.zeros_like(alpha)]).to(f32)
    rho = rho0.to(f32)[None, :].contiguous()
    k0 = torch.as_tensor(k0, device=coords.device)
    state = initial_state(v0[None], w0[None], k0.reshape(1),
                          optimize_k=optimize_k, init_lambda=INIT_LAMBDA,
                          rel_tol=rel_tol)[0]

    def step(st, rp, rc):
        return lm_iter(st, px, rp, rc, loss_delta=loss_delta)

    state, rho_prev, rho_cand = _run(step, state, rho, iterations, rel_tol)
    accept = state[S_ACCEPT] > 0.5
    rho_fin = torch.where(accept, rho_cand, rho_prev)[0]
    return RefineResult(v=state[0:3], w=state[3:6], k=state[6],
                        inv_depth=rho_fin, cost=state[S_COST],
                        initial_cost=state[S_COST0])


def _multi_inputs(coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0,
                  optimize_k, rel_tol):
    f32 = torch.float32
    zero = torch.zeros_like(alpha)
    px = torch.stack([coords[:, 0], coords[:, 1], flow[:, 0], flow[:, 1],
                      alpha, alpha_k, zero, zero]).to(f32)
    masks_f = masks.to(f32).contiguous()
    rho = rho0.to(f32).contiguous()
    state = initial_state(v0, w0, k0, optimize_k=optimize_k,
                          init_lambda=INIT_LAMBDA, rel_tol=rel_tol)
    return px, masks_f, rho, state


def _multi_result(state, rho_prev, rho_cand):
    accept = (state[:, S_ACCEPT] > 0.5)[:, None]
    rho_fin = torch.where(accept, rho_cand, rho_prev)
    return RefineResult(v=state[:, 0:3], w=state[:, 3:6], k=state[:, 6],
                        inv_depth=rho_fin, cost=state[:, S_COST],
                        initial_cost=state[:, S_COST0])


def refine_pallas_multi(coords, flow, alpha, alpha_k, masks, v0, w0, k0,
                        rho0, *, optimize_k: bool, iterations: int = 50,
                        rel_tol: float = 1e-8,
                        loss_delta: float = 0.0) -> RefineResult:
    """J-start batched fused refinement (the JAX `refine_pallas_multi`).

    The J problems share the pixel record and differ in (mask, theta0,
    rho0); one iteration call serves all starts.  masks (J, N) bool;
    v0, w0 (J, 3); k0 (J,); rho0 (J, N).  Every result field has a leading
    J axis.  Under rel_tol > 0 the loop runs until every start is done
    (done starts are frozen by the iteration itself).
    """
    px, masks_f, rho, state = _multi_inputs(
        coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0, optimize_k,
        rel_tol)

    def step(st, rp, rc):
        return lm_iter_multi(st, px, masks_f, rp, rc, loss_delta=loss_delta)

    return _multi_result(*_run(step, state, rho, iterations, rel_tol))


def refine_pallas_multi_sharded(coords, flow, alpha, alpha_k, masks, v0, w0,
                                k0, rho0, *, group, optimize_k: bool,
                                iterations: int = 50, rel_tol: float = 1e-8,
                                loss_delta: float = 0.0) -> RefineResult:
    """J-start fused refinement under scanline-block sharding (the JAX
    `refine_pallas_multi_sharded`).

    Each rank passes its own block of pixels (shapes as
    `refine_pallas_multi`, with N the local count).  Per iteration: the
    sums of the local pixels (`lm_sums_multi`), ONE all-reduce of the
    (J, 71) sums over `group`, then the decide step (`lm_decide`) on every
    rank, which therefore all hold the same state.  Scalar outputs are
    replicated; inv_depth holds the local pixels.  With `group` None, or a
    group of one rank, the result is bit-identical to
    `refine_pallas_multi`.
    """
    px, masks_f, rho, state = _multi_inputs(
        coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0, optimize_k,
        rel_tol)

    def step(st, rp, rc):
        rho_eff, rho_new, sums = lm_sums_multi(st, px, masks_f, rp, rc,
                                               loss_delta=loss_delta)
        return lm_decide(st, psum(sums, group)), rho_eff, rho_new

    return _multi_result(*_run(step, state, rho, iterations, rel_tol))
