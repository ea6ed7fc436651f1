"""One fused Schur-LM iteration: the CUDA kernels (csrc/lm_iter.cu) and
their plain PyTorch twins (port of rs_sfm_tpu/ops/pallas/refine_kernels.py).

One call = one LM iteration in "pipelined accept" form: depth merge,
VarPro depth update, the 71 reduction sums at the candidate, accept/reject,
lambda schedule and the damped 7x7 solve (see the JAX module docstring).
The sharded refinement runs the two halves apart (the JAX lm_sums_multi and
lm_decide): `lm_sums_multi` returns the (J, 71) sums of a rank's pixels,
the caller all-reduces them, and `lm_decide` makes the step on the totals.

Packed pixel fields (rows of an (8, N) float32 tensor):
  0 x   1 y   2 ux   3 uy   4 alpha   5 alpha_k   6 mask (single start)   7 unused
State vector ((128,) float32 per start), the JAX layout slot for slot:
  [0:7)    theta_eff (v, w, k) — last accepted parameters
  [7:14)   theta_cand — candidate parameters (theta_eff + delta)
  [14]     lambda      [15] cost at theta_eff      [16] k_keep
  [17]     accept flag [18] done flag (sticky)     [19:26) delta theta
  [26]     rel_tol     [27] active (0 on the bootstrap sweep)
  [28]     initial cost
  [32:103) reduction sums at theta_eff (lambda-independent):
           [0:28) triu sum J^T J   [28:35) sum J^T r   [35] cost
           [36:64) triu sum c c^T / d   [64:71) sum c g_rho / d
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from rs_sfm_tpu_torch.ops.kernels import _build

_TRIU = [(i, j) for i in range(7) for j in range(7) if i <= j]
_TRI_IDX = [[0] * 7 for _ in range(7)]
for _n, (_i, _j) in enumerate(_TRIU):
    _TRI_IDX[_i][_j] = _TRI_IDX[_j][_i] = _n

S_THETA = 0
S_CAND = 7
S_LAM = 14
S_COST = 15
S_KKEEP = 16
S_ACCEPT = 17
S_DONE = 18
S_DELTA = 19
S_RELTOL = 26
S_ACTIVE = 27
S_COST0 = 28
S_SUMS = 32
N_SUMS = 71


def sum_bounds(sums):
    """(J, 71) numpy Cauchy-Schwarz bounds on the terms each sum slot adds:
    sqrt(H_rr H_ss) for a Gram entry, sqrt(H_rr cost) for a gradient entry.
    A sum whose terms cancel keeps only their float32 rounding, which no two
    summation orders share, so it is compared against this size."""
    h_diag = np.abs(np.stack([sums[:, _TRI_IDX[r][r]] for r in range(7)], 1))
    s_diag = np.abs(np.stack([sums[:, 36 + _TRI_IDX[r][r]]
                              for r in range(7)], 1))
    cost = np.abs(sums[:, 35:36])
    bound = np.zeros_like(sums)
    for q, (r, c) in enumerate(_TRIU):
        bound[:, q] = np.sqrt(h_diag[:, r] * h_diag[:, c])
        bound[:, 36 + q] = np.sqrt(s_diag[:, r] * s_diag[:, c])
    bound[:, 28:35] = np.sqrt(h_diag * cost)
    bound[:, 35:36] = cost
    bound[:, 64:71] = np.sqrt(s_diag * cost)
    return bound


def state_mismatches(got, ref, rtol: float = 1e-5, atol: float = 1e-7):
    """[(start, slot, ref, got)] where two (J, 128) states, or two (J, N) rho
    planes, differ by more than atol + rtol·|ref|; a sum slot may also differ
    by rtol of its `sum_bounds`."""
    got = np.atleast_2d(np.asarray(got, np.float64))
    ref = np.atleast_2d(np.asarray(ref, np.float64))
    tol = atol + rtol * np.abs(ref)
    if ref.shape[1] == 128:
        sl = slice(S_SUMS, S_SUMS + N_SUMS)
        tol[:, sl] = np.maximum(tol[:, sl], rtol * sum_bounds(ref[:, sl]))
    bad = np.abs(got - ref) > tol
    return [(int(j), int(i), ref[j, i], got[j, i])
            for j, i in zip(*np.nonzero(bad))]


def sums_mismatches(got, ref, rtol: float = 1e-5, atol: float = 1e-7):
    """[(start, slot, ref, got)] where two (J, 71) sum tables differ by more
    than atol + rtol·|ref| and by more than rtol of the slot's
    `sum_bounds`."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    tol = np.maximum(atol + rtol * np.abs(ref), rtol * sum_bounds(ref))
    bad = np.abs(got - ref) > tol
    return [(int(j), int(i), ref[j, i], got[j, i])
            for j, i in zip(*np.nonzero(bad))]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _reduce_starts(px, masks, rho_prev, rho_cand, state, loss_delta):
    """Per-pixel work of all J starts: depth merge, VarPro update and the 71
    sums at the candidate.  Returns (rho_eff, rho_new, sums (J, 71))."""
    col = [state[:, S_CAND + t:S_CAND + t + 1] for t in range(7)]
    v0, v1, v2, w0, w1, w2, k = col
    k_keep = state[:, S_KKEEP:S_KKEEP + 1]
    accept = state[:, S_ACCEPT:S_ACCEPT + 1] > 0.5
    active = state[:, S_ACTIVE:S_ACTIVE + 1]
    x, y, ux, uy, alpha, alpha_k = (px[i:i + 1, :] for i in range(6))
    m = masks
    rho_eff = torch.where(accept, rho_cand, rho_prev)

    beta = (alpha + k * alpha_k) * (2.0 / (2.0 + k))
    dbeta = 2.0 * (2.0 * alpha_k - alpha) / ((2.0 + k) * (2.0 + k))
    ax = v0 - x * v2
    ay = v1 - y * v2
    bx = -x * y * w0 + (1.0 + x * x) * w1 - y * w2
    by = -(1.0 + y * y) * w0 + x * y * w1 + x * w2
    jrx = -beta * ax
    jry = -beta * ay
    d = (jrx * jrx + jry * jry) * m
    informative = d > 0.0
    inv_d = torch.where(informative, 1.0 / torch.where(informative, d, 1.0),
                        0.0)

    rx0 = ux - beta * (ax * rho_eff + bx)
    ry0 = uy - beta * (ay * rho_eff + by)
    g_rho0 = (jrx * rx0 + jry * ry0) * m
    delta_rho = torch.where(informative, -g_rho0 * inv_d, 0.0)
    rho_new = rho_eff + delta_rho * m * active

    ex = ax * rho_new + bx
    ey = ay * rho_new + by
    rx = ux - beta * ex
    ry = uy - beta * ey
    brho = beta * rho_new
    zero = torch.zeros_like(brho)
    jx = (-brho, zero, brho * x, beta * x * y, -beta * (1.0 + x * x),
          beta * y, -dbeta * ex * k_keep)
    jy = (zero, -brho, brho * y, beta * (1.0 + y * y), -beta * x * y,
          -beta * x, -dbeta * ey * k_keep)
    g_rho = (jrx * rx + jry * ry) * m
    c = [(jx[t] * jrx + jy[t] * jry) * m for t in range(7)]

    sq = rx * rx + ry * ry
    if loss_delta > 0.0:
        nrm = torch.sqrt(sq + 1e-24)
        wl = torch.clamp(loss_delta / nrm, max=1.0)
        swl = torch.sqrt(wl)
        cost_px = torch.where(nrm <= loss_delta, sq,
                              2.0 * loss_delta * nrm
                              - loss_delta * loss_delta) * m
    else:
        wl = swl = 1.0
        cost_px = sq * m

    a = [jx[t] * m * swl for t in range(7)]
    b = [jy[t] * m * swl for t in range(7)]
    ca = [c[t] * inv_d for t in range(7)]
    cb = [c[t] * wl for t in range(7)]
    sums = ([torch.sum(a[i] * a[j] + b[i] * b[j], dim=1) for i, j in _TRIU]
            + [torch.sum((jx[t] * rx + jy[t] * ry) * m * wl, dim=1)
               for t in range(7)]
            + [torch.sum(cost_px, dim=1)]
            + [torch.sum(ca[i] * cb[j], dim=1) for i, j in _TRIU]
            + [torch.sum(c[t] * wl * g_rho * inv_d, dim=1) for t in range(7)])
    return rho_eff, rho_new, torch.stack(sums, dim=1)


def _solve_7x8(aug):
    """Gauss-Jordan with pairwise partial pivoting on (J, 7, 8) systems, the
    elimination order of the JAX kernel's _solve_7x8_scalar."""
    aug = [[aug[:, r, c] for c in range(8)] for r in range(7)]
    for kk in range(7):
        for r in range(kk + 1, 7):
            swap = torch.abs(aug[r][kk]) > torch.abs(aug[kk][kk])
            for c in range(kk, 8):
                hi = torch.where(swap, aug[r][c], aug[kk][c])
                lo = torch.where(swap, aug[kk][c], aug[r][c])
                aug[kk][c] = hi
                aug[r][c] = lo
        piv = aug[kk][kk]
        inv = torch.where(piv == 0.0, 0.0,
                          1.0 / torch.where(piv == 0.0, 1.0, piv))
        for c in range(kk, 8):
            aug[kk][c] = aug[kk][c] * inv
        for r in range(7):
            if r == kk:
                continue
            f = aug[r][kk]
            for c in range(kk + 1, 8):
                aug[r][c] = aug[r][c] - f * aug[kk][c]
    return torch.stack([aug[r][7] for r in range(7)], dim=1)


def _decide(state, sums_cand):
    """Accept/reject, lambda schedule and damped Schur solve for J starts
    (the JAX _decide_and_solve_start, vectorized over starts)."""
    cost_prev = state[:, S_COST]
    rel_tol = state[:, S_RELTOL]
    k_keep = state[:, S_KKEEP]
    lam = state[:, S_LAM]
    cost_cand = sums_cand[:, 35]
    was_done = state[:, S_DONE] > 0.5
    acc_ok = (cost_cand < cost_prev) & (cost_cand == cost_cand) & ~was_done
    prev_finite = torch.abs(cost_prev) < 3.0e38
    conv = acc_ok & prev_finite & (cost_prev - cost_cand <= rel_tol * cost_prev)
    done = was_done | conv

    sums = torch.where(acc_ok[:, None], sums_cand,
                       state[:, S_SUMS:S_SUMS + N_SUMS])
    theta = torch.where(acc_ok[:, None], state[:, S_CAND:S_CAND + 7],
                        state[:, S_THETA:S_THETA + 7])
    cost = torch.where(acc_ok, cost_cand, cost_prev)
    lam_new = torch.where(was_done, lam,
                          torch.where(acc_ok, torch.clamp(lam / 3.0, min=1e-12),
                                      lam * 4.0))
    s = 1.0 / (1.0 + lam_new)
    cols = []
    for r in range(7):
        row = []
        for cc in range(7):
            tri = _TRI_IDX[r][cc]
            h = sums[:, tri] - sums[:, 36 + tri] * s
            if r == cc:
                h = h + lam_new * (sums[:, tri] + 1e-12)
            if r == cc == 6:
                h = h + (1.0 - k_keep)
            row.append(h)
        row.append(-(sums[:, 28 + r] - sums[:, 64 + r] * s))
        cols.append(torch.stack(row, dim=1))
    delta = _solve_7x8(torch.stack(cols, dim=1))

    out = torch.zeros_like(state)
    out[:, S_THETA:S_THETA + 7] = theta
    out[:, S_CAND:S_CAND + 7] = theta + delta
    out[:, S_DELTA:S_DELTA + 7] = delta
    out[:, S_LAM] = lam_new
    out[:, S_COST] = cost
    out[:, S_KKEEP] = k_keep
    out[:, S_ACCEPT] = acc_ok.to(state.dtype)
    out[:, S_DONE] = done.to(state.dtype)
    out[:, S_RELTOL] = rel_tol
    out[:, S_ACTIVE] = 1.0
    out[:, S_COST0] = torch.where(prev_finite, state[:, S_COST0], cost_cand)
    out[:, S_SUMS:S_SUMS + N_SUMS] = sums
    return out


def lm_sums_multi_plain(state, px, masks, rho_prev, rho_cand,
                        loss_delta: float = 0.0):
    """Plain PyTorch version of `lm_sums_multi`: (rho_eff (J, N),
    rho_new (J, N), sums (J, 71))."""
    return _reduce_starts(px, masks, rho_prev, rho_cand, state,
                          float(loss_delta))


def lm_decide_plain(state, sums):
    """Plain PyTorch version of `lm_decide`: the new (J, 128) state."""
    return _decide(state, sums)


def lm_iter_multi_plain(state, px, masks, rho_prev, rho_cand,
                        loss_delta: float = 0.0):
    """Plain PyTorch version of one LM iteration for J starts.

    Args:
      state: (J, 128) float32; px: (8, N) float32 (rows 0-5 used);
      masks, rho_prev, rho_cand: (J, N) float32.

    Returns:
      (new_state (J, 128), rho_eff (J, N), rho_new (J, N)).
    """
    rho_eff, rho_new, sums = _reduce_starts(px, masks, rho_prev, rho_cand,
                                            state, float(loss_delta))
    return _decide(state, sums), rho_eff, rho_new


def lm_iter_plain(state, px, rho_prev, rho_cand, loss_delta: float = 0.0):
    """Plain PyTorch version of one single-start LM iteration: state (128,),
    rho_* (1, N); the mask is px row 6."""
    out, rho_eff, rho_new = lm_iter_multi_plain(
        state[None], px, px[6:7], rho_prev, rho_cand, loss_delta)
    return out[0], rho_eff, rho_new


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# Routes of csrc/lm_iter.cu's lm_iter_launch: its kernels of one name per
# wrapper.
_ROUTE = {"lm_iter": 0, "lm_iter_multi": 1}


def _lib():
    lib = _build.load("lm_iter")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lm_iter_launch.argtypes = [i, p, p, ll, ll, p, ll, p, p, ll, i,
                                       ctypes.c_float, p, p, p, p, i, p, p,
                                       p]
        lib.lm_iter_launch.restype = ctypes.c_int
        lib.lm_sums_launch.argtypes = [p, p, ll, ll, p, ll, p, p, ll, i,
                                       ctypes.c_float, p, p, p, i, p, p]
        lib.lm_sums_launch.restype = ctypes.c_int
        lib.lm_decide_launch.argtypes = [p, p, i, p, p]
        lib.lm_decide_launch.restype = ctypes.c_int
        lib.lm_sweep_blocks.argtypes = [ll, i]
        lib.lm_sweep_blocks.restype = ctypes.c_int
        lib.lm_max_starts.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _sweep_blocks(device_index: int, n: int, j: int) -> int:
    """Blocks of the persistent sweep grid that csrc/lm_iter.cu sizes for
    n pixels and j starts on this device (its first call on a device also
    sets the sweep kernels' shared-memory limit there)."""
    lib = _lib()
    if j > lib.lm_max_starts():
        raise ValueError(f"at most {lib.lm_max_starts()} starts, got {j}")
    with torch.cuda.device(device_index):
        nblk = lib.lm_sweep_blocks(n, j)
    if nblk <= 0:
        raise RuntimeError("lm_sweep_blocks: CUDA error")
    return nblk


def _sweep_scratch(j: int, n: int, dev):
    """(partial (J, 71, blocks), sums (J, 71), ticket pointer, blocks): the
    sweep's scratch in one allocation, the one int of the ticket after the
    sums."""
    nblk = _sweep_blocks(dev.index, n, j)
    rows = j * N_SUMS
    scratch = torch.empty(rows * (nblk + 1) + 1, dtype=torch.float32,
                          device=dev)
    partial = scratch[:rows * nblk].view(j, N_SUMS, nblk)
    sums = scratch[rows * nblk:rows * (nblk + 1)].view(j, N_SUMS)
    ticket = scratch.data_ptr() + 4 * rows * (nblk + 1)
    return partial, sums, ticket, nblk


def _check(state, px, masks, rho_prev, rho_cand):
    tensors = {"state": state, "px": px, "masks": masks,
               "rho_prev": rho_prev, "rho_cand": rho_cand}
    for name, t in tensors.items():
        if t.device != px.device:
            raise ValueError(f"{name} on {t.device}, px on {px.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    j, n = rho_prev.shape
    if px.dim() != 2 or px.shape[0] != 8 or px.shape[1] != n:
        raise ValueError(f"px must be (8, {n}), got {tuple(px.shape)}")
    if state.shape != (j, 128):
        raise ValueError(f"state must be ({j}, 128), got {tuple(state.shape)}")
    for name in ("masks", "rho_cand"):
        if tensors[name].shape != (j, n):
            raise ValueError(f"{name} must be ({j}, {n})")
    for name in ("state", "px", "rho_prev", "rho_cand"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if masks.stride(1) != 1:
        raise ValueError("masks rows must be contiguous")


def _launch(route, state, px, masks, rho_prev, rho_cand, loss_delta):
    """Launch the sweep + reduce-and-decide kernel pair of `route`; returns
    the new tensors."""
    lib = _lib()
    j, n = rho_prev.shape
    dev = px.device
    with torch.cuda.device(dev):
        partial, sums, ticket, nblk = _sweep_scratch(j, n, dev)
        out = torch.empty((j, 128), dtype=torch.float32, device=dev)
        rho_eff = torch.empty((j, n), dtype=torch.float32, device=dev)
        rho_new = torch.empty((j, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lm_iter_launch(
            _ROUTE[route], state.data_ptr(), px.data_ptr(), n, n,
            masks.data_ptr(), masks.stride(0), rho_prev.data_ptr(),
            rho_cand.data_ptr(), n, j, float(loss_delta), out.data_ptr(),
            rho_eff.data_ptr(), rho_new.data_ptr(), partial.data_ptr(), nblk,
            sums.data_ptr(), ticket, stream), "lm_iter_launch")
    return out, rho_eff, rho_new


def lm_iter_multi(state, px, masks, rho_prev, rho_cand,
                  loss_delta: float = 0.0):
    """One fused LM iteration for J starts sharing the pixel record.

    state (J, 128); px (8, N) (rows 0-5 used); masks, rho_prev, rho_cand
    (J, N); all float32.  On CUDA tensors this launches the kernel pair of
    csrc/lm_iter.cu, the sweep and the reduce-and-decide (counted once in
    `lm_iter_multi.launches`); on CPU tensors it runs
    `lm_iter_multi_plain`.

    Returns (new_state (J, 128), rho_eff (J, N), rho_new (J, N)).
    """
    _check(state, px, masks, rho_prev, rho_cand)
    if px.device.type == "cpu":
        return lm_iter_multi_plain(state, px, masks, rho_prev, rho_cand,
                                   loss_delta)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    result = _launch("lm_iter_multi", state, px, masks, rho_prev, rho_cand,
                     loss_delta)
    lm_iter_multi.launches += 1
    return result


lm_iter_multi.launches = 0


def lm_iter(state, px, rho_prev, rho_cand, loss_delta: float = 0.0):
    """One fused single-start LM iteration: state (128,), px (8, N) with
    the mask in row 6, rho_* (1, N).  On CUDA tensors this is the J = 1
    launch of csrc/lm_iter.cu (counted in `lm_iter.launches`); on CPU
    tensors it runs `lm_iter_plain`.

    Returns (new_state (128,), rho_eff (1, N), rho_new (1, N)).
    """
    if state.shape != (128,):
        raise ValueError(f"state must be (128,), got {tuple(state.shape)}")
    _check(state[None], px, px[6:7], rho_prev, rho_cand)
    if px.device.type == "cpu":
        return lm_iter_plain(state, px, rho_prev, rho_cand, loss_delta)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    out, rho_eff, rho_new = _launch("lm_iter", state[None], px, px[6:7],
                                    rho_prev, rho_cand, loss_delta)
    lm_iter.launches += 1
    return out[0], rho_eff, rho_new


lm_iter.launches = 0


def lm_sums_multi(state, px, masks, rho_prev, rho_cand,
                  loss_delta: float = 0.0):
    """The pixel-sweep half of one LM iteration for J starts (the JAX
    lm_sums_multi): the depth merge, the VarPro update and the 71 sums at
    the candidate over these pixels, for a caller that sums them across
    shards before `lm_decide`.

    Shapes as `lm_iter_multi`.  On CUDA tensors this launches the sweep and
    reduction kernels of csrc/lm_iter.cu (counted in
    `lm_sums_multi.launches`); on CPU tensors it runs
    `lm_sums_multi_plain`.

    Returns (rho_eff (J, N), rho_new (J, N), sums (J, 71)).
    """
    _check(state, px, masks, rho_prev, rho_cand)
    if px.device.type == "cpu":
        return lm_sums_multi_plain(state, px, masks, rho_prev, rho_cand,
                                   loss_delta)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    lib = _lib()
    j, n = rho_prev.shape
    dev = px.device
    with torch.cuda.device(dev):
        partial, sums, _, nblk = _sweep_scratch(j, n, dev)
        rho_eff = torch.empty((j, n), dtype=torch.float32, device=dev)
        rho_new = torch.empty((j, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lm_sums_launch(
            state.data_ptr(), px.data_ptr(), n, n, masks.data_ptr(),
            masks.stride(0), rho_prev.data_ptr(), rho_cand.data_ptr(), n, j,
            float(loss_delta), rho_eff.data_ptr(), rho_new.data_ptr(),
            partial.data_ptr(), nblk, sums.data_ptr(), stream),
            "lm_sums_launch")
    lm_sums_multi.launches += 1
    return rho_eff, rho_new, sums


lm_sums_multi.launches = 0


def lm_decide(state, sums):
    """The decide half of one LM iteration (the JAX lm_decide): accept or
    reject, the lambda schedule and the damped 7x7 solve on the (J, 71)
    sums, summed over every shard.

    state (J, 128), sums (J, 71), float32.  On CUDA tensors this launches
    the decide kernel of csrc/lm_iter.cu (counted in `lm_decide.launches`);
    on CPU tensors it runs `lm_decide_plain`.  Returns the new (J, 128)
    state.
    """
    j = state.shape[0]
    if state.shape != (j, 128) or sums.shape != (j, N_SUMS):
        raise ValueError(f"state must be (J, 128) and sums (J, {N_SUMS}), "
                         f"got {tuple(state.shape)} and {tuple(sums.shape)}")
    for name, t in (("state", state), ("sums", sums)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != state.device:
            raise ValueError(f"sums on {sums.device}, state on {state.device}")
    if state.device.type == "cpu":
        return lm_decide_plain(state, sums)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    lib = _lib()
    if j > lib.lm_max_starts():
        raise ValueError(f"at most {lib.lm_max_starts()} starts, got {j}")
    st, sm = state.contiguous(), sums.contiguous()
    dev = state.device
    with torch.cuda.device(dev):
        out = torch.empty((j, 128), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.lm_decide_launch(st.data_ptr(), sm.data_ptr(), j,
                                          out.data_ptr(), stream),
                     "lm_decide_launch")
    lm_decide.launches += 1
    return out


lm_decide.launches = 0
