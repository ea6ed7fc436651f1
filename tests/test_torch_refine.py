"""Fused Schur-LM iteration (kernels B2/B3's plain twins) and the refinement
loops: rs_sfm_tpu_torch vs the JAX package (Pallas in interpret mode),
float32.

(a) One iteration from the same (J, 128) state, slot by slot: rtol 1e-5,
    atol 1e-7 (float32 summation order of the 71 reductions).  The compared
    step runs at damping lambda = 1: at the production damping (1e-6) the
    (v, rho) scale gauge leaves the damped 7x7 system nearly singular, and
    float32 rounding of the sums alone moves the gauge component of the
    solved delta by tens of percent in either package (see the docstring of
    tests/test_pallas_refine.py::test_pallas_refine_perturbed_converges).
    Production damping is compared end to end in (b).  A reduction sum
    whose terms cancel (J^T J (v_z, w_z) is x*y - y*x pixel by pixel) keeps
    only the float32 rounding of its terms, which no two summation orders
    share: each sum slot is therefore also accepted within 1e-5 of its
    Cauchy-Schwarz bound (sqrt(H_rr H_ss) for a Gram entry, sqrt(H_rr cost)
    for a gradient entry), the size of the terms it adds: float32 rounding
    of 4096 terms in sequence is about sqrt(4096)·2^-24 ≈ 4e-6 of that.
(b) 20-iteration single-start and 8-iteration 4-start refinements end to
    end: v, w and cost rtol 1e-3 (the bounds of tests/test_pallas_refine.py).
    As there, v is compared as a direction: (v, rho) carry a free global
    scale, and at production damping float32 rounding decides how far each
    package drifts along it (rho·|v| is the gauge-free depth).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax_reference import compile_level0, run_jitted

from rs_sfm_tpu.ops.pallas import refine_kernels as jrk
from rs_sfm_tpu.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu.solver.flow_model import predict_flow
from rs_sfm_tpu.solver.refine_pallas import refine_pallas as j_refine
from rs_sfm_tpu.solver.refine_pallas import refine_pallas_multi as j_refine_multi
from rs_sfm_tpu_torch.ops.kernels import refine_kernels as trk
from rs_sfm_tpu_torch.solver import refine_fused as tref

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

N = 4096
HUBER = 1e-3

_COMPILED = {}


def _jax_call(fn, *args, **static):
    """fn(*args, **static), compiled once per (function, static
    arguments, shapes) by jax_reference.compile_level0 (one thread: the
    package's own jit spreads the interpret-mode kernel's compile over two
    cores for the same time)."""
    key = (fn, tuple(sorted(static.items())),
           tuple((a.shape, a.dtype) for a in args))
    if key not in _COMPILED:
        _COMPILED[key] = compile_level0(functools.partial(fn, **static),
                                        *args)
    return _COMPILED[key](*args)


def _problem(seed=0, outliers=True):
    """RS flow of N random points (float32), with a block of coherent
    outliers so the Huber weights bite."""
    rng = np.random.default_rng(seed)
    f, h, gamma = 500.0, 600, 0.9
    px = rng.uniform(0, 599, size=(N, 2))
    coords = ((px - 300.0) / f).astype(np.float32)
    v = np.array([0.02, -0.01, 0.015], np.float32)
    w = np.array([0.004, -0.002, 0.008], np.float32)
    rho = (1.0 / rng.uniform(3.0, 9.0, size=N)).astype(np.float32)
    alpha = np.asarray(get_alpha(rng.normal(scale=2.0, size=N), h, gamma),
                       np.float32)
    alpha_k = np.asarray(get_alpha_k(px[:, 1], rng.normal(scale=2.0, size=N),
                                     h, gamma), np.float32)
    flow = np.asarray(predict_flow(jnp.asarray(coords), jnp.asarray(rho),
                                   jnp.asarray(v), jnp.asarray(w), 0.3,
                                   jnp.asarray(alpha), jnp.asarray(alpha_k)),
                      np.float32)
    flow = flow + rng.normal(scale=2e-4, size=(N, 2)).astype(np.float32)
    if outliers:
        flow[:64] += np.array([3e-3, -2e-3], np.float32)
    return dict(coords=coords, flow=flow, alpha=alpha, alpha_k=alpha_k,
                v=v, w=w, rho=rho, k=np.float32(0.3))


def _px(p, mask):
    z = np.zeros(N, np.float32)
    return np.stack([p["coords"][:, 0], p["coords"][:, 1], p["flow"][:, 0],
                     p["flow"][:, 1], p["alpha"], p["alpha_k"],
                     mask.astype(np.float32), z]).astype(np.float32)


def _starts(p, j):
    rng = np.random.default_rng(7)
    scale_v = np.array([1.1, 1.4, 0.7, 1.2])[:j, None]
    scale_w = np.array([0.9, 0.5, 1.5, 1.1])[:j, None]
    theta = np.concatenate([
        p["v"][None] * scale_v + 0.003, p["w"][None] * scale_w,
        np.array([0.3, 0.1, 0.6, 0.2])[:j, None]], axis=1).astype(np.float32)
    state = np.zeros((j, 128), np.float32)
    state[:, 0:7] = theta
    state[:, 7:14] = theta
    state[:, trk.S_LAM] = 3e-6
    state[:, trk.S_COST] = np.inf
    state[:, trk.S_KKEEP] = 1.0
    state[:, trk.S_ACCEPT] = 1.0
    masks = (rng.uniform(size=(j, N)) > 0.2).astype(np.float32)
    rho = (p["rho"][None] * rng.uniform(0.8, 1.2, size=(j, 1))).astype(
        np.float32)
    return state, masks, rho


def _advance_jax(state, px, masks, rho, steps, loss_delta):
    """Run `steps` JAX iterations to reach a state with history (accepted
    sums, active back-substitution, a solved delta).  masks=None runs the
    single-start `lm_iter` (mask in px row 6), the function the single-start
    test then compares, so both share one compilation."""
    rp = rc = jnp.asarray(rho)
    st = jnp.asarray(state)
    for _ in range(steps):
        if masks is None:
            s1, rp, rc = _jax_call(jrk.lm_iter, st[0], jnp.asarray(px), rp,
                                   rc, interpret=True, loss_delta=loss_delta)
            st = s1[None]
        else:
            st, rp, rc = _jax_call(jrk.lm_iter_multi, st, jnp.asarray(px),
                                   jnp.asarray(masks), rp, rc,
                                   interpret=True, tile=N,
                                   loss_delta=loss_delta)
    return np.array(st), np.array(rp), np.array(rc)


def _assert_state(got, ref):
    bad = trk.state_mismatches(got, ref)
    assert not bad, bad[:10]


def _at_unit_damping(state):
    """Lambda slot such that the compared step solves at lambda = 1 (an
    accept divides the slot by 3)."""
    state = state.copy()
    state[:, trk.S_LAM] = 3.0
    return state


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("loss_delta", [0.0, HUBER])
def test_one_iteration_single_start_matches_jax(steps, loss_delta):
    p = _problem()
    mask = np.ones(N, bool)
    mask[::5] = False
    px = _px(p, mask)
    state, _, rho = _starts(p, 1)
    state, rp, rc = _advance_jax(state, px, None, rho, steps, loss_delta)
    state = _at_unit_damping(state)
    sj, ej, nj = _jax_call(jrk.lm_iter, jnp.asarray(state[0]),
                           jnp.asarray(px), jnp.asarray(rp), jnp.asarray(rc),
                           interpret=True, loss_delta=loss_delta)
    st, et, nt = trk.lm_iter_plain(torch.from_numpy(state[0]),
                                   torch.from_numpy(px), torch.from_numpy(rp),
                                   torch.from_numpy(rc), loss_delta=loss_delta)
    _assert_state(st.numpy(), np.asarray(sj))
    _assert_state(et.numpy(), np.asarray(ej))
    _assert_state(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("loss_delta", [0.0, HUBER])
def test_one_iteration_multi_start_matches_jax(steps, loss_delta):
    p = _problem(seed=1)
    px = _px(p, np.zeros(N, bool))
    state, masks, rho = _starts(p, 2)
    state, rp, rc = _advance_jax(state, px, masks, rho, steps, loss_delta)
    state = _at_unit_damping(state)
    sj, ej, nj = _jax_call(
        jrk.lm_iter_multi, jnp.asarray(state), jnp.asarray(px),
        jnp.asarray(masks), jnp.asarray(rp), jnp.asarray(rc),
        interpret=True, tile=N, loss_delta=loss_delta)
    st, et, nt = trk.lm_iter_multi_plain(
        torch.from_numpy(state), torch.from_numpy(px), torch.from_numpy(masks),
        torch.from_numpy(rp), torch.from_numpy(rc), loss_delta=loss_delta)
    _assert_state(st.numpy(), np.asarray(sj))
    _assert_state(et.numpy(), np.asarray(ej))
    _assert_state(nt.numpy(), np.asarray(nj))


def test_rejection_reuses_saved_sums():
    """A worse candidate is rejected: theta, cost and sums hold, lambda
    quadruples, and the delta solves the saved sums at the new damping."""
    p = _problem(seed=5, outliers=False)
    px = torch.from_numpy(_px(p, np.ones(N, bool)))
    rho = torch.from_numpy(p["rho"])[None]
    theta = torch.from_numpy(np.concatenate([p["v"], p["w"], [p["k"]]]))
    state = tref.initial_state(theta[None, 0:3], theta[None, 3:6],
                               theta[None, 6], optimize_k=True,
                               init_lambda=1e-4, rel_tol=0.0)[0]
    s1, _, _ = trk.lm_iter(state, px, rho, rho)
    assert float(s1[trk.S_ACCEPT]) == 1.0
    bad = s1.clone()
    bad[trk.S_CAND:trk.S_CAND + 7] = theta * 3.0 + 0.1
    s2, _, _ = trk.lm_iter(bad, px, rho, rho)
    assert float(s2[trk.S_ACCEPT]) == 0.0
    np.testing.assert_array_equal(s2[0:7].numpy(), s1[0:7].numpy())
    assert float(s2[trk.S_COST]) == float(s1[trk.S_COST])
    np.testing.assert_allclose(float(s2[trk.S_LAM]), 4e-4, rtol=1e-6)
    sums = s1[trk.S_SUMS:trk.S_SUMS + 71].numpy().astype(np.float64)
    np.testing.assert_array_equal(s2[trk.S_SUMS:trk.S_SUMS + 71].numpy(),
                                  s1[trk.S_SUMS:trk.S_SUMS + 71].numpy())
    lam = float(s2[trk.S_LAM])
    h = np.zeros((7, 7))
    for r in range(7):
        for c in range(7):
            tri = trk._TRI_IDX[r][c]
            h[r, c] = sums[tri] - sums[36 + tri] / (1.0 + lam)
        h[r, r] += lam * (sums[trk._TRI_IDX[r][r]] + 1e-12)
    g = np.array([-(sums[28 + r] - sums[64 + r] / (1.0 + lam))
                  for r in range(7)])
    np.testing.assert_allclose(s2[trk.S_DELTA:trk.S_DELTA + 7].numpy(),
                               np.linalg.solve(h, g), rtol=2e-4, atol=1e-8)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _assert_refined(got, ref):
    np.testing.assert_allclose(_unit(got.v.numpy()), _unit(ref.v), rtol=1e-3,
                               atol=1e-6)
    for name in ("w", "cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-3)


@pytest.mark.parametrize("loss_delta", [0.0, HUBER])
def test_refine_single_start_matches_jax(loss_delta):
    p = _problem(seed=2)
    mask = np.ones(N, bool)
    mask[::7] = False
    v0 = p["v"] * 1.1 + 0.003
    w0 = p["w"] * 0.9
    rho0 = p["rho"] * 1.2
    args = (p["coords"], p["flow"], p["alpha"], p["alpha_k"], mask, v0, w0,
            np.float32(0.0), rho0)
    kw = dict(optimize_k=False, iterations=20, rel_tol=0.0,
              loss_delta=loss_delta)
    ref = _jax_call(j_refine, *[jnp.asarray(a) for a in args],
                    interpret=True, **kw)
    got = tref.refine_pallas(*_torch(*args), **kw)
    _assert_refined(got, ref)
    assert float(got.cost) < 0.5 * float(got.initial_cost)


def test_refine_multi_start_matches_jax():
    p = _problem(seed=3)
    state, masks, rho0 = _starts(p, 4)
    args = (p["coords"], p["flow"], p["alpha"], p["alpha_k"], masks > 0.5,
            state[:, 0:3], state[:, 3:6], state[:, 6], rho0)
    kw = dict(optimize_k=True, iterations=8, rel_tol=0.0, loss_delta=HUBER)
    ref = run_jitted(lambda *a: j_refine_multi(*a, interpret=True, tile=N,
                                               **kw),
                     *[jnp.asarray(a) for a in args])
    got = tref.refine_pallas_multi(*_torch(*args), **kw)
    _assert_refined(got, ref)
    gauge_free = lambda r: (np.asarray(r.inv_depth, np.float64)
                            * np.linalg.norm(np.asarray(r.v, np.float64),
                                             axis=-1, keepdims=True))
    inside = masks > 0.5  # outside its mask a start keeps rho0 as it is
    np.testing.assert_allclose(gauge_free(got)[inside], gauge_free(ref)[inside],
                               rtol=1e-3, atol=1e-6)


def test_refine_multi_equals_per_start():
    """The J-start iteration is J single-start iterations sharing pixels."""
    p = _problem(seed=4)
    state, masks, rho0 = _starts(p, 3)
    t = _torch(p["coords"], p["flow"], p["alpha"], p["alpha_k"])
    multi = tref.refine_pallas_multi(
        *t, torch.from_numpy(masks > 0.5), *_torch(state[:, 0:3],
                                                   state[:, 3:6], state[:, 6],
                                                   rho0),
        optimize_k=True, iterations=6, rel_tol=0.0)
    for s in range(3):
        single = tref.refine_pallas(
            *t, torch.from_numpy(masks[s] > 0.5),
            *_torch(state[s, 0:3], state[s, 3:6], state[s, 6], rho0[s]),
            optimize_k=True, iterations=6, rel_tol=0.0)
        np.testing.assert_allclose(multi.cost[s].numpy(), single.cost.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(multi.v[s].numpy(), single.v.numpy(),
                                   rtol=1e-4, atol=1e-7)


def test_rel_tol_stops_early_and_freezes():
    p = _problem(seed=6, outliers=False)
    t = _torch(p["coords"], p["flow"], p["alpha"], p["alpha_k"])
    mask = torch.ones(N, dtype=torch.bool)
    start = _torch(p["v"] * 1.05, p["w"], np.float32(0.3), p["rho"])
    fixed = tref.refine_pallas(*t, mask, *start, optimize_k=True,
                               iterations=30, rel_tol=0.0)
    early = tref.refine_pallas(*t, mask, *start, optimize_k=True,
                               iterations=30, rel_tol=1e-3)
    assert float(early.cost) >= float(fixed.cost)
    np.testing.assert_allclose(float(early.cost), float(fixed.cost),
                               rtol=1e-2)


@pytest.mark.parametrize("bad", ["dtype", "state_shape", "px_width"])
def test_wrapper_rejects_bad_inputs(bad):
    state = torch.zeros((2, 128))
    px = torch.zeros((8, 64))
    masks = torch.ones((2, 64))
    rho = torch.ones((2, 64))
    if bad == "dtype":
        rho = rho.double()
    elif bad == "state_shape":
        state = torch.zeros((2, 127))
    else:
        px = torch.zeros((8, 65))
    with pytest.raises((TypeError, ValueError)):
        trk.lm_iter_multi(state, px, masks, rho, rho)
