"""RANSAC scoring (kernel B1's plain twin, the plain-op scorer and RANSAC
itself): rs_sfm_tpu_torch vs the JAX package, float32.

Inlier counts must agree except at pixels whose JAX error lies within
1e-6·tol of tol (float32 rounding of the two implementations can put those
on either side); the test counts such pixels and allows exactly that many.
Error sums agree to rtol 1e-4 (summation order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu.ops.pallas.score import pack_hyps as jpack_hyps
from rs_sfm_tpu.ops.pallas.score import pack_pixels as jpack_pixels
from rs_sfm_tpu.ops.pallas.score import score_hypotheses_pallas
from rs_sfm_tpu.solver.flow_model import predict_flow as jpredict
from rs_sfm_tpu_torch.ops.kernels import score as tscore
from rs_sfm_tpu_torch.solver import ransac as transac

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

# rs_sfm_tpu.solver re-exports a function named `ransac`; fetch the module.
jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

TOL = 0.05


def _problem(n, t, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        coords=rng.normal(scale=0.3, size=(n, 2)).astype(f32),
        flow=rng.normal(scale=0.01, size=(n, 2)).astype(f32),
        alpha=(1.0 + rng.normal(scale=0.01, size=n)).astype(f32),
        alpha_k=(0.5 + rng.normal(scale=0.05, size=n)).astype(f32),
        valid=rng.uniform(size=n) > 0.1,
        v=rng.normal(size=(t, 3)).astype(f32),
        w=rng.normal(scale=0.01, size=(t, 3)).astype(f32),
        k=rng.uniform(-0.5, 1.5, size=t).astype(f32))


def _jax_pixel_errors(p):
    """Per-pixel JAX (XLA twin) residual norms, (T, N) float32."""
    j = {k: jnp.asarray(v) for k, v in p.items()}
    _, _, rho, _ = jransac._score_hypotheses(
        j["coords"], j["flow"], j["alpha"], j["alpha_k"], j["valid"],
        j["v"], j["w"], j["k"], TOL)
    u_est = jpredict(j["coords"][None], rho, j["v"][:, None, :],
                     j["w"][:, None, :], j["k"][:, None],
                     j["alpha"][None], j["alpha_k"][None])
    return np.asarray(jnp.linalg.norm(u_est - j["flow"][None], axis=-1))


def _assert_counts(got, ref, p):
    err = _jax_pixel_errors(p)
    borderline = np.sum((np.abs(err - TOL) <= 1e-6 * TOL) & p["valid"][None],
                        axis=1)
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    assert (diff <= borderline).all(), (diff, borderline)


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


PALLAS_T = (16, 40, 300)


@pytest.fixture(scope="module")
def jax_pallas_scores():
    """The interpret-mode kernel's (counts, error sums) for each T of
    PALLAS_T on N = 2048 pixels, in one compiled function."""
    problems = [_problem(2048, t) for t in PALLAS_T]

    def scores(*arrays):
        out = []
        for i in range(len(PALLAS_T)):
            j = dict(zip(problems[0], arrays[8 * i:8 * i + 8]))
            out.append(score_hypotheses_pallas(
                jpack_pixels(j["coords"], j["flow"], j["alpha"],
                             j["alpha_k"], j["valid"]),
                jpack_hyps(j["v"], j["w"], j["k"]), TOL, interpret=True))
        return out

    got = run_jitted(scores, *(jnp.asarray(v) for p in problems
                               for v in p.values()))
    return dict(zip(PALLAS_T, zip(problems, got)))


@pytest.mark.parametrize("t", PALLAS_T)
def test_plain_scorer_matches_pallas_interpret(jax_pallas_scores, t):
    p, (num_j, err_j) = jax_pallas_scores[t]
    tp = _torch(p)
    px = tscore.pack_pixels(tp["coords"], tp["flow"], tp["alpha"],
                            tp["alpha_k"], tp["valid"])
    hy = tscore.pack_hyps(tp["v"], tp["w"], tp["k"])
    num_t, err_t = tscore.score_hypotheses_plain(px, hy, TOL)
    assert num_t.dtype == torch.float32 and err_t.dtype == torch.float32
    _assert_counts(num_t.numpy(), np.asarray(num_j), p)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n", [2048, 1500])
def test_plain_op_scorer_matches_xla_twin(n):
    p = _problem(n, 24, seed=1)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    num_j, err_j, rho_j, inl_j = jransac._score_hypotheses(
        j["coords"], j["flow"], j["alpha"], j["alpha_k"], j["valid"],
        j["v"], j["w"], j["k"], TOL)
    tp = _torch(p)
    num_t, err_t, rho_t, inl_t = transac._score_hypotheses(
        tp["coords"], tp["flow"], tp["alpha"], tp["alpha_k"], tp["valid"],
        tp["v"], tp["w"], tp["k"], TOL)
    assert num_t.dtype == torch.int32
    _assert_counts(num_t.numpy(), np.asarray(num_j), p)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), rtol=1e-5,
                               atol=1e-6)
    assert (inl_t.numpy() != np.asarray(inl_j)).sum() <= int(
        np.sum(np.abs(_jax_pixel_errors(p) - TOL) <= 1e-6 * TOL))


def test_unpadded_record_scores_like_padded():
    """The port takes any N; the JAX record padded to its tile scores the
    same (padded pixels carry valid = 0)."""
    p = _problem(1500, 8, seed=2)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    px_pad = torch.from_numpy(np.array(jpack_pixels(
        j["coords"], j["flow"], j["alpha"], j["alpha_k"], j["valid"])))
    tp = _torch(p)
    px = tscore.pack_pixels(tp["coords"], tp["flow"], tp["alpha"],
                            tp["alpha_k"], tp["valid"])
    hy = tscore.pack_hyps(tp["v"], tp["w"], tp["k"])
    assert px_pad.shape[1] == 2048 and px.shape[1] == 1500
    np.testing.assert_array_equal(px_pad[:, :1500].numpy(), px.numpy())
    a = tscore.score_hypotheses(px, hy, TOL)
    b = tscore.score_hypotheses(px_pad.contiguous(), hy, TOL)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-6)


def test_wrapper_runs_plain_on_cpu_without_counting():
    p = _torch(_problem(512, 4, seed=3))
    px = tscore.pack_pixels(p["coords"], p["flow"], p["alpha"], p["alpha_k"],
                            p["valid"])
    hy = tscore.pack_hyps(p["v"], p["w"], p["k"])
    before = tscore.score_hypotheses.launches
    got = tscore.score_hypotheses(px, hy, TOL)
    ref = tscore.score_hypotheses_plain(px, hy, TOL)
    assert tscore.score_hypotheses.launches == before
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())


@pytest.mark.parametrize("tol", [1e-3, 0.02, 0.05, 3.0])
def test_sq_threshold_is_exact(tol):
    """The kernel's test s < s* equals the plain test sqrt(s) < tol (in
    float32, with a correctly rounded root) for every float32 s within
    4,096 ulps of s* and for a random sample of all finite s >= 0."""
    sstar = np.float32(tscore.sq_threshold(tol))
    tol32 = np.float32(tol)
    near = sstar.view(np.uint32).astype(np.int64) + np.arange(-4096, 4097)
    sample = np.random.default_rng(0).integers(0, 0x7F800000, size=200_000)
    s = np.concatenate([near, sample]).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(s < sstar, np.sqrt(s) < tol32)
    assert np.sqrt(sstar) >= tol32


@pytest.mark.parametrize("bad", ["dtype", "rows", "hyp_cols", "noncontig"])
def test_wrapper_rejects_bad_inputs(bad):
    px = torch.zeros((8, 64))
    hy = torch.zeros((4, 8))
    if bad == "dtype":
        px = px.double()
    elif bad == "rows":
        px = torch.zeros((7, 64))
    elif bad == "hyp_cols":
        hy = torch.zeros((4, 7))
    else:
        px = torch.zeros((64, 8)).t()
    with pytest.raises((TypeError, ValueError)):
        tscore.score_hypotheses(px, hy, TOL)


def _flow_problem(h=48, w=64, seed=5):
    from rs_sfm_tpu_torch.data.make_flow import make_flow

    flow = make_flow(h, w, seed=seed)
    f = float(w)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = np.stack([(xs - (w / 2 - 0.5)) / f, (ys - (h / 2 - 0.5)) / f],
                      -1).reshape(-1, 2).astype(np.float32)
    fpx = flow.reshape(-1, 2)
    alpha = (1.0 + 0.9 * fpx[:, 1] / h).astype(np.float32)
    alpha_k = np.full_like(alpha, 0.5)
    return dict(coords=coords, flow=(fpx / f).astype(np.float32),
                alpha=alpha, alpha_k=alpha_k,
                valid=np.sum(fpx * fpx, -1) > 1e-10)


RANSAC_TRIALS = 64
RANSAC_TOP_J = 4


@pytest.fixture(scope="module")
def jax_ransac():
    """JAX RANSAC on both engines with its draws, in one compiled function
    (jax_reference.run_jitted): the best hypothesis does not depend on
    top_j, so one top-4 run an engine serves the top-1 cases too."""
    p = _flow_problem()
    key = jax.random.PRNGKey(3)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    idx = np.array(jransac.sample_valid_indices(key, j["valid"],
                                                RANSAC_TRIALS))

    def both(coords, flow, alpha, alpha_k, valid):
        return {engine: jransac.ransac(
            coords, flow, alpha, alpha_k, valid, key=key, use_k=False,
            trials=RANSAC_TRIALS, tolerance=0.02, chunk=32, engine=engine,
            top_j=RANSAC_TOP_J) for engine in ("pallas", "xla")}

    rj = run_jitted(both, *(j[k] for k in ("coords", "flow", "alpha",
                                           "alpha_k", "valid")))
    return p, idx, rj


@pytest.mark.parametrize("engine,top_j", [("pallas", 1), ("xla", 1),
                                          ("pallas", 4)])
def test_ransac_matches_jax_with_injected_samples(jax_ransac, engine, top_j):
    p, idx, both = jax_ransac
    rj = both[engine]
    trials = RANSAC_TRIALS
    tp = _torch(p)
    rt = transac.ransac(tp["coords"], tp["flow"], tp["alpha"], tp["alpha_k"],
                        tp["valid"], use_k=False, trials=trials,
                        tolerance=0.02, sample_indices=idx, chunk=32,
                        engine=engine, top_j=top_j)
    np.testing.assert_allclose(rt.v.numpy(), np.asarray(rj.v), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=0,
                               atol=1e-10)
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 2
    top_ref = np.asarray(rj.top_v) if top_j == RANSAC_TOP_J else np.asarray(
        rj.v)[None]
    np.testing.assert_allclose(rt.top_v.numpy(), top_ref, rtol=0, atol=1e-9)


def test_sampler_draws_only_valid_pixels():
    valid = torch.zeros(1000, dtype=torch.bool)
    valid[::7] = True
    g = torch.Generator().manual_seed(0)
    idx = transac.sample_valid_indices(g, valid, 256)
    assert idx.shape == (256, 9)
    assert valid[idx].all()
    assert len(torch.unique(idx)) > 100
