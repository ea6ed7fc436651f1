"""The acceleration model's solver pieces: rs_sfm_tpu_torch vs the JAX
package on the CPU, float64 unless stated.

Inputs: a 48x64 rolling-shutter flow of random depths from a model with
k = 0.5 (noise-free, with a corrupted band of outliers), made with numpy
from a seed, and 64 RANSAC draws of the JAX package's sampler.  One jitted
JAX function gives every reference on it, so the JAX side compiles its
float64 root engine once: the draws, `calculate_velocities_all_k` on them,
`ransac(use_k=True)` (k_mode "score", the prescore on 512 pixels keeping
16, 4 diversity starts) and the `k_scan` of its winner.

Tolerances:
- linalg (`gauss_det`, `solve_spd`, `solve_pd_nopivot`, `polyroots`): 1e-12
  relative (the same operations in the same order).
- `calculate_velocities_all_k`: valid root slots equal; k within
  PARITY.md's 4.3e-8 relative on every valid slot; w, v at PARITY.md's
  bounds (2.3e-10, 2.3e-9, v sign-aligned) on the physical root of every
  clean sample (all 9 points off the band: its root is 0.5 within 1e-4).
  The other real roots of a minimal sample are ill-conditioned: their w, v
  are held to 1e-7 relative to max(1, |w|) (the JAX package's own jitted
  and op-by-op runs differ there by up to 1e-8).
- `estimate_k` (both signs of compat_negate): |k| within 4.3e-8 relative
  of JAX's least-magnitude real root, the sign too where that root is the
  only one of its magnitude (a sample may have a ± pair of roots equal to
  rounding).  `calculate_velocities(use_k=True)`: PARITY.md's bounds on the
  clean samples whose least root is the physical one.
- The float32 Newton engine, on pencils with known roots near its starts:
  every start converges, within 2e-5 of JAX's root and of the true one
  (float32 rounding of the iteration's last steps).
- `ransac`: the same best hypothesis (v, w, k at PARITY.md's bounds),
  inlier count and mask equal, the inlier error within 1e-9 (a sum of
  about 3,000 residuals near 1e-10, the flow's fixed-point rounding), the
  4 starts at PARITY.md's bounds.
- `k_scan`: the same grid point; v, w at PARITY.md's bounds, ρ 4.3e-8
  relative, the cost 1e-9 relative.  J starts scanned together equal the
  first and the last scanned alone to 1e-12.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu.ops import linalg as jlinalg
from rs_sfm_tpu.solver import minimal as jmin
from rs_sfm_tpu.solver.kscan import k_scan as j_k_scan
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.ops import linalg as tlinalg
from rs_sfm_tpu_torch.solver import minimal as tmin
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow
from rs_sfm_tpu_torch.solver.kscan import k_scan
from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
from rs_sfm_tpu_torch.solver.ransac import _score_hypotheses, ransac

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

V_TOL, W_TOL, K_RTOL = 2.3e-9, 2.3e-10, 4.3e-8
H, W, F, GAMMA, K_TRUE = 48, 64, 60.0, 0.9, 0.5
TRIALS, TOL, PRESCORE, KEEP, STARTS = 64, 0.005, 512, 16, 4
K_GRID = np.linspace(-0.5, 2.0, 17)



def _flow():
    """(H, W, 2) float64 RS flow of random depths, k = K_TRUE, with a
    corrupted band; each pixel's readout time follows its own flow."""
    rng = np.random.default_rng(3)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(np.stack([(xs - W / 2.0) / F,
                                        (ys - H / 2.0) / F], -1).reshape(-1, 2))
    rho = torch.from_numpy(1.0 / rng.uniform(4.0, 9.0, size=H * W))
    v = torch.tensor([0.2, -0.1, 0.15], dtype=torch.float64)
    wr = torch.tensor([0.003, -0.002, 0.004], dtype=torch.float64)
    ys = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((H * W, 2), dtype=torch.float64)
    for _ in range(6):
        a = get_alpha(fl[:, 1] * F, H, GAMMA)
        ak = get_alpha_k(ys, fl[:, 1] * F, H, GAMMA)
        fl = predict_flow(coords, rho, v, wr, K_TRUE, a, ak)
    flow = (fl * F).reshape(H, W, 2)
    flow[10:16, 20:40] += torch.tensor([1.5, -1.0], dtype=torch.float64)
    return flow


def _jax_reference(coords, flow_n, alpha, alpha_k, valid, key):
    idx = jransac.sample_valid_indices(key, valid, TRIALS)
    all_k = jmin.calculate_velocities_all_k(coords[idx], flow_n[idx],
                                            alpha[idx], alpha_k[idx])
    rr = jransac.ransac(coords, flow_n, alpha, alpha_k, valid, key=key,
                        use_k=True, trials=TRIALS, tolerance=TOL,
                        prescore_subsample=PRESCORE, prescore_keep=KEEP,
                        top_j=STARTS)
    scan = j_k_scan(coords, flow_n, alpha, alpha_k, rr.inlier_mask, rr.v,
                    rr.w, jnp.asarray(K_GRID), iters=3)
    return idx, all_k, rr, scan


@pytest.fixture(scope="module")
def case():
    """The port's inputs (tensors), the JAX draws and JAX's references."""
    flow = _flow()
    inputs = prepare_flow_inputs(flow, Intrinsics(fx=F, fy=F, cx=W / 2.0,
                                                  cy=H / 2.0), GAMMA,
                                 PipelineConfig())
    idx, all_k, rr, scan = run_jitted(
        _jax_reference, *(jnp.asarray(t.numpy()) for t in inputs),
        jax.random.PRNGKey(3))
    idx = np.array(idx)
    samples = [t[torch.from_numpy(idx)] for t in inputs[:4]]
    return dict(inputs=inputs, idx=idx, samples=samples,
                all_k=[np.asarray(x) for x in all_k], rr=rr,
                scan=[np.asarray(x) for x in scan])


def _least_roots(k, valid):
    """JAX's estimate_k from its all-k output: the valid root of least
    magnitude (the first on ties), 0 where none is valid; and whether that
    magnitude is the sample's only one."""
    mag = np.where(valid, np.abs(k), np.inf)
    best = np.argmin(mag, axis=-1)
    rows = np.arange(k.shape[0])
    least = np.where(valid.any(-1), k[rows, best], 0.0)
    second = np.sort(mag, axis=-1)[:, 1]
    unique = ~(np.abs(second - mag[rows, best])
               <= K_RTOL * mag[rows, best])
    return least, best, unique


def _sign_aligned(v, ref):
    return v * np.where(np.sum(v * ref, -1, keepdims=True) < 0, -1.0, 1.0)


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 6, 6))
    a[0, :, 2] = 0.0  # singular: determinant 0
    a[1] = np.diag(rng.uniform(1, 2, 6))[::-1]  # pivots by row swaps
    spd = a @ np.swapaxes(a, -1, -2) + np.eye(6)
    b = rng.normal(size=(40, 6))
    c = rng.normal(size=(40, 7))
    c[0, -1] = 0.0  # a vanishing leading coefficient

    @jax.jit
    def reference(a, spd, b, c):
        return (jlinalg.gauss_det(a), jlinalg.solve_spd(spd, b, 0.1),
                jlinalg.solve_pd_nopivot(spd, b), jlinalg.polyroots(c))

    want = jax.tree_util.tree_map(np.asarray, reference(a, spd, b, c))
    t = torch.from_numpy
    got = (tlinalg.gauss_det(t(a)), tlinalg.solve_spd(t(spd), t(b), 0.1),
           tlinalg.solve_pd_nopivot(t(spd), t(b)), tlinalg.polyroots(t(c)))
    assert float(got[0][0]) == 0.0
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-14)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-14)


def test_all_k_matches_jax(case):
    wj, vj, kj, okj = case["all_k"]
    wt, vt, kt, okt = (x.numpy() for x in
                       tmin.calculate_velocities_all_k(*case["samples"]))
    np.testing.assert_array_equal(okt, okj)
    assert okj.mean() > 0.3
    np.testing.assert_allclose(kt[okj], kj[okj], rtol=K_RTOL, atol=0)
    assert np.all(kt[~okj] == 0.0)
    rows = np.arange(TRIALS)
    phys = np.argmin(np.where(okj, np.abs(kj - K_TRUE), np.inf), -1)
    clean = okj[rows, phys] & (np.abs(kj[rows, phys] - K_TRUE) < 1e-4)
    assert clean.sum() >= 20
    sel = (rows[clean], phys[clean])
    np.testing.assert_allclose(wt[sel], wj[sel], rtol=0, atol=W_TOL)
    np.testing.assert_allclose(_sign_aligned(vt[sel], vj[sel]), vj[sel],
                               rtol=0, atol=V_TOL)
    scale = np.maximum(1.0, np.abs(wj).max(-1, keepdims=True))[okj]
    assert np.max(np.abs(wt[okj] - wj[okj]) / scale) < 1e-7
    assert np.max(np.abs(_sign_aligned(vt[okj], vj[okj]) - vj[okj])) < 1e-7


@pytest.mark.parametrize("negate", [False, True])
def test_estimate_k_and_velocities_match_jax(case, negate):
    wj, vj, kj, okj = case["all_k"]
    least, best, unique = _least_roots(kj, okj)
    sign = -1.0 if negate else 1.0
    z = tmin.build_z_columns(*case["samples"][:2])
    k = tmin.estimate_k(z, *case["samples"][2:], compat_negate=negate)
    np.testing.assert_allclose(np.abs(k.numpy()), np.abs(least),
                               rtol=K_RTOL, atol=0)
    np.testing.assert_allclose(k.numpy()[unique], sign * least[unique],
                               rtol=K_RTOL, atol=0)
    w, v, k2 = tmin.calculate_velocities(*case["samples"], True,
                                         compat_negate_k=negate)
    assert torch.equal(k2, k)
    if not negate:
        # The samples whose least root is the physical one: JAX's all-k
        # slot of that root is its calculate_velocities(use_k=True).
        rows = np.arange(TRIALS)
        clean = unique & (np.abs(least - K_TRUE) < 1e-4)
        assert clean.sum() >= 10
        sel = (rows[clean], best[clean])
        np.testing.assert_allclose(w.numpy()[clean], wj[sel], rtol=0,
                                   atol=W_TOL)
        np.testing.assert_allclose(_sign_aligned(v.numpy()[clean], vj[sel]),
                                   vj[sel], rtol=0, atol=V_TOL)
    assert torch.isfinite(w).all() and torch.isfinite(v).all()


def test_float32_newton_engine_matches_jax():
    rng = np.random.default_rng(0)
    n = 32
    starts = np.asarray(tmin._K_NEWTON_STARTS)
    roots = starts + rng.uniform(-0.1, 0.1, size=(n, 6))
    q, _ = np.linalg.qr(rng.normal(size=(n, 6, 6)))
    m = rng.normal(size=(n, 6, 6)) + 3.0 * np.eye(6)
    # det(p + κ·p_k) = det(m)·Π(κ - roots).
    p = (-m @ (q @ (roots[..., None] * np.swapaxes(q, -1, -2)))).astype(
        np.float32)
    p_k = m.astype(np.float32)
    want_re, want_im = (np.asarray(x) for x in jax.jit(functools.partial(
        jmin._k_roots_newton, dtype=jnp.float32))(p, p_k))
    got_re, got_im = tmin._k_roots_newton(torch.from_numpy(p),
                                          torch.from_numpy(p_k))
    assert got_re.dtype == torch.float32
    assert np.all(want_im == 0.0) and np.all(got_im.numpy() == 0.0)
    np.testing.assert_allclose(got_re.numpy(), want_re, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_re.numpy(), roots, rtol=0, atol=2e-5)
    # estimate_k_roots picks the engine by dtype: float32 gives Newton's
    # flags (imaginary parts exactly 0 or 1).
    z = tmin.build_z_columns(torch.zeros(3, 9, 2), torch.zeros(3, 9, 2))
    _, im = tmin.estimate_k_roots(z + torch.eye(9), torch.ones(3, 9),
                                  torch.ones(3, 9))
    assert im.dtype == torch.float32 and set(im.unique().tolist()) <= {0., 1.}


def test_ransac_all_k_with_prescore_matches_jax(case):
    rr = case["rr"]
    got = ransac(*case["inputs"], use_k=True, trials=TRIALS, tolerance=TOL,
                 sample_indices=case["idx"], prescore_subsample=PRESCORE,
                 prescore_keep=KEEP, top_j=STARTS)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(rr.v), rtol=0,
                               atol=V_TOL)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(rr.w), rtol=0,
                               atol=W_TOL)
    np.testing.assert_allclose(float(got.k), float(rr.k), rtol=K_RTOL)
    assert int(got.num_inliers) == int(rr.num_inliers) > 0.9 * H * W
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(rr.inlier_mask))
    np.testing.assert_allclose(float(got.inlier_error),
                               float(rr.inlier_error), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.top_v.numpy(), np.asarray(rr.top_v),
                               rtol=0, atol=V_TOL)
    np.testing.assert_allclose(got.top_w.numpy(), np.asarray(rr.top_w),
                               rtol=0, atol=W_TOL)
    np.testing.assert_allclose(got.top_k.numpy(), np.asarray(rr.top_k),
                               rtol=K_RTOL)
    assert abs(float(got.k) - K_TRUE) < 1e-6


@pytest.mark.parametrize("negate", [False, True])
def test_ransac_min_root_mode(case, negate):
    """k_mode "min": one hypothesis a sample, k its least root (JAX's, from
    the all-k reference) with the reference's sign under compat_negate_k;
    the best of them wins by count."""
    wj, vj, kj, okj = case["all_k"]
    least = _least_roots(kj, okj)[0] * (-1.0 if negate else 1.0)
    got = ransac(*case["inputs"], use_k=True, trials=TRIALS, tolerance=TOL,
                 sample_indices=case["idx"], k_mode="min",
                 compat_negate_k=negate)
    assert np.min(np.abs(least - float(got.k))) <= K_RTOL * abs(
        float(got.k))
    if not negate:
        assert abs(float(got.k) - K_TRUE) < 1e-6
    assert int(got.num_inliers) > 0.5 * H * W


def test_k_scan_matches_jax(case):
    rr = case["rr"]
    coords, flow_n, alpha, alpha_k, _ = case["inputs"]
    mask = torch.from_numpy(np.array(rr.inlier_mask))
    v0 = torch.from_numpy(np.array(rr.v))
    w0 = torch.from_numpy(np.array(rr.w))
    got = k_scan(coords, flow_n, alpha, alpha_k, mask, v0, w0,
                 torch.from_numpy(K_GRID), iters=3)
    v, w, k, rho, cost = case["scan"]
    np.testing.assert_allclose(got[0].numpy(), v, rtol=0, atol=V_TOL)
    np.testing.assert_allclose(got[1].numpy(), w, rtol=0, atol=W_TOL)
    assert float(got[2]) == float(k)
    np.testing.assert_allclose(got[3].numpy(), rho, rtol=K_RTOL, atol=0)
    np.testing.assert_allclose(float(got[4]), float(cost), rtol=1e-9)
    # J starts at once: each start's scan alone.
    starts = ransac(*case["inputs"], use_k=True, trials=TRIALS,
                    tolerance=TOL, sample_indices=case["idx"], top_j=STARTS)
    _, _, _, masks = _score_hypotheses(
        coords, flow_n, alpha, alpha_k, case["inputs"][4], starts.top_v,
        starts.top_w, starts.top_k, TOL)
    batched = k_scan(coords, flow_n, alpha, alpha_k, masks, starts.top_v,
                     starts.top_w, torch.from_numpy(K_GRID), iters=3)
    for j in (0, STARTS - 1):
        one = k_scan(coords, flow_n, alpha, alpha_k, masks[j],
                     starts.top_v[j], starts.top_w[j],
                     torch.from_numpy(K_GRID), iters=3)
        for a, b in zip(batched, one):
            np.testing.assert_allclose(a[j].numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-15)
