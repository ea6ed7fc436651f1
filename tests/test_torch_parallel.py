"""Sharded estimation of rs_sfm_tpu_torch on the CPU: kernel B7's plain
versions against the JAX package, and the sharded refinement, sample pool
and estimation over gloo ranks (tests/torch_parallel_ranks.py; each rank is
a fresh process with one thread that imports no JAX).

Tolerances:
  * B7 sums against JAX's interpret-mode lm_sums_multi: rtol 1e-5 of each
    sum or of its Cauchy-Schwarz bound (float32 summation order over 2048
    pixels; see tests/test_torch_refine.py), ρ_eff exactly equal and
    ρ_new within atol 5e-7 (XLA's CPU fusion contracts the VarPro step's
    products into FMAs; ρ is 0.1-0.4, so that is a few ulps);
  * B7 decide against JAX's lm_decide at unit damping: the state slots as
    tests/test_torch_refine.py (rtol 1e-5, atol 1e-7);
  * world size 1 (no group, or a one-rank group): bit-identical to the
    unsharded port;
  * more ranks: the sums are added in another order, so v is compared as
    a direction and w, cost and counts within float32 noise (gates below).
The sharded estimation is held against the unsharded port on the same
hypotheses, which tests/test_torch_pipeline.py holds against JAX: one JAX
shard_map estimation would cost this file about two minutes of compiling.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rs_sfm_tpu.ops.pallas import refine_kernels as jrk
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.flow import dense
from rs_sfm_tpu_torch.ops.kernels import refine_kernels as trk
from rs_sfm_tpu_torch.parallel import distributed
from rs_sfm_tpu_torch.parallel.api import block_rows, pool_pixels
from rs_sfm_tpu_torch.parallel.launch import spawn
from rs_sfm_tpu_torch.solver import refine_fused as tref
from rs_sfm_tpu_torch.solver.pipeline import (estimate_from_flow,
                                              prepare_flow_inputs)
from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

import torch_parallel_ranks as ranks

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

N = 2048
HUBER = 1e-3
# More ranks against one, the gates the repo uses for float32 summation
# order (tests/test_torch_pipeline.py, chip_smoke.py's 21-sweep check): v
# direction and w (atol), cost and depth (rtol), masks (share of pixels).
GATES = {"v_direction": 2e-4, "w": 1e-5, "cost": 1e-4, "depth": 1e-3,
         "mask_share": 1e-3}
CFG = PipelineConfig(ransac_trials=16, ransac_tol=0.01, refine_iterations=6,
                     refine_starts=2, refine_winnow_iters=3,
                     refine_rel_tol=0.0, refine_loss_delta_px=3.0,
                     depth_residual_px=2.0, ransac_engine="pallas",
                     refine_engine="pallas")
POOL = 256


def _problem(seed=0):
    """N pixels of a noisy RS flow (float32) with a block of outliers, and
    J = 2 starts: (coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-0.6, 0.6, (N, 2)).astype(np.float32)
    v = np.array([0.02, -0.01, 0.015])
    w = np.array([0.004, -0.002, 0.008])
    rho = 1.0 / rng.uniform(3.0, 9.0, N)
    alpha = rng.uniform(0.1, 0.9, N)
    alpha_k = alpha * alpha * 0.5
    x, y = coords[:, 0].astype(np.float64), coords[:, 1].astype(np.float64)
    ax, ay = v[0] - x * v[2], v[1] - y * v[2]
    bx = -x * y * w[0] + (1 + x * x) * w[1] - y * w[2]
    by = -(1 + y * y) * w[0] + x * y * w[1] + x * w[2]
    flow = np.stack([alpha * (ax * rho + bx), alpha * (ay * rho + by)], 1)
    flow += rng.normal(scale=2e-4, size=(N, 2))
    flow[:64] += [3e-3, -2e-3]
    masks = rng.uniform(size=(2, N)) > 0.2
    v0 = np.stack([v * 1.1 + 0.003, v * 1.4 + 0.003])
    w0 = np.stack([w * 0.9, w * 0.5])
    rho0 = rho[None] * rng.uniform(0.8, 1.2, (2, 1))
    f32 = np.float32
    return (coords, flow.astype(f32), alpha.astype(f32), alpha_k.astype(f32),
            masks, v0.astype(f32), w0.astype(f32), np.zeros(2, f32),
            rho0.astype(f32))


def _b7_inputs():
    """(state, px, masks, rho_prev, rho_cand) of one mid-run step: start 0
    accepted its candidate, start 1 rejected it; both back-substitute."""
    coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0 = _problem()
    z = np.zeros(N, np.float32)
    px = np.stack([coords[:, 0], coords[:, 1], flow[:, 0], flow[:, 1], alpha,
                   alpha_k, z, z]).astype(np.float32)
    state = np.zeros((2, 128), np.float32)
    theta = np.concatenate([v0, w0, k0[:, None]], 1)
    state[:, 0:7] = theta
    state[:, 7:14] = theta * np.float32(1.01)
    state[:, trk.S_KKEEP] = 1.0
    state[:, trk.S_ACCEPT] = [1.0, 0.0]
    state[:, trk.S_ACTIVE] = 1.0
    rho_cand = (rho0 * np.float32(1.05)).astype(np.float32)
    return state, px, masks.astype(np.float32), rho0, rho_cand


def sums_from_jax(accj, accs, accv):
    """The JAX lm_sums_multi accumulators (accj (J, 16, 16), accs (J, 8, 8),
    accv (J, 128)) as the port's (J, 71) sums: the mapping of the first
    lines of the JAX lm_decide (rs_sfm_tpu/ops/pallas/refine_kernels.py:
    665-669)."""
    accj, accs, accv = (np.asarray(a) for a in (accj, accs, accv))
    ti, tj = np.triu_indices(7)
    jj = accj[:, 0:8, 0:8] + accj[:, 8:16, 8:16]
    return np.concatenate([jj[:, ti, tj], accv[:, 28:36], accs[:, ti, tj],
                           accv[:, 64:71]], axis=1)


def test_lm_sums_multi_matches_jax():
    state, px, masks, rho_prev, rho_cand = _b7_inputs()
    je, jn, accj, accs, accv = jrk.lm_sums_multi(
        jnp.asarray(state), jnp.asarray(px), jnp.asarray(masks),
        jnp.asarray(rho_prev), jnp.asarray(rho_cand), interpret=True,
        tile=N, loss_delta=HUBER)
    te, tn, sums = trk.lm_sums_multi(*(torch.from_numpy(a) for a in (
        state, px, masks, rho_prev, rho_cand)), loss_delta=HUBER)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # ρ_new = ρ_eff + step: XLA contracts the step's residual products into
    # FMAs, so it differs by a few ulps of ρ (values 0.1-0.4).
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=5e-7)
    assert not np.array_equal(tn.numpy(), te.numpy())  # VarPro moved rho
    bad = trk.sums_mismatches(sums.numpy(),
                              sums_from_jax(accj, accs, accv))
    assert not bad, bad[:10]


def test_lm_decide_matches_jax():
    state, px, masks, rho_prev, rho_cand = _b7_inputs()
    sums = trk.lm_sums_multi_plain(*(torch.from_numpy(a) for a in (
        state, px, masks, rho_prev, rho_cand)), loss_delta=HUBER)[2].numpy()
    # Start 0 accepts (cost_prev inf), start 1 rejects and keeps its sums;
    # both solve at unit damping (lambda 3 -> 1 on accept).
    st = state.copy()
    st[:, trk.S_LAM] = [3.0, 0.25]
    st[:, trk.S_COST] = [np.inf, 0.5 * sums[1, 35]]
    st[:, trk.S_COST0] = 7.0
    st[1, trk.S_SUMS:trk.S_SUMS + trk.N_SUMS] = sums[1] * np.float32(0.9)
    got = trk.lm_decide(torch.from_numpy(st), torch.from_numpy(sums)).numpy()
    ts, ti = np.triu_indices(7)
    s = jnp.asarray(sums)
    jj = jnp.zeros((2, 16, 16), jnp.float32).at[:, ts, ti].set(s[:, 0:28])
    accs = jnp.zeros((2, 8, 8), jnp.float32).at[:, ts, ti].set(s[:, 36:64])
    accv = jnp.zeros((2, 128), jnp.float32).at[:, 28:36].set(
        s[:, 28:36]).at[:, 64:71].set(s[:, 64:71])
    ref = np.asarray(jrk.lm_decide(jnp.asarray(st), jj, accs, accv))
    np.testing.assert_array_equal(sums_from_jax(jj, accs, accv), sums)
    assert got[:, trk.S_ACCEPT].tolist() == [1.0, 0.0]
    bad = trk.state_mismatches(got, ref)
    assert not bad, bad[:10]


def test_split_iteration_equals_fused_on_cpu():
    args = [torch.from_numpy(a) for a in _b7_inputs()]
    rho_eff, rho_new, sums = trk.lm_sums_multi(*args, loss_delta=HUBER)
    fused = trk.lm_iter_multi(*args, loss_delta=HUBER)
    split = (trk.lm_decide(args[0], sums), rho_eff, rho_new)
    for a, b in zip(split, fused):
        assert torch.equal(a, b)


def _refine_kwargs():
    return dict(optimize_k=False, iterations=8, rel_tol=0.0,
                loss_delta=HUBER)


def _unsharded_refine():
    args = [torch.from_numpy(a) for a in _problem()]
    return tref.refine_pallas_multi(*args, **_refine_kwargs())


def test_sharded_refine_without_group_is_bit_identical():
    args = [torch.from_numpy(a) for a in _problem()]
    got = tref.refine_pallas_multi_sharded(*args, group=None,
                                           **_refine_kwargs())
    for f, ref in zip(got._fields, _unsharded_refine()):
        assert torch.equal(getattr(got, f), ref), f


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_refine_over_gloo_matches_unsharded(world):
    ref = _unsharded_refine()
    outs = spawn(ranks.refine, world, _problem(), _refine_kwargs())
    for f in ("v", "w", "k", "cost", "initial_cost"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f], outs[0][f])  # replicated
    inv_depth = np.concatenate([o["inv_depth"] for o in outs], axis=1)
    if world == 1:
        for f in ref._fields:
            np.testing.assert_array_equal(
                inv_depth if f == "inv_depth" else outs[0][f],
                getattr(ref, f).numpy(), err_msg=f)
        return
    got = outs[0]
    np.testing.assert_allclose(_unit(got["v"]), _unit(ref.v.numpy()),
                               rtol=0, atol=GATES["v_direction"])
    np.testing.assert_allclose(got["w"], ref.w.numpy(), rtol=0,
                               atol=GATES["w"])
    np.testing.assert_allclose(got["cost"], ref.cost.numpy(),
                               rtol=GATES["cost"])
    assert got["cost"].max() < got["initial_cost"].min()


def test_shared_sample_pool_matches_formula():
    n, size, world = 100, 16, 2
    outs = spawn(ranks.pool, world, n, size)
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)
    coords, flow, alpha, alpha_k, valid = outs[0]
    # rs_sfm_tpu/solver/ransac.py:48-57: rank s's pixels (i * stride) % n
    # fill slots s * pool .. (s + 1) * pool - 1.
    idx = (np.arange(size) * max(n // size, 1)) % n
    pix = np.concatenate([idx + 1000.0 * s for s in range(world)])
    np.testing.assert_array_equal(coords, np.stack([pix, -pix], 1))
    np.testing.assert_array_equal(flow, np.stack([pix + 0.5, pix - 0.5], 1))
    np.testing.assert_array_equal(alpha, pix * 2.0)
    np.testing.assert_array_equal(alpha_k, pix * 3.0)
    np.testing.assert_array_equal(
        valid, np.concatenate([(idx + s) % 3 != 0 for s in range(world)]))


def _pool_draws(flow, world, seed=4):
    """(draws (trials, 9) into the valid pixels of the shared pool, the same
    pixels as indices into the whole image)."""
    h, w = flow.shape[:2]
    valid = prepare_flow_inputs(torch.from_numpy(flow),
                                ranks.intrinsics(h, w), ranks.GAMMA,
                                CFG)[4].numpy()
    pixel = pool_pixels(h, w, world, POOL)
    pool_valid = valid[np.minimum(pixel, h * w - 1)] & (pixel < h * w)
    draws = sample_valid_indices(torch.Generator().manual_seed(seed),
                                 torch.from_numpy(pool_valid),
                                 CFG.ransac_trials).numpy()
    return draws, pixel[draws]


def _assert_close(got, ref, h, w):
    """Sharded (rank 0's scalars) against unsharded, within GATES."""
    np.testing.assert_allclose(_unit(got["v"]), _unit(ref.v.numpy()), rtol=0,
                               atol=GATES["v_direction"])
    np.testing.assert_allclose(got["w"], ref.w.numpy(), rtol=0,
                               atol=GATES["w"])
    assert (abs(int(got["num_inliers"]) - int(ref.num_inliers))
            <= GATES["mask_share"] * h * w)
    assert int(got["num_inliers"]) > 0.9 * h * w


@pytest.mark.parametrize("world,h", [(2, 32), (3, 34)])
def test_estimate_sharded_matches_unsharded(world, h):
    """Two ranks on 32 rows, and three on 34 (padded to 36: the last
    block holds two padding rows).  With two ranks, a warm-started
    single-start estimation under the group too (the feedback passes'
    mode: scoring, one sharded LM start, the re-scored inlier count)."""
    flow = ranks.rs_flow(h, 64)
    draws, pixels = _pool_draws(flow, world)
    warm_cfg = dataclasses.replace(CFG, refine_starts=1,
                                   refine_winnow_iters=0)
    start = (np.float32([0.7, -0.35, 0.55]), np.float32([0.003, -0.002,
                                                         0.004]),
             np.float32(0.0))
    outs = spawn(ranks.estimate, world, flow, CFG, draws, POOL,
                 warm_cfg, start if h % world == 0 else None)
    ref = estimate_from_flow(torch.from_numpy(flow),
                             ranks.intrinsics(h, 64), ranks.GAMMA, CFG,
                             sample_indices=pixels)
    if h % world == 0:
        warm = [o[1] for o in outs]
        for o in warm[1:]:
            for f in ("v", "w", "k", "num_inliers", "refine_cost"):
                np.testing.assert_array_equal(o[f], warm[0][f], err_msg=f)
        ref_warm = estimate_from_flow(
            torch.from_numpy(flow), ranks.intrinsics(h, 64), ranks.GAMMA,
            warm_cfg, warm_start=tuple(torch.as_tensor(a) for a in start))
        _assert_close(warm[0], ref_warm, h, 64)
    outs = [o[0] for o in outs]
    for f in ("v", "w", "k", "num_inliers", "refine_cost", "top_v", "top_w",
              "ransac_v", "ransac_w"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f], outs[0][f], err_msg=f)
    for f in ("depth_map", "inlier_mask", "valid_mask"):
        rows = [o[f].shape[0] for o in outs]
        assert rows == [block_rows(h, world, s)[1] for s in range(world)]
    for f in ("inlier_mask", "valid_mask", "depth_map"):
        got = np.concatenate([o[f] for o in outs])
        want = getattr(ref, f).numpy()
        if f == "valid_mask":
            np.testing.assert_array_equal(got, want)
        elif f == "inlier_mask":
            assert np.mean(got != want) < GATES["mask_share"]
        else:
            both = (got != 0) & (want != 0)
            assert np.mean((got != 0) != (want != 0)) < GATES["mask_share"]
            np.testing.assert_allclose(got[both], want[both],
                                       rtol=GATES["depth"])
    np.testing.assert_allclose(_unit(outs[0]["ransac_v"]),
                               _unit(ref.ransac_v.numpy()), rtol=0, atol=1e-6)
    _assert_close(outs[0], ref, h, 64)


def test_estimate_pairs_batched_equals_per_pair():
    """A (2, 1) mesh: each rank estimates one pair on a one-rank pixels
    group, which must be bit-identical to the unsharded port; both ranks
    receive both results.  make_mesh refuses a (3, 1) layout of 2 ranks."""
    flows = np.stack([ranks.rs_flow(24, 48, seed=s) for s in (1, 2)])
    draws = [_pool_draws(f, 1, seed=s) for s, f in enumerate(flows)]
    outs = spawn(ranks.pairs, 2, flows, CFG, np.stack([d[0] for d in draws]),
                 POOL)
    for refused, shape, res in outs:
        assert refused and shape == {"pairs": 2, "pixels": 1}
        for b, flow in enumerate(flows):
            ref = estimate_from_flow(torch.from_numpy(flow),
                                     ranks.intrinsics(24, 48), ranks.GAMMA,
                                     CFG, sample_indices=draws[b][1])
            for f in ref._fields:
                np.testing.assert_array_equal(res[f][b],
                                              getattr(ref, f).numpy(),
                                              err_msg=f)


def test_collectives_without_group_and_loud_initialize():
    x = torch.arange(3.0)
    assert distributed.psum(x, None) is x
    assert distributed.broadcast(x, None) is x
    assert distributed.axis_size(None) == 1
    assert distributed.axis_index(None) == 0
    with pytest.raises(ValueError):
        distributed.initialize("tcp://127.0.0.1:1", world_size=2, rank=2)


def test_sharded_unported_options_raise():
    cfg = dataclasses.replace(CFG, ransac_prescore_subsample=64)
    flow = torch.from_numpy(ranks.rs_flow(16, 32))
    with pytest.raises(NotImplementedError):
        estimate_from_flow(flow, ranks.intrinsics(16, 32), ranks.GAMMA, cfg,
                           torch.Generator().manual_seed(0),
                           group=object(), row_offset=0, total_rows=16)


def test_flow_entry_points_need_a_card_for_numpy_input(monkeypatch):
    """Frames given as numpy arrays run on the card; without one the flow
    raises instead of running on the CPU.  CPU tensors are the caller's
    explicit choice and still run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.random.default_rng(0).uniform(0.1, 0.9, (32, 48)).astype(
        np.float32)
    cfg = dense.DenseFlowConfig(levels=2, warps=1, iters=2)
    for fn in (dense.dense_flow_aux, dense.flow_forward_backward):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(img, img, cfg)
    out = dense.flow_forward_backward(torch.from_numpy(img),
                                      torch.from_numpy(img), cfg)
    assert out.flow.shape == (32, 48, 2)
    assert torch.isfinite(out.flow).all()
