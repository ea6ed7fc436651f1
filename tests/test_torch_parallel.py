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
shard_map estimation would cost this file about two minutes of compiling
(scripts/sharded_gate_jax.py makes that comparison once, outside these
tests).

Every 2-rank run of this file shares ONE spawn (the `two_ranks`
fixture): the refinement, the pool, the estimation on 32 rows, the pair
batch, and the full sharded feature set (tests/test_parallel.py::
test_sharded_full_features' configuration: acceleration with 9 k points,
the prescore, 2 starts, on the "xla" and the fused engines; the prescore
alone; the prescore's vote table; global_mesh).  FULL_GATES gives the
feature set's gates against the unsharded port, and the JAX test's own
thresholds apply too.  k_scan and the "xla" refine over a gloo group of
one rank are bit-identical to group=None.
"""

import dataclasses
import functools

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
from rs_sfm_tpu_torch.data.synthetic import (castle_scene, default_intrinsics,
                                             render_pair)
from rs_sfm_tpu_torch.flow.true_flow import true_flow
from rs_sfm_tpu_torch.solver.kscan import k_scan
from rs_sfm_tpu_torch.solver.ransac import prescore_votes
from rs_sfm_tpu_torch.solver.refine import refine as refine_xla

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
def test_sharded_refine_over_gloo_matches_unsharded(world, request):
    ref = _unsharded_refine()
    outs = (request.getfixturevalue("two_ranks")["refine"] if world == 2
            else spawn(ranks.refine, world, _problem(), _refine_kwargs()))
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


def test_shared_sample_pool_matches_formula(two_ranks):
    (n, size), world = POOL_ARGS, 2
    outs = two_ranks["pool"]
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


def _estimate_args(world, h):
    """ranks.estimate's arguments for `world` ranks on h rows."""
    flow = ranks.rs_flow(h, 64)
    draws, _ = _pool_draws(flow, world)
    warm_cfg = dataclasses.replace(CFG, refine_starts=1,
                                   refine_winnow_iters=0)
    start = (np.float32([0.7, -0.35, 0.55]), np.float32([0.003, -0.002,
                                                         0.004]),
             np.float32(0.0))
    return (flow, CFG, draws, POOL, warm_cfg,
            start if h % world == 0 else None)


@pytest.mark.parametrize("world,h", [(2, 32), (3, 34)])
def test_estimate_sharded_matches_unsharded(world, h, request):
    """Two ranks on 32 rows, and three on 34 (padded to 36: the last
    block holds two padding rows).  With two ranks, a warm-started
    single-start estimation under the group too (the feedback passes'
    mode: scoring, one sharded LM start, the re-scored inlier count)."""
    flow, _, _, _, warm_cfg, start = _estimate_args(world, h)
    pixels = _pool_draws(flow, world)[1]
    outs = (request.getfixturevalue("two_ranks")["estimate"]
            if (world, h) == (2, 32)
            else spawn(ranks.estimate, world, *_estimate_args(world, h)))
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


def _pairs_inputs():
    flows = np.stack([ranks.rs_flow(24, 48, seed=s) for s in (1, 2)])
    return flows, [_pool_draws(f, 1, seed=s) for s, f in enumerate(flows)]


def test_estimate_pairs_batched_equals_per_pair(two_ranks):
    """A (2, 1) mesh: each rank estimates one pair on a one-rank pixels
    group, which must be bit-identical to the unsharded port; both ranks
    receive both results.  make_mesh refuses a (3, 1) layout of 2 ranks."""
    flows, draws = _pairs_inputs()
    outs = two_ranks["pairs"]
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


def test_sharded_unported_options_raise(full_features):
    """The prescore, which the sharded estimation refused before it was
    ported, now runs on 2 ranks: held to the unsharded port within GATES
    (the union of the blocks' subsamples ranks the hypotheses, so the
    unsharded prescore's pixels are not the same ones)."""
    outs, ref = full_features["prescore"]
    for f in ("v", "w", "k", "num_inliers", "refine_cost"):
        np.testing.assert_array_equal(outs[1][f], outs[0][f], err_msg=f)
    _assert_close(outs[0], ref, 32, 64)


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


# tests/test_parallel.py::test_sharded_full_features, the JAX package's
# sharded configuration: the 64x64 castle (k 0), acceleration with 9 k
# points, the prescore (256 pixels, keep 8), 2 starts, 256 pool pixels a
# rank, on both engines ("xla" on the float64 flow as there, the fused
# engine's plain twins on its float32 rounding).
FULL_SIZE, FULL_GAMMA = 64, 0.9
FULL_V, FULL_W = np.array([0.12, -0.05, 0.08]), np.array([0.003, -0.002,
                                                         0.004])
FULL_CFG = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                          refine_iterations=20, refine_starts=2,
                          use_acceleration=True, k_scan_points=9,
                          ransac_prescore_subsample=256,
                          ransac_prescore_keep=8)
FULL_ENGINES = {"xla": {}, "pallas": dict(refine_engine="pallas",
                                          ransac_engine="pallas")}
# The sharded run against the unsharded one on the same draws, 2 ranks
# (measured: "xla" in float64 v 0 rad, w 4e-19, |dk| 2e-16; the fused
# engine in float32 v 3.7e-8 rad, w 2.3e-10, |dk| 1.0e-7; inlier masks
# equal on both).
FULL_GATES = {"v_direction": 1e-6, "w": 1e-8, "k": 1e-6,
              "inlier_share": 1e-3}
PRESCORE_CFG = dataclasses.replace(CFG, ransac_prescore_subsample=64,
                                   ransac_prescore_keep=8)


@functools.lru_cache(maxsize=None)
def _castle_flow():
    intr = default_intrinsics(FULL_SIZE, FULL_SIZE)
    pair = render_pair(castle_scene(torch.float64, "cpu"), intr, FULL_SIZE,
                       FULL_SIZE, gamma=FULL_GAMMA, k=0.0, v=FULL_V, w=FULL_W,
                       dtype=torch.float64)
    return true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr).numpy(), intr


def _draws_for(flow, intr, cfg, world, pool, seed):
    valid = prepare_flow_inputs(torch.from_numpy(flow), intr, FULL_GAMMA,
                                cfg)[4].numpy()
    h, w = flow.shape[:2]
    pixel = pool_pixels(h, w, world, pool)
    pool_valid = valid[np.minimum(pixel, h * w - 1)] & (pixel < h * w)
    draws = sample_valid_indices(torch.Generator().manual_seed(seed),
                                 torch.from_numpy(pool_valid),
                                 cfg.ransac_trials).numpy()
    return draws, pixel[draws]


def _prescore_hypotheses(seed=9):
    rng = np.random.default_rng(seed)
    v = (FULL_V + rng.normal(scale=0.02, size=(12, 3)))
    w = (FULL_W + rng.normal(scale=5e-4, size=(12, 3)))
    k = rng.uniform(-0.3, 0.3, 12)
    return v, w, k


POOL_ARGS = (100, 16)


@pytest.fixture(scope="module")
def two_ranks():
    """ONE spawn of 2 gloo ranks for every 2-rank run of this file, in
    sequence (a rank's interpreter and imports cost more than most of
    these runs): {run: [rank 0's value, rank 1's]}."""
    flows, draws = _pairs_inputs()
    calls = {
        "refine": ("refine", (_problem(), _refine_kwargs())),
        "pool": ("pool", POOL_ARGS),
        "estimate": ("estimate", _estimate_args(2, 32)),
        "pairs": ("pairs", (flows, CFG, np.stack([d[0] for d in draws]),
                            POOL)),
        "full_features": ("full_features", _full_features_jobs()[:2])}
    outs = spawn(ranks.batch, 2, list(calls.values()))
    return {name: [o[i] for o in outs] for i, name in enumerate(calls)}


def _full_features_jobs():
    """(jobs, prescore arguments, names, unsharded references) of
    ranks.full_features: each configuration on its flow and pool draws,
    and the unsharded port's run on the same draws (a callable)."""
    flow64, intr = _castle_flow()
    world, pool = 2, 256
    jobs, refs, names = [], [], []
    for name, change in FULL_ENGINES.items():
        cfg = dataclasses.replace(FULL_CFG, **change)
        flow = flow64 if name == "xla" else flow64.astype(np.float32)
        draws, pixels = _draws_for(flow, intr, cfg, world, pool, seed=3)
        jobs.append((flow, intr, FULL_GAMMA, cfg, draws, pool))
        refs.append(lambda f=flow, c=cfg, p=pixels: estimate_from_flow(
            torch.from_numpy(f), intr, FULL_GAMMA, c, sample_indices=p))
        names.append(name)
    flow = ranks.rs_flow(32, 64)
    draws, pixels = _pool_draws(flow, world)
    pintr = ranks.intrinsics(32, 64)
    jobs.append((flow, pintr, ranks.GAMMA, PRESCORE_CFG, draws, POOL))
    refs.append(lambda: estimate_from_flow(
        torch.from_numpy(flow), pintr, ranks.GAMMA, PRESCORE_CFG,
        sample_indices=pixels))
    names.append("prescore")
    hyps = _prescore_hypotheses()
    prescore_args = (flow64.astype(np.float32), intr, FULL_GAMMA, FULL_CFG,
                     *hyps, 128)
    return jobs, prescore_args, names, refs


@pytest.fixture(scope="module")
def full_features(two_ranks):
    """Every sharded configuration of ranks.full_features (run in the one
    2-rank spawn), beside the unsharded port on the same draws."""
    _, prescore_args, names, refs = _full_features_jobs()
    outs = two_ranks["full_features"]
    got = {name: ([o[0][i] for o in outs], refs[i]())
           for i, name in enumerate(names)}
    got["votes"] = [o[1] for o in outs]
    got["mesh"] = [o[2] for o in outs]
    got["prescore_args"] = prescore_args
    return got


def _angle(a, b):
    a, b = _unit(a), _unit(b)
    return float(np.arccos(np.clip(abs(a @ b), -1.0, 1.0)))


@pytest.mark.parametrize("engine", sorted(FULL_ENGINES))
def test_sharded_full_features_replicated(full_features, engine):
    """Every scalar output is the same on both ranks, bit for bit."""
    outs, _ = full_features[engine]
    for f in ("v", "w", "k", "num_inliers", "refine_cost", "ransac_v",
              "ransac_w", "ransac_k", "top_v", "top_w", "top_k"):
        np.testing.assert_array_equal(outs[1][f], outs[0][f], err_msg=f)
    for f in ("depth_map", "inlier_mask", "valid_mask"):
        assert [o[f].shape[0] for o in outs] == [FULL_SIZE // 2] * 2


@pytest.mark.parametrize("engine", sorted(FULL_ENGINES))
def test_sharded_full_features_match_unsharded(full_features, engine):
    outs, ref = full_features[engine]
    got = outs[0]
    assert _angle(got["v"], ref.v.numpy()) <= FULL_GATES["v_direction"]
    np.testing.assert_allclose(got["w"], ref.w.numpy(), rtol=0,
                               atol=FULL_GATES["w"])
    assert abs(float(got["k"]) - float(ref.k)) <= FULL_GATES["k"]
    n = FULL_SIZE * FULL_SIZE
    assert (abs(int(got["num_inliers"]) - int(ref.num_inliers))
            <= FULL_GATES["inlier_share"] * n)
    mask = np.concatenate([o["inlier_mask"] for o in outs])
    assert np.mean(mask != ref.inlier_mask.numpy()) <= FULL_GATES[
        "inlier_share"]


@pytest.mark.parametrize("engine", sorted(FULL_ENGINES))
def test_sharded_full_features_pass_jax_thresholds(full_features, engine):
    """tests/test_parallel.py's own thresholds (_check, |k|, inliers)."""
    got = full_features[engine][0][0]
    assert _angle(got["v"], FULL_V) < 0.05
    assert np.linalg.norm(got["w"] - FULL_W) < 2e-3
    assert abs(float(got["k"])) < 0.3  # true k = 0
    assert int(got["num_inliers"]) > 0.5 * FULL_SIZE * FULL_SIZE


def test_sharded_prescore_votes_equal_concatenated_subsamples(
        full_features):
    """The all-reduced prescore table of 2 blocks equals the unsharded
    table on the two blocks' subsamples concatenated: counts exact, error
    sums within float32 rounding of the two partial sums."""
    flow, intr, gamma, cfg, v, w, k, subsample = full_features[
        "prescore_args"]
    h = flow.shape[0]
    prep = prepare_flow_inputs(torch.from_numpy(flow), intr, gamma, cfg)
    rows = h // 2
    n_loc = rows * flow.shape[1]
    stride = max(n_loc // subsample, 1)
    sub = np.concatenate([r * n_loc + (np.arange(subsample) * stride) % n_loc
                          for r in range(2)])
    pix = [t[torch.from_numpy(sub)] for t in prep]
    want = prescore_votes(*pix, *(torch.from_numpy(a) for a in (v, w, k)),
                          cfg.ransac_tol, 2 * subsample)
    for votes in full_features["votes"]:
        np.testing.assert_array_equal(votes[0], want[0].numpy())
        np.testing.assert_allclose(votes[1], want[1].numpy(), rtol=1e-6)
        assert votes[2] == want[2] == 2 * subsample
    assert want[0].max() > 0


def test_global_mesh_over_spawned_ranks(full_features):
    """spawn's ranks are one host: global_mesh() puts both on the pixels
    axis, the JAX package's layout."""
    assert full_features["mesh"] == [{"pairs": 1, "pixels": 2}] * 2


def test_initialize_without_torchrun_environment_raises(monkeypatch):
    for var in distributed._TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        distributed.initialize()
    with pytest.raises(ValueError):
        distributed.initialize("tcp://127.0.0.1:1")


@pytest.fixture(scope="module")
def one_rank_group():
    with ranks.solo_group() as group:
        yield group


def _scan_inputs():
    flow, intr = _castle_flow()
    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        torch.from_numpy(flow), intr, FULL_GAMMA, FULL_CFG)
    v0 = torch.tensor([[0.7, -0.3, 0.5], [0.6, -0.2, 0.45]],
                      dtype=torch.float64)
    w0 = torch.tensor([[0.003, -0.002, 0.004], [0.0025, -0.0015, 0.004]],
                      dtype=torch.float64)
    every5 = (torch.arange(2)[:, None]
              + torch.arange(valid.shape[0])[None]) % 5
    masks = valid[None] & (every5 != 0)
    return coords, flow_n, alpha, alpha_k, masks, v0, w0


def test_kscan_and_refine_one_rank_group_bit_identical(one_rank_group):
    """k_scan and the "xla" refine over a group of one rank equal
    group=None bit for bit (the all-reduce of one rank is the identity)."""
    coords, flow_n, alpha, alpha_k, masks, v0, w0 = _scan_inputs()
    grid = torch.linspace(-0.5, 2.0, 9, dtype=torch.float64)
    scans = [k_scan(coords, flow_n, alpha, alpha_k, masks, v0, w0, grid,
                    group=g) for g in (None, one_rank_group)]
    for a, b in zip(*scans):
        assert torch.equal(a, b)
    v, w, k, rho, _ = scans[0]
    refs = [refine_xla(coords, flow_n, alpha, alpha_k, masks, v, w, k, rho,
                       optimize_k=True, iterations=6, rel_tol=1e-8,
                       loss_delta=1e-3, group=g)
            for g in (None, one_rank_group)]
    for f in refs[0]._fields:
        assert torch.equal(getattr(refs[0], f), getattr(refs[1], f)), f
    assert (refs[0].cost < refs[0].initial_cost).all()
