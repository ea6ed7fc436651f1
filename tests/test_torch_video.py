"""Frame sequences (video.py, video_ckpt.py): rs_sfm_tpu_torch vs the JAX
package on the CPU, on the castle's true flow at 32x48.

  * `estimate_video` at P = 2, a true flow and a zero flow (the degenerate
    pair that tests/test_video.py poisons), against the JAX package's (one
    jitted run), the port handed the JAX draws of each pair (its key
    split in two): `ok` equal ([True, False]), pair 0's v as a direction
    within 1e-4, w within 1e-6, k equal (0), inliers within 0.5 % of the
    pixels, depth maps per unit |v| (the LM leaves v's norm free) within
    1e-4 relative where both export one (the export masks within 0.5 %);
    pair 1's outputs zero and the port's trajectory holding its pose;
    `accumulate_trajectory` on the JAX package's motions within 1e-6 of
    its own;
  * without JAX: `pair_flows_dense` is dense_flow on each pair; the four
    checkpoint cases of tests/test_video.py (resume ignores changed flows
    of a saved window, a tail window shorter than half a window, a run
    stopped by its callback resumes at the next window, motions-only
    checkpoints) on the port's own un-checkpointed result: each window
    is estimate_video on its flows with the window's generator, and a
    restored window, its depth recomputed when the checkpoint holds none,
    equals the computed one.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax_reference import run_jitted

from rs_sfm_tpu import video as jvideo
from rs_sfm_tpu.config import PipelineConfig as JaxConfig
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.solver import pipeline as jpipeline
from rs_sfm_tpu_torch import video as tvideo
from rs_sfm_tpu_torch import video_ckpt as tckpt
from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.data import synthetic as tsyn
from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.flow.dense import dense_flow
from rs_sfm_tpu_torch.flow.true_flow import true_flow
from rs_sfm_tpu_torch.solver.pipeline import fold_generator

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

jransac = importlib.import_module("rs_sfm_tpu.solver.ransac")

H, W, GAMMA = 32, 48, 0.9
V_TRUE = (0.12, -0.05, 0.08)
W_TRUE = (0.003, -0.002, 0.004)
CFG = dict(ransac_trials=32, ransac_tol=0.01, refine_iterations=10)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def castle():
    """(intrinsics, the castle pair's frames (2, H, W, 3) float32, its true
    flow (H, W, 2) float32), rendered in float64."""
    intr = tsyn.default_intrinsics(H, W)
    pair = tsyn.render_pair(tsyn.castle_scene(torch.float64, "cpu"), intr, H,
                            W, gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                            dtype=torch.float64)
    flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr).float()
    frames = torch.stack([pair.frame1.rs_image, pair.frame2.rs_image]).float()
    return intr, frames, flow


@pytest.fixture(scope="module")
def jax_video(castle):
    intr, _, flow = castle
    flows = np.stack([flow.numpy(), np.zeros_like(flow.numpy())])
    jintr = JaxIntrinsics(**dataclasses.asdict(intr))
    jcfg = JaxConfig(**CFG)
    key = jax.random.PRNGKey(4)

    def run(f):
        res = jvideo.estimate_video(f, jintr, GAMMA, jcfg, key)
        return res, jvideo.accumulate_trajectory(res, GAMMA, H)

    res, traj = run_jitted(run, jnp.asarray(flows))
    keys = jax.random.split(key, 2)
    draws = np.stack([np.array(jransac.sample_valid_indices(
        keys[i], jpipeline.prepare_flow_inputs(
            jnp.asarray(flows[i]), jintr, GAMMA, jcfg)[4],
        CFG["ransac_trials"])) for i in range(2)])
    return flows, draws, jax.tree_util.tree_map(np.asarray, (res, traj))


def test_estimate_video_matches_jax(castle, jax_video):
    intr = castle[0]
    flows, draws, (rj, (rot_j, t_j)) = jax_video
    rt = tvideo.estimate_video(torch.from_numpy(flows), intr, GAMMA,
                               PipelineConfig(**CFG), sample_indices=draws)
    np.testing.assert_array_equal(rt.ok.numpy(), rj.ok)
    np.testing.assert_array_equal(rt.ok.numpy(), [True, False])
    vj, vt = _unit(rj.v[0]), _unit(rt.v[0].numpy())
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-4)
    assert float(vt @ _unit(V_TRUE)) > 0.999
    np.testing.assert_allclose(rt.w.numpy(), rj.w, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rt.k.numpy(), rj.k)
    assert abs(int(rt.num_inliers[0]) - int(rj.num_inliers[0])) <= 5e-3 * H * W
    dt, dj = rt.depth_maps[0].numpy(), rj.depth_maps[0]
    both = (dt != 0) & (dj != 0)
    assert ((dt != 0) != (dj != 0)).mean() <= 5e-3 and both.mean() > 0.5
    # Depth scales with |v| (the LM leaves v's norm free): compare the
    # depth per unit |v|.
    dt_n = dt[both] / np.linalg.norm(rt.v[0].numpy())
    dj_n = dj[both] / np.linalg.norm(rj.v[0])
    np.testing.assert_allclose(dt_n, dj_n, rtol=1e-4)
    # The degenerate pair: zeroed, and the trajectory holds its pose.
    for field in ("v", "w", "k", "depth_maps"):
        assert not torch.any(getattr(rt, field)[1] != 0), field
    rot_t, t_t = tvideo.accumulate_trajectory(rt, GAMMA, H)
    assert rot_t.shape == (3, 3, 3) and t_t.shape == (3, 3)
    assert torch.equal(rot_t[2], rot_t[1]) and torch.equal(t_t[2], t_t[1])
    # On the JAX package's per-pair motions, its trajectory.
    rot_t, t_t = tvideo.accumulate_trajectory(
        tvideo.VideoResult(*(torch.from_numpy(np.array(x)) for x in rj)),
        GAMMA, H)
    np.testing.assert_allclose(rot_t.numpy(), rot_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=0, atol=1e-6)


def test_pair_flows_dense_is_dense_flow_per_pair(castle):
    _, frames, _ = castle
    seq = torch.cat([frames, frames[1:]])  # frame 2 twice: a static pair
    cfg = DenseFlowConfig(levels=2, warps=1, iters=4)
    got = tvideo.pair_flows_dense(seq, cfg)
    assert got.shape == (2, H, W, 2)
    assert torch.equal(got[0], dense_flow(seq[0], seq[1], cfg))
    assert torch.equal(got[1], dense_flow(seq[1], seq[2], cfg))
    assert float(torch.abs(got[1]).max()) < 1e-3 < float(
        torch.abs(got[0]).max())


def _flows(castle, n_pairs):
    return torch.stack([castle[2]] * n_pairs)


def _windows(flows, intr, cfg, generator, window):
    """The un-checkpointed result: estimate_video on each window's flows
    (the last one padded with zero flows) with the window's generator."""
    parts = []
    for wi in range(-(-flows.shape[0] // window)):
        fw = flows[wi * window:(wi + 1) * window]
        n = fw.shape[0]
        fw = torch.cat([fw, fw.new_zeros((window - n,) + fw.shape[1:])])
        res = tvideo.estimate_video(fw, intr, GAMMA, cfg,
                                    fold_generator(generator, wi))
        parts.append([t[:n] for t in res])
    return tvideo.VideoResult(*(torch.cat(ts) for ts in zip(*parts)))


def _equal(a, b):
    for f in tvideo.VideoResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_video_checkpoint_resume(castle, tmp_path):
    """Saved windows are restored, not recomputed: the second run sees
    changed flows for window 0 and returns the saved result."""
    intr = castle[0]
    flows = _flows(castle, 5)  # window 2: 3 windows, the last padded
    cfg = PipelineConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    ckpt = str(tmp_path / "ckpt")
    res1 = tckpt.process_video_checkpointed(flows, intr, GAMMA, cfg, gen,
                                            ckpt_dir=ckpt, window=2)
    _equal(res1, _windows(flows, intr, cfg, gen, 2))
    assert res1.v.shape == (5, 3) and bool(res1.ok.all())
    flows2 = flows.clone()
    flows2[0] = 0.0
    seen = []
    res2 = tckpt.process_video_checkpointed(
        flows2, intr, GAMMA, cfg, gen, ckpt_dir=ckpt, window=2,
        on_window=lambda wi, r: seen.append(wi))
    assert seen == [0, 1, 2]
    _equal(res2, res1)


def test_video_checkpoint_short_tail_window(castle, tmp_path):
    """5 pairs in windows of 4: the tail window holds 1 pair and 3 pads."""
    intr = castle[0]
    flows = _flows(castle, 5)
    cfg = PipelineConfig(**CFG)
    gen = torch.Generator().manual_seed(1)
    res = tckpt.process_video_checkpointed(
        flows, intr, GAMMA, cfg, gen, ckpt_dir=str(tmp_path / "c"), window=4)
    _equal(res, _windows(flows, intr, cfg, gen, 4))
    assert res.v.shape == (5, 3) and bool(res.ok.all())
    assert float(_unit(res.v[4].numpy()) @ _unit(V_TRUE)) > np.cos(0.05)


def test_video_checkpoint_partial_resume(castle, tmp_path):
    """A run stopped by its callback after window 0 resumes at window 1."""
    intr = castle[0]
    flows = _flows(castle, 4)
    cfg = PipelineConfig(**CFG)
    gen = torch.Generator().manual_seed(2)
    ckpt = str(tmp_path / "ckpt2")

    class Stop(Exception):
        pass

    def bomb(wi, r):
        if wi == 0:
            raise Stop()

    with pytest.raises(Stop):
        tckpt.process_video_checkpointed(flows, intr, GAMMA, cfg, gen,
                                         ckpt_dir=ckpt, window=2,
                                         on_window=bomb)
    assert sorted(p.name for p in (tmp_path / "ckpt2").iterdir()) == [
        "window_000000.npz"]
    seen = []
    res = tckpt.process_video_checkpointed(
        flows, intr, GAMMA, cfg, gen, ckpt_dir=ckpt, window=2,
        on_window=lambda wi, r: seen.append(wi))
    assert seen == [0, 1]
    _equal(res, _windows(flows, intr, cfg, gen, 2))


def test_video_checkpoint_motions_only(castle, tmp_path, monkeypatch):
    """save_depth=False: checkpoints a fifth of the size or less; a resume
    estimates nothing and recomputes the depth maps, equal to the full
    run's; recompute_depth_maps equals the estimation's export."""
    intr = castle[0]
    flows = _flows(castle, 4)
    cfg = dataclasses.replace(PipelineConfig(**CFG), depth_residual_px=2.0)
    gen = torch.Generator().manual_seed(3)
    full, lean = tmp_path / "full", tmp_path / "lean"
    res_full = tckpt.process_video_checkpointed(
        flows, intr, GAMMA, cfg, gen, ckpt_dir=str(full), window=2)
    res_lean = tckpt.process_video_checkpointed(
        flows, intr, GAMMA, cfg, gen, ckpt_dir=str(lean), window=2,
        save_depth=False)
    _equal(res_lean, res_full)

    def du(p):
        return sum(f.stat().st_size for f in p.iterdir())

    assert du(lean) < 0.2 * du(full), (du(lean), du(full))
    estimations = []
    inner = tvideo.pipeline.estimate_from_flow
    monkeypatch.setattr(tvideo.pipeline, "estimate_from_flow",
                        lambda *a, **k: estimations.append(1) or inner(*a, **k))
    res3 = tckpt.process_video_checkpointed(
        flows, intr, GAMMA, cfg, gen, ckpt_dir=str(lean), window=2,
        save_depth=False)
    assert estimations == []
    _equal(res3, res_full)
    assert float(res3.depth_maps.abs().sum()) > 0
    _equal(res_full._replace(depth_maps=tckpt.recompute_depth_maps(
        flows, res_full, intr, GAMMA, cfg)), res_full)
