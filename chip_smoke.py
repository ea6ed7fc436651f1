#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (rs_sfm_tpu_torch) on one NVIDIA GPU.

Drives the solver slice -- flow field -> prepare -> 256-hypothesis RANSAC
scored on every pixel -> fused Schur-LM refinement -> sign flip and depth
export -> per-scanline poses -> packed24 rectification -- at full HD
(1920x1080, N = 2,073,600 pixels) in both slice configurations
(rs_sfm_tpu_torch.config.SLICE_CONFIGS), through the hand-written CUDA
kernels of rs_sfm_tpu_torch/csrc, and holds each kernel and the slice
against their plain PyTorch versions.

    python3 chip_smoke.py          # one CUDA device; a few minutes

Phases, each printing its lines before the next starts (any failure raises
and the script exits non-zero; nothing is caught and continued):
  [1 device]  the card's name, then nvidia-smi's "name, power.limit" line
  [2 build]   nvcc builds csrc/*.cu for sm_90a; seconds and ptxas usage
  [3 kernels] B1 score, B2 lm_iter, B3 lm_iter_multi vs their plain versions
              at full-HD shapes; median ms of 20 timed runs of each
  [4 slice]   both configurations at full HD: v, w, inliers, per-stage ms
              (CUDA events), peak memory, kernel launch counts
  [5 parity]  the slice at 270x480 on the card (kernels) vs on the CPU
              (plain versions), same RANSAC draws
The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 1080, 1920
GAMMA = 0.9
# bench.py's intrinsics for the full-HD flow field.
INTR_ARGS = dict(fx=1803.3, fy=1799.4, cx=945.3, cy=544.7)
REPEATS = 20


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, runs=REPEATS, warmup=3):
    """Median of `runs` timings of fn() with CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unit(v):
    import numpy as np

    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 device] {name}; {torch.cuda.device_count()} device(s); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name


def phase_build():
    from rs_sfm_tpu_torch.ops.kernels import _build

    seconds = _build.build_all()
    print(f"[2 build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{', '.join(_build.SOURCES)} built and loaded in {seconds:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    sys.stdout.flush()


def slice_inputs(dev, h=H, w=W, scale=1.0):
    import torch

    from rs_sfm_tpu_torch.data.make_flow import make_flow
    from rs_sfm_tpu_torch.geom.camera import Intrinsics

    intr = Intrinsics(**{k: v * scale for k, v in INTR_ARGS.items()})
    flow = torch.from_numpy(make_flow(h, w)).to(dev)
    return flow, intr


def phase_kernels(dev):
    """Returns {kernel: (max_abs_err, ms, plain_ms)}."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG as cfg
    from rs_sfm_tpu_torch.ops.kernels import refine_kernels as rk
    from rs_sfm_tpu_torch.ops.kernels import score as sk
    from rs_sfm_tpu_torch.solver import refine_fused as rf
    from rs_sfm_tpu_torch.solver.minimal import calculate_velocities
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import (_score_hypotheses,
                                                sample_valid_indices)

    flow, intr = slice_inputs(dev)
    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        flow, intr, GAMMA, cfg)
    n = coords.shape[0]
    tol = cfg.ransac_tol
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = sample_valid_indices(gen, valid, cfg.ransac_trials)
    f64 = torch.float64
    w_all, v_all, k_all = calculate_velocities(
        coords[idx].to(f64), flow_n[idx].to(f64), alpha[idx].to(f64),
        alpha_k[idx].to(f64), False)
    out = {}

    # B1: every pixel's error is the same IEEE arithmetic on both sides, so
    # counts are exactly equal; error sums differ by summation order.
    px = sk.pack_pixels(coords, flow_n, alpha, alpha_k, valid)
    hy = sk.pack_hyps(v_all, w_all, k_all)
    num_k, err_k = sk.score_hypotheses(px, hy, tol)
    num_p, err_p = sk.score_hypotheses_plain(px, hy, tol)
    torch.cuda.synchronize()
    check(torch.equal(num_k, num_p), "B1 inlier counts equal to plain")
    check(torch.allclose(err_k, err_p, rtol=1e-5, atol=0.0),
          "B1 error sums within rtol 1e-5 of plain")
    err = float(torch.max(torch.abs(err_k - err_p)))
    ms = time_ms(lambda: sk.score_hypotheses(px, hy, tol))
    plain_ms = time_ms(lambda: sk.score_hypotheses_plain(px, hy, tol))
    out["score_hypotheses"] = (err, ms, plain_ms)
    print(f"[3 kernels] B1 score_hypotheses N={n} T={hy.shape[0]}: counts "
          f"equal (best {int(num_k.max())}), error sums max abs diff {err:.3e}"
          f"; {ms:.3f} ms vs plain {plain_ms:.3f} ms", flush=True)

    # B2/B3 inputs: the four best hypotheses, their inlier masks and
    # closed-form depths; Huber knee of the production configuration.
    top = torch.argsort(num_k, descending=True, stable=True)[:4]
    _, _, rho_j, inl_j = _score_hypotheses(
        coords, flow_n, alpha, alpha_k, valid, v_all[top], w_all[top],
        k_all[top], tol)
    loss_delta = cfg.refine_loss_delta_px / math.sqrt(intr.fx * intr.fy)
    f32 = torch.float32
    zero = torch.zeros_like(alpha)
    for j in (1, 4):
        name = "lm_iter" if j == 1 else "lm_iter_multi"
        masks = inl_j[:j].to(f32).contiguous()
        pxl = torch.stack([coords[:, 0], coords[:, 1], flow_n[:, 0],
                           flow_n[:, 1], alpha, alpha_k,
                           masks[0] if j == 1 else zero, zero]).to(f32)
        rho = rho_j[:j].to(f32).contiguous()
        state = rf.initial_state(v_all[top[:j]], w_all[top[:j]],
                                 k_all[top[:j]], optimize_k=False,
                                 init_lambda=1e-6, rel_tol=0.0)

        def kernel(st, rp, rc):
            if j == 1:
                s, a, b = rk.lm_iter(st[0], pxl, rp, rc, loss_delta)
                return s[None], a, b
            return rk.lm_iter_multi(st, pxl, masks, rp, rc, loss_delta)

        def plain(st, rp, rc):
            if j == 1:
                s, a, b = rk.lm_iter_plain(st[0], pxl, rp, rc, loss_delta)
                return s[None], a, b
            return rk.lm_iter_multi_plain(st, pxl, masks, rp, rc, loss_delta)

        # One step from the same state: the bootstrap sweep, and (after two
        # plain steps of history) a full step.  Both compared steps solve at
        # unit damping: at the production damping the (v, rho) scale gauge
        # leaves the 7x7 system nearly singular, and the solved delta's
        # gauge component is float32 rounding in any two summation orders.
        st, rp, rc = state, rho, rho
        worst = 0
        for step in range(4):
            compared = step in (0, 3)
            if compared:
                st = st.clone()
                st[:, rk.S_LAM] = 3.0  # an accept divides it by 3
            ref = plain(st, rp, rc)
            if compared:
                got = kernel(st, rp, rc)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    bad = rk.state_mismatches(g.cpu().numpy(), r.cpu().numpy())
                    check(not bad, f"{name} one step vs plain: {bad[:5]}")
                worst = max(worst, int(np.argmax(np.abs(
                    got[0].cpu().numpy() - ref[0].cpu().numpy()))))
            st, rp, rc = ref

        # 21 sweeps (20 iterations): refine_pallas(_multi) vs a plain loop.
        st_p, rp, rc = state, rho, rho
        for _ in range(21):
            st_p, rp, rc = plain(st_p, rp, rc)
        if j == 1:
            res = rf.refine_pallas(coords, flow_n, alpha, alpha_k,
                                   masks[0] > 0.5, v_all[top[0]],
                                   w_all[top[0]], k_all[top[0]], rho[0],
                                   optimize_k=False, iterations=20,
                                   rel_tol=0.0, loss_delta=loss_delta)
            theta_k = torch.cat([res.v, res.w, res.k.reshape(1)])[None]
            cost_k = res.cost.reshape(1)
        else:
            res = rf.refine_pallas_multi(
                coords, flow_n, alpha, alpha_k, masks > 0.5, v_all[top],
                w_all[top], k_all[top], rho, optimize_k=False,
                iterations=20, rel_tol=0.0, loss_delta=loss_delta)
            theta_k = torch.cat([res.v, res.w, res.k[:, None]], dim=1)
            cost_k = res.cost
        theta_k = theta_k.cpu().numpy().astype(np.float64)
        theta_p = st_p[:, 0:7].cpu().numpy().astype(np.float64)
        for s in range(j):
            vk, vp = unit(theta_k[s, 0:3]), unit(theta_p[s, 0:3])
            check(np.allclose(vk, vp, rtol=1e-4, atol=1e-6),
                  f"{name} 21 sweeps: v direction {vk} vs plain {vp}")
        check(np.allclose(theta_k[:, 3:6], theta_p[:, 3:6], rtol=1e-4,
                          atol=0.0),
              f"{name} 21 sweeps: w {theta_k[:, 3:6]} vs {theta_p[:, 3:6]}")
        check(torch.allclose(cost_k, st_p[:, rk.S_COST], rtol=1e-4, atol=0.0),
              f"{name} 21 sweeps: cost {cost_k} vs {st_p[:, rk.S_COST]}")
        err = float(np.max(np.abs(theta_k - theta_p)))
        ms = time_ms(lambda: kernel(state, rho, rho))
        plain_ms = time_ms(lambda: plain(state, rho, rho))
        out[name] = (err, ms, plain_ms)
        print(f"[3 kernels] {'B2' if j == 1 else 'B3'} {name} J={j} N={n} "
              f"Huber delta={loss_delta:.4g}: one step matches plain (state "
              f"rtol 1e-5; largest diff at slot {worst}); 21 sweeps v, w, "
              f"cost within rtol 1e-4, theta max abs diff {err:.3e}; "
              f"{ms:.3f} ms/iteration vs plain {plain_ms:.3f} ms", flush=True)
    return out


def run_slice(flow, intr, cfg, image, generator=None, sample_indices=None):
    """One pass of the slice; returns (result, rectified, stage ms)."""
    import torch

    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject
    from rs_sfm_tpu_torch.solver.pipeline import estimate_from_flow

    on_card = flow.is_cuda
    marks = []

    def mark(name):
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    mark("start")
    res = estimate_from_flow(flow, intr, GAMMA, cfg, generator,
                             sample_indices=sample_indices, timer=mark)
    h = flow.shape[0]
    r, t = scanline_poses(res.v, res.w, res.k, h, GAMMA, dtype=flow.dtype)
    rect = backproject(image, res.depth_map, r, t, intr)
    mark("rectify")
    stages = {}
    if on_card:
        marks[-1][1].synchronize()
        stages = {name: marks[i][1].elapsed_time(ev)
                  for i, (name, ev) in enumerate(marks[1:])}
    return res, rect, stages


def check_slice(res, rect, n, what):
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.data.make_flow import TRUE_V, TRUE_W

    for field in ("v", "w", "k", "depth_map", "refine_cost"):
        check(bool(torch.isfinite(getattr(res, field)).all()),
              f"{what}: {field} finite")
    check(bool(torch.isfinite(rect.gs_image).all()), f"{what}: image finite")
    check(int(res.num_inliers) > 0.9 * n, f"{what}: inliers > 0.9 N")
    w = res.w.cpu().numpy()
    check(np.all(np.abs(w - np.asarray(TRUE_W)) < 1e-3),
          f"{what}: w {w} within 1e-3 of {TRUE_W}")
    cos = abs(float(unit(res.v.cpu().numpy()) @ unit(TRUE_V)))
    angle = math.acos(min(1.0, cos))
    check(angle < 0.1, f"{what}: v within 0.1 rad of +-{TRUE_V} ({angle:.4f})")
    return angle


def phase_slice(dev):
    """Returns {kernel: launches} over the timed runs of both configs."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import SLICE_CONFIGS
    from rs_sfm_tpu_torch.ops.kernels import refine_kernels as rk
    from rs_sfm_tpu_torch.ops.kernels import score as sk

    flow, intr = slice_inputs(dev)
    n = H * W
    image = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 0.9, (H, W, 3)).astype(np.float32)).to(dev)
    wrappers = {"score_hypotheses": sk.score_hypotheses,
                "lm_iter": rk.lm_iter, "lm_iter_multi": rk.lm_iter_multi}
    runs = 3
    launches = dict.fromkeys(wrappers, 0)
    for name, cfg in SLICE_CONFIGS.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        run_slice(flow, intr, cfg, image, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        stages, walls = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            res, rect, st = run_slice(flow, intr, cfg, image, gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            stages.append(st)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        sweeps = (cfg.refine_iterations + 1 if cfg.refine_starts == 1 else
                  cfg.refine_winnow_iters + 1
                  + cfg.refine_iterations - cfg.refine_winnow_iters + 1)
        expect = {"score_hypotheses": runs,
                  "lm_iter": runs * sweeps if cfg.refine_starts == 1 else 0,
                  "lm_iter_multi": runs * sweeps if cfg.refine_starts > 1
                  else 0}
        check(counts == expect, f"{name}: launches {counts} == {expect}")
        for k in launches:
            launches[k] += counts[k]
        angle = check_slice(res, rect, n, name)
        med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[4 slice] {name} {W}x{H}: v={res.v.cpu().numpy()} "
              f"({angle:.4f} rad from truth) w={res.w.cpu().numpy()} "
              f"inliers={int(res.num_inliers)}/{n} "
              f"cost={float(res.refine_cost):.6g}", flush=True)
        print(f"[4 slice] {name} ms (median of {runs}, CUDA events): "
              + " ".join(f"{k}={v:.2f}" for k, v in med.items())
              + f" total={sum(med.values()):.2f}; host wall "
              f"{statistics.median(walls):.2f}; peak {peak:.2f} GiB; "
              f"launches {counts}", flush=True)
    return launches


def phase_parity(dev):
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import SLICE_CONFIGS
    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    h, w = 270, 480
    n = h * w
    flow_c, intr = slice_inputs("cpu", h, w, scale=0.25)
    image_c = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 0.9, (h, w, 3)).astype(np.float32))
    for name, cfg in SLICE_CONFIGS.items():
        valid = prepare_flow_inputs(flow_c, intr, GAMMA, cfg)[4]
        idx = sample_valid_indices(torch.Generator().manual_seed(2), valid,
                                   cfg.ransac_trials)
        rg = run_slice(flow_c.to(dev), intr, cfg, image_c.to(dev),
                       sample_indices=idx)[0]
        rc = run_slice(flow_c, intr, cfg, image_c, sample_indices=idx)[0]
        vg, vc = unit(rg.v.cpu().numpy()), unit(rc.v.numpy())
        check(np.allclose(vg * np.sign(vg @ vc), vc, rtol=0, atol=2e-4),
              f"{name} 270x480: v {vg} vs CPU {vc}")
        check(np.allclose(rg.w.cpu().numpy(), rc.w.numpy(), rtol=0,
                          atol=1e-5),
              f"{name} 270x480: w {rg.w.cpu().numpy()} vs CPU {rc.w.numpy()}")
        dn = abs(int(rg.num_inliers) - int(rc.num_inliers))
        check(dn <= 1e-3 * n, f"{name} 270x480: inliers differ by {dn}")
        # Rectification on both devices from the same depth map and poses.
        r, t = scanline_poses(rc.v, rc.w, rc.k, h, GAMMA, dtype=torch.float32)
        bc = backproject(image_c, rc.depth_map, r, t, intr)
        bg = backproject(image_c.to(dev), rc.depth_map.to(dev), r.to(dev),
                         t.to(dev), intr)
        check(torch.equal(bg.scattered.cpu(), bc.scattered),
              f"{name} 270x480: packed24 hit mask bit-exact")
        check(torch.equal(bg.gs_image.cpu(), bc.gs_image),
              f"{name} 270x480: packed24 image bit-exact")
        print(f"[5 parity] {name} {w}x{h} card vs CPU: v diff "
              f"{np.max(np.abs(vg * np.sign(vg @ vc) - vc)):.2e}, w diff "
              f"{np.max(np.abs(rg.w.cpu().numpy() - rc.w.numpy())):.2e}, "
              f"inliers {int(rg.num_inliers)} vs {int(rc.num_inliers)}; "
              f"packed24 image and hit mask bit-exact "
              f"({int(bc.scattered.sum())} hits)", flush=True)


def main():
    if not (ROOT / "rs_sfm_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: rs_sfm_tpu_torch/ not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch

    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    timing = phase_kernels(dev)
    launches = phase_slice(dev)
    phase_parity(dev)
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "rs_sfm_tpu")
                  for m in sys.modules), "no JAX module was imported")

    from rs_sfm_tpu_torch.ops.kernels import _build

    sources = {"score_hypotheses": ("score", "score.py:85"),
               "lm_iter": ("lm_iter", "refine_kernels.py:503"),
               "lm_iter_multi": ("lm_iter", "refine_kernels.py:451")}
    kernels = []
    for kname, (src, replaces) in sources.items():
        err, ms, plain_ms = timing[kname]
        check(launches[kname] > 0, f"{kname} launched on the main path")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": str(_build.source_path(src).relative_to(ROOT)),
            "replaces": "rs_sfm_tpu/ops/pallas/" + replaces,
            "launches": launches[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
