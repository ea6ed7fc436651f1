#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (rs_sfm_tpu_torch) on one NVIDIA GPU.

Drives the port's main path -- dense flow (forward + half-resolution
backward + occlusion test) -> estimation with two model-feedback passes ->
per-scanline poses -> packed24 rectification -- at full HD (1920x1080) on
bench.py's input, the solver slice (flow field -> RANSAC -> fused
Schur-LM -> rectification) in both slice configurations, the estimation
sharded over two ranks, and every rectification engine, through the
hand-written CUDA kernels of rs_sfm_tpu_torch/csrc; holds each kernel and
each path against their plain PyTorch versions.

    python3 chip_smoke.py          # one CUDA device; a few minutes

Phases, each printing its lines before the next starts (any failure raises
and the script exits non-zero; nothing is caught and continued):
  [1 device]  the card's name, then nvidia-smi's "name, power.limit" line
  [2 build]   nvcc builds csrc/*.cu for sm_90a, all at once; seconds,
              ptxas usage, and B1's SASS instructions per pixel and
              hypothesis (cuobjdump -sass, ops/kernels/_sass.py)
  [3 kernels] B1 score, B2 lm_iter, B3 lm_iter_multi (J = 4 and 1), B7
              lm_sums_multi + lm_decide, B4 warp and match_search, B5
              sor_sweeps, B6 median3_planes (and median3_flow from both
              flow layouts) vs their plain versions at full-HD shapes (B7
              also against B3, bit for bit); median ms of 20 timed runs of
              each, of its plain version and (B4's warp) of F.grid_sample,
              and its bound; B1's squared threshold s* and the pairs within
              1 ulp of it; B4's search at each of the e2e pass's discrete
              searches, on every tile of csrc/match.cu ("*" marks
              match.tile_plan's choice), and B5's tile plans at every
              pyramid level ("*" marks sor.tile_plan's choice; launches in
              parentheses)
  [4 slice]   both solver-slice configurations at full HD: v, w, inliers,
              per-stage ms (CUDA events), peak memory, launch counts; the
              hypotheses RANSAC picks on seed-1 draws made on the card
  [5 parity]  the solver slice and the e2e path at 270x480 on the card
              (kernels) vs on the CPU (plain versions), same RANSAC draws
              (handed to the card's runs on the card); the hypotheses
              RANSAC picks on the card
  [6 e2e]     the main path at full HD: 1 warm-up and 3 timed passes,
              per-stage ms, host wall time, peak memory, launch counts of
              all seven kernels asserted against the configuration's (B5 at
              most 330 a pass); then one pass under torch.profiler (device
              kernels, busy share, device ms of each kernel)
  [7 sharded] the estimation at full HD sharded over 2 ranks that share the
              one card over gloo (NCCL refuses two ranks on one device):
              both ranks' scalars bit-identical, and within gates of the
              unsharded pass on the same hypotheses; B7 launches per rank
  [8 rectify] B8 zbuffer_splat vs its plain version on the e2e pass's depth
              map and poses (bit-exact), its min stage against one
              scatter_reduce_ "amin" of its packed keys, then the five
              engines, fill_cracks and small_motion_warp at full HD;
              "pallas" equals "scatter"
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
# Sharded (2 ranks) vs unsharded estimation on the same hypotheses (phase
# 7): the sums are added in another order, so the gates of float32
# summation order the CPU tests use (tests/test_torch_parallel.py).
SHARDED_GATES = {"v_direction": 2e-4, "w": 1e-5, "inlier_share": 1e-3}
# Card-vs-CPU gates of the 270x480 e2e parity (phase 5).  Measured on an
# NVIDIA H100: the flow and the occlusion mask bit-exact (every kernel and
# every plain op rounds as IEEE float32 does), v 9e-7 and w 7e-9 apart
# (summation order in RANSAC and the LM); the gates leave about 100x.
E2E_GATES = {"flow_median_px": 1e-4, "flow_p99_px": 1e-3,
             "occlusion_share": 1e-4, "v_direction": 1e-4, "w": 1e-6}

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Float32 operations per unit of work, counted from each kernel's source:
# per valid pixel and hypothesis (score.cu: 45, with the pixel invariants
# hoisted, the inlier's root and sum included) and per valid pixel (its 8
# hoisted operations), per pixel and start (lm_iter.cu, its header's
# count), per output pixel (warp.cu), per pixel and sweep (sor.cu), per
# pixel and plane (median.cu: 19 comparators, min and max), per
# (candidate, pixel) of a discrete search (match.cu, one per float add,
# multiply, min, max, floor, compare or select: the refine's candidate and
# bilinear sample 23, the coarse's read none; the difference and square 2;
# the box's 8 adds; the scan 17, and the refine's candidate add 1; the
# halo's recomputed cells not counted).
OPS_SCORE = 45
OPS_SCORE_PIXEL = 8
OPS_LM = 250
OPS_WARP = 21
OPS_SOR = 92
OPS_MEDIAN = 38
OPS_MATCH_REFINE = 51
OPS_MATCH_COARSE = 27
# Per source pixel (zbuffer.cu): two adds and floors, four bound compares,
# the target index and one 64-bit atomic min.
OPS_ZBUFFER = 10

KERNELS = {  # name: (csrc source, TPU kernel it replaces)
    "score_hypotheses": ("score", "score.py:85"),
    "lm_iter": ("lm_iter", "refine_kernels.py:503"),
    "lm_iter_multi": ("lm_iter", "refine_kernels.py:451"),
    "warp": ("warp", "warp.py:96"),
    "match_search": ("match", "warp.py:96"),
    "sor_sweeps": ("sor", "sor.py:158"),
    "median3_planes": ("median", "median.py:72"),
    "lm_sums_multi": ("lm_iter", "refine_kernels.py:592"),
    "zbuffer_splat": ("zbuffer", "zbuffer.py:142"),
}
# SOR launches of one e2e pass: 66 calls of 20 sweeps, at most
# ceil(20 / 4) launches each (csrc/sor.cu fuses 4 or more sweeps a launch).
SOR_LAUNCHES_PER_PASS = 330
# Wrappers whose kernels the e2e main path does not run (B7's decide half
# counts beside its sums half).
OFF_MAIN_PATH = {"lm_sums_multi": 0, "lm_decide": 0, "zbuffer_splat": 0}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, runs=REPEATS, warmup=3):
    """Median device time of fn() over `runs` calls, with CUDA events.

    The calls are queued behind a spin kernel that outlasts their host-side
    launch time, so each call's pair of events brackets its device work
    alone: without the backlog a short kernel's window would also hold the
    wrapper's host time (a 10 us kernel measured 49-63 us).
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    # Cycles at up to 2 GHz, twice the host time the calls need.
    torch.cuda._sleep(int(2 * runs * host_s * 2e9) + 10**6)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def wall_ms(fn, runs=10, warmup=2):
    """Median host wall time of fn() followed by a synchronize: for calls
    that copy from the host (a tensor made from a Python number), which a
    backlog behind time_ms's spin kernel would stall."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def unit(v):
    import numpy as np

    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def bound(nbytes, ops):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lm_bytes(n, j):
    """Bytes one LM iteration over n pixels and j starts must move: the
    6-row pixel record (x, y, ux, uy, alpha, alpha_k) once for all starts;
    per start its mask (B2: row 6 of the record), the one depth row its
    accept flag selects (rho_cand or rho_prev), (rho_eff, rho_new) written,
    and its 128-float state read and written."""
    return 4 * (6 * n + j * (4 * n + 2 * 128))


def record(err, ms, plain_ms, nbytes, ops, library_ms=None):
    bound_ms, bound_by = bound(nbytes, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def wrappers():
    """{kernel name: its wrapper, whose `launches` counts its launches}."""
    from rs_sfm_tpu_torch.ops.kernels import match as kma
    from rs_sfm_tpu_torch.ops.kernels import median as km
    from rs_sfm_tpu_torch.ops.kernels import refine_kernels as rk
    from rs_sfm_tpu_torch.ops.kernels import score as sk
    from rs_sfm_tpu_torch.ops.kernels import sor as ks
    from rs_sfm_tpu_torch.ops.kernels import warp as kw
    from rs_sfm_tpu_torch.ops.kernels import zbuffer as kz

    return {"score_hypotheses": sk.score_hypotheses, "lm_iter": rk.lm_iter,
            "lm_iter_multi": rk.lm_iter_multi, "warp": kw.warp,
            "match_search": kma.match_search, "sor_sweeps": ks.sor_sweeps,
            "median3_planes": km.median3_planes,
            "lm_sums_multi": rk.lm_sums_multi, "lm_decide": rk.lm_decide,
            "zbuffer_splat": kz.zbuffer_splat}


def reset_counts():
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    return wrap


def _dense_launches(cfg, h, w, limits):
    """(warp, search, SOR, median) kernel launches of one dense_flow_aux
    call on a card of `limits` (sor.card_limits)."""
    from rs_sfm_tpu_torch.flow.dense import pyramid_levels
    from rs_sfm_tpu_torch.ops.kernels.sor import launches_per_call

    shapes = [(h, w)]
    for _ in range(pyramid_levels(h, w, cfg.levels) - 1):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    warp = search = sor = med = 0
    if cfg.init_search_radius > 0:
        # The coarse search, then its median clean-up.
        search += 1
        med += 1
    for lvl, (hh, ww) in enumerate(shapes):
        if lvl != 0:
            radius = (cfg.refine_search_radius
                      if (cfg.refine_search_radius > 0
                          and min(hh, ww) <= cfg.refine_max_size)
                      else cfg.refine_fine_radius)
            if radius > 0:
                # The warp-local search, then its median clean-up.
                search += 1
                med += 1
        finest = lvl == 0
        warps = (cfg.warps if finest or cfg.warps_coarse <= 0
                 else cfg.warps_coarse)
        iters = (cfg.iters if finest or cfg.iters_coarse <= 0
                 else cfg.iters_coarse)
        warp += warps
        sor += warps * launches_per_call(hh, ww, iters, limits)
        med += warps if cfg.median else 0
    return warp, search, sor, med


def flow_launches(cfg, h, w, limits=None):
    """Kernel launches of flow_forward_backward at (h, w) on CUDA tensors
    of a card of `limits` (sor.card_limits; by default an H100's), derived
    from the configuration."""
    from rs_sfm_tpu_torch.ops.kernels.sor import H100_LIMITS

    limits = limits or H100_LIMITS
    bh, bw = h, w
    for _ in range(cfg.backward_scale.bit_length() - 1):
        bh, bw = (bh + 1) // 2, (bw + 1) // 2
    fw = _dense_launches(cfg, h, w, limits)
    bwd = (_dense_launches(cfg, bh, bw, limits) if cfg.backward_scale > 1
           else fw)
    return {"warp": fw[0] + bwd[0] + 1 + (cfg.occ_photo > 0.0),
            "match_search": fw[1] + bwd[1], "sor_sweeps": fw[2] + bwd[2],
            "median3_planes": fw[3] + bwd[3]}


def estimation_launches(cfg):
    """B1-B3 launches of one estimate_with_feedback call."""
    multi = single = 0
    if cfg.refine_starts > 1:
        winnow = (cfg.refine_winnow_iters
                  if 0 < cfg.refine_winnow_iters < cfg.refine_iterations
                  else 0)
        multi = (winnow + 1 + cfg.refine_iterations - winnow + 1 if winnow
                 else cfg.refine_iterations + 1)
    else:
        single = cfg.refine_iterations + 1
    fb_iters = cfg.feedback_refine_iterations or cfg.refine_iterations
    single += cfg.feedback_passes * (fb_iters + 1)
    return {"score_hypotheses": int(cfg.ransac_engine == "pallas"),
            "lm_iter": single, "lm_iter_multi": multi}


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
    # B1's SASS per pixel and hypothesis: one MUFU.RCP (the IEEE division)
    # a pair, so a loop's instructions per MUFU.RCP.
    from rs_sfm_tpu_torch.ops.kernels import _sass

    for line in _sass.report(str(_build.library_path("score")),
                             "score_kernel", "MUFU.RCP"):
        print(f"  score SASS: {line}")
    sys.stdout.flush()


def slice_inputs(dev, h=H, w=W, scale=1.0):
    import torch

    from rs_sfm_tpu_torch.data.make_flow import make_flow
    from rs_sfm_tpu_torch.geom.camera import Intrinsics

    intr = Intrinsics(**{k: v * scale for k, v in INTR_ARGS.items()})
    flow = torch.from_numpy(make_flow(h, w)).to(dev)
    return flow, intr


def phase_kernels(dev):
    """B1-B3 on the solver slice's inputs; returns {kernel: record}."""
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

    # B1: every pixel's squared residual is the same IEEE arithmetic on
    # both sides, and the kernel's test s < s* is the plain sqrt(s) < tol,
    # so counts are exactly equal; error sums differ by summation order
    # and the kernel's approximate root.
    px = sk.pack_pixels(coords, flow_n, alpha, alpha_k, valid)
    hy = sk.pack_hyps(v_all, w_all, k_all)
    num_k, err_k = sk.score_hypotheses(px, hy, tol)
    num_p, err_p = sk.score_hypotheses_plain(px, hy, tol)
    torch.cuda.synchronize()
    check(torch.equal(num_k, num_p), "B1 inlier counts equal to plain")
    check(torch.allclose(err_k, err_p, rtol=1e-5, atol=0.0),
          "B1 error sums within rtol 1e-5 of plain")
    err = float(torch.max(torch.abs(err_k - err_p)))
    # The pairs whose squared residual lies within 1 ulp of s*.
    sstar = sk.sq_threshold(tol)
    sbits = int(np.float32(sstar).view(np.uint32))
    ok = px[6] > 0.5
    near = 0
    for sq in sk.squared_residuals_plain(px, hy):
        d = torch.abs(sq.view(torch.int32).to(torch.int64) - sbits)
        near += int(((d <= 1) & ok).sum())
    n_valid = int(ok.sum())
    ms = time_ms(lambda: sk.score_hypotheses(px, hy, tol))
    plain_ms = time_ms(lambda: sk.score_hypotheses_plain(px, hy, tol))
    t = hy.shape[0]
    out["score_hypotheses"] = record(
        err, ms, plain_ms, 4 * (px.numel() + hy.numel() + 2 * t),
        OPS_SCORE * n_valid * t + OPS_SCORE_PIXEL * n_valid)
    print(f"[3 kernels] B1 score_hypotheses N={n} ({n_valid} valid) T={t}: "
          f"counts equal (best {int(num_k.max())}), error sums max abs diff "
          f"{err:.3e}; s* = {sstar!r} for tol {tol} ({near} pairs within 1 "
          f"ulp of it); {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
          f"{out['score_hypotheses']['bound_ms']:.4f} ms", flush=True)

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
        out[name] = record(err, ms, plain_ms, lm_bytes(n, j), OPS_LM * n * j)
        print(f"[3 kernels] {'B2' if j == 1 else 'B3'} {name} J={j} N={n} "
              f"Huber delta={loss_delta:.4g}: one step matches plain (state "
              f"rtol 1e-5; largest diff at slot {worst}); 21 sweeps v, w, "
              f"cost within rtol 1e-4, theta max abs diff {err:.3e}; "
              f"{ms:.3f} ms/iteration vs plain {plain_ms:.3f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms", flush=True)
        b7 = check_split_lm(st, pxl, masks, rp, rc, loss_delta, coords,
                            flow_n, alpha, alpha_k, v_all[top[:j]],
                            w_all[top[:j]], k_all[top[:j]], rho)
        if j == 4:  # the production winnow's J
            out["lm_sums_multi"] = b7

    # B3 at J = 1, as the production finish runs it on the winner: one step
    # against its plain version (unit damping), and its time.
    masks = inl_j[:1].to(f32).contiguous()
    rho = rho_j[:1].to(f32).contiguous()
    st = rf.initial_state(v_all[top[:1]], w_all[top[:1]], k_all[top[:1]],
                          optimize_k=False, init_lambda=1e-6, rel_tol=0.0)
    st[:, rk.S_LAM] = 3.0
    got = rk.lm_iter_multi(st, pxl, masks, rho, rho, loss_delta)
    ref = rk.lm_iter_multi_plain(st, pxl, masks, rho, rho, loss_delta)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        bad = rk.state_mismatches(g.cpu().numpy(), r.cpu().numpy())
        check(not bad, f"lm_iter_multi J=1 one step vs plain: {bad[:5]}")
    rec = out["lm_iter_multi"]
    rec["ms_j1"] = time_ms(lambda: rk.lm_iter_multi(st, pxl, masks, rho, rho,
                                                    loss_delta))
    rec["bound_ms_j1"] = bound(lm_bytes(n, 1), OPS_LM * n)[0]
    print(f"[3 kernels] B3 lm_iter_multi J=1 N={n}: one step matches plain; "
          f"{rec['ms_j1']:.3f} ms/iteration, bound "
          f"{rec['bound_ms_j1']:.4f} ms", flush=True)
    return out


def check_split_lm(state, pxl, masks, rho_prev, rho_cand, loss_delta,
                   coords, flow_n, alpha, alpha_k, v0, w0, k0, rho0):
    """B7 at one J: the sums and decide kernels against their plain versions
    on a state with history (unit damping, as B2/B3's one-step check), the
    pair against B3's fused launch bit for bit, and a 20-iteration sharded
    refinement with no group against refine_pallas_multi bit for bit.
    Returns B7's record (ms of one sums -> decide iteration)."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import refine_kernels as rk
    from rs_sfm_tpu_torch.solver import refine_fused as rf

    j, n = rho_prev.shape
    st = state.clone()
    st[:, rk.S_LAM] = 3.0
    re_k, rn_k, sums_k = rk.lm_sums_multi(st, pxl, masks, rho_prev, rho_cand,
                                          loss_delta)
    new_k = rk.lm_decide(st, sums_k)
    re_p, rn_p, sums_p = rk.lm_sums_multi_plain(st, pxl, masks, rho_prev,
                                                rho_cand, loss_delta)
    new_p = rk.lm_decide_plain(st, sums_k)
    fused = rk.lm_iter_multi(st, pxl, masks, rho_prev, rho_cand, loss_delta)
    torch.cuda.synchronize()
    bad = rk.sums_mismatches(sums_k.cpu().numpy(), sums_p.cpu().numpy())
    check(not bad, f"B7 J={j} sums vs plain: {bad[:5]}")
    for what, g, r in (("rho_eff", re_k, re_p), ("rho_new", rn_k, rn_p),
                       ("decide", new_k, new_p)):
        bad = rk.state_mismatches(g.cpu().numpy(), r.cpu().numpy())
        check(not bad, f"B7 J={j} {what} vs plain: {bad[:5]}")
    check(all(torch.equal(a, b) for a, b in zip((new_k, re_k, rn_k), fused)),
          f"B7 J={j}: sums -> decide bit-identical to B3")
    kw = dict(optimize_k=False, iterations=20, rel_tol=0.0,
              loss_delta=loss_delta)
    args = (coords, flow_n, alpha, alpha_k, masks > 0.5, v0, w0, k0, rho0)
    split = rf.refine_pallas_multi_sharded(*args, group=None, **kw)
    whole = rf.refine_pallas_multi(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(split, whole)),
          f"B7 J={j}: 20-iteration world-1 refinement bit-identical to B3")
    err = float(torch.max(torch.abs(new_k - rk.lm_decide_plain(st, sums_p))
                          [:, 0:14]))

    def kernel():
        return rk.lm_decide(st, rk.lm_sums_multi(
            st, pxl, masks, rho_prev, rho_cand, loss_delta)[2])

    def plain():
        return rk.lm_decide_plain(st, rk.lm_sums_multi_plain(
            st, pxl, masks, rho_prev, rho_cand, loss_delta)[2])

    ms, plain_ms = time_ms(kernel), time_ms(plain)
    # The fused iteration's bytes and the (J, 71) sums between the halves.
    rec = record(err, ms, plain_ms, lm_bytes(n, j) + 4 * j * rk.N_SUMS,
                 OPS_LM * n * j)
    print(f"[3 kernels] B7 lm_sums_multi + lm_decide J={j} N={n}: sums, rho "
          f"and decide match plain (B3's tolerances), sums -> decide and a "
          f"20-iteration world-1 refinement bit-identical to B3; theta max "
          f"abs diff to the plain chain {err:.3e}; {ms:.3f} ms/iteration vs "
          f"plain {plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms",
          flush=True)
    return rec


def e2e_inputs(dev, h=H, w=W):
    """bench.py's e2e input (bench.py:112-115,198-201): the seed-0 uniform
    image, i1 = its channel 0, i2 = i1 warped by make_flow (exact warp)."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.data.make_flow import make_flow
    from rs_sfm_tpu_torch.ops.kernels.warp import warp_plain

    image = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 0.9, (h, w, 3)).astype(np.float32))
    flow = torch.from_numpy(make_flow(h, w))
    i1 = image[..., 0].contiguous()
    i2 = warp_plain(i1, flow)
    return [t.to(dev) for t in (image, i1, i2, flow)]


def sor_inputs(i1, i2):
    """B5's input at full HD: the finest level's coefficient planes,
    linearised around the forward flow the e2e preset finds for the pair
    (that call's launches are not counted: the counts are reset before
    phase 6), that flow as (u, v), and the preset's SOR parameters."""
    from rs_sfm_tpu_torch.config import E2E_FLOW_PRESET as fc
    from rs_sfm_tpu_torch.flow.dense import dense_flow, linearize
    from rs_sfm_tpu_torch.ops.kernels.warp import warp_plain

    f0 = dense_flow(i1, i2, fc)
    coef = linearize(i1, warp_plain(i2, f0), f0).contiguous()
    prm = dict(iters=fc.iters, omega=fc.omega, lam=fc.smoothness,
               eps2=fc.eps * fc.eps, wbr=fc.brightness_weight,
               wgrad=fc.gamma_grad)
    return coef, f0[..., 0].contiguous(), f0[..., 1].contiguous(), prm


def check_sor_plans(coef, u0, v0, prm):
    """B5's tile plans at each level of the e2e pyramid, on the full-HD
    planes subsampled to the level's shape: the plan tile_plan picks, the
    other tile, and the whole plane in one block where it fits, each
    bit-exact to plain, with its ms for the preset's sweeps."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import sor as ks

    limits = ks.card_limits(u0.device)
    k = ks.SWEEPS_PER_LAUNCH
    for step in (1, 2, 4, 8, 16, 32, 64):
        c = coef[:, ::step, ::step].contiguous()
        u, v = u0[::step, ::step].contiguous(), v0[::step, ::step].contiguous()
        h, w = u.shape
        up, vp = ks.sor_sweeps_plain(c, u, v, **prm)
        chosen = ks.tile_plan(h, w, prm["iters"], limits)
        plans = {chosen} | {(*t, 2 * k, k) for t in (ks.TILE, ks.TILE_SMALL)}
        if ks.smem_bytes(h, w, h, w, 0) <= limits[1]:
            plans.add((h, w, 0, prm["iters"]))
        timings = []
        for plan in sorted(plans):
            uk, vk = torch.empty_like(u), torch.empty_like(v)
            launches = ks.sor_launch(c, u, v, uk, vk, plan, **prm)
            torch.cuda.synchronize()
            check(torch.equal(uk, up) and torch.equal(vk, vp),
                  f"B5 {h}x{w} plan {plan} bit-exact to plain")
            ms = time_ms(lambda: ks.sor_launch(c, u, v, uk, vk, plan, **prm))
            timings.append(f"{plan[0]}x{plan[1]} K={plan[3]}"
                           + ("*" if plan == chosen else "")
                           + f" {ms:.4f} ms ({launches})")
        print(f"[3 kernels] B5 plans {h}x{w}, bit-exact to plain: "
              + ", ".join(timings), flush=True)


def e2e_searches(i1, i2):
    """The arguments of every match_search call of one e2e flow pass on
    (i1, i2), in call order (the pass's launches are not counted: the
    counts are reset before phase 6)."""
    from rs_sfm_tpu_torch.config import E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.ops.kernels import match as km

    calls = []
    search = km.match_search

    def recorded(*args):
        calls.append(args)
        return search(*args)

    # The wrapper counts on the module's match_search, this one meanwhile.
    recorded.launches = 0
    km.match_search = recorded
    try:
        flow_forward_backward(i1, i2, E2E_FLOW_PRESET)
    finally:
        km.match_search = search
    return calls


def same_bits(a, b):
    """Bit-identical tensors (signed zeros and NaN payloads included)."""
    import torch

    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_searches(i1, i2):
    """B4's search kernel at each discrete search of the e2e pass: every
    tile of csrc/match.cu bit-exact to the plain version, each timed;
    returns match_search's record, summed over the pass's searches (ms,
    plain ms and bound of the 9 calls)."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import match as km
    from rs_sfm_tpu_torch.ops.kernels.sor import card_limits

    limits = card_limits(i1.device)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    shapes, worst, by = [], 0.0, set()
    for i1m, i2m, flow, radius, ratio, fb in e2e_searches(i1, i2):
        args = (i1m, i2m, flow, radius, ratio, fb)
        h, w = i1m.shape
        mode = "coarse" if flow is None else "refine"
        got = km.match_search(*args)
        ref = km.match_search_plain(*args)
        torch.cuda.synchronize()
        check(all(same_bits(g, r) for g, r in zip(got, ref)),
              f"match_search {h}x{w} {mode} bit-exact to plain")
        worst = max(worst, float(torch.max(torch.abs(got[0] - ref[0]))))
        chosen = km.tile_plan(h, w, radius, limits)
        plans = []
        for tile in range(len(km.TILES)):
            if km.smem_bytes(tile, radius) > limits[1]:
                continue
            res = km.match_launch(*args, tile)
            torch.cuda.synchronize()
            check(all(same_bits(g, r) for g, r in zip(res, ref)),
                  f"match_search {h}x{w} {mode} tile {tile} bit-exact")
            plans.append((tile, time_ms(
                lambda tile=tile: km.match_launch(*args, tile))))
        ms = time_ms(lambda: km.match_search(*args))
        plain_ms = time_ms(lambda: km.match_search_plain(*args), runs=5,
                           warmup=1)
        n, k = h * w, (2 * radius + 1) ** 2
        nbytes = n * (4 + 4 + (8 if flow is not None else 0)
                      + (8 if ratio > 0.0 and fb is not None else 0)
                      + 8 + 8 + 1)
        ops = (OPS_MATCH_REFINE if flow is not None
               else OPS_MATCH_COARSE) * k * n
        b_ms, b_by = bound(nbytes, ops)
        by.add(b_by)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        shapes.append({"shape": [h, w], "mode": mode, "candidates": k,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "tiles": {"%dx%d" % km.TILES[t]: t_ms
                                 for t, t_ms in plans}})
        print(f"[3 kernels] B4 match_search {h}x{w} {mode} K={k}: bit-exact "
              f"to plain on every tile; {ms:.4f} ms vs plain {plain_ms:.2f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}); tiles "
              + ", ".join("%dx%d" % km.TILES[t] + ("*" if t == chosen else "")
                          + f" {t_ms:.4f}" for t, t_ms in plans), flush=True)
    check(len(shapes) > 0, "the e2e pass ran discrete searches")
    rec = {"max_abs_err": worst, **total,
           "bound_by": "operations" if "operations" in by else "bytes",
           "library_ms": None, "searches": shapes}
    print(f"[3 kernels] B4 match_search, the pass's {len(shapes)} searches: "
          f"{total['ms']:.4f} ms vs plain {total['plain_ms']:.1f} ms, bound "
          f"{total['bound_ms']:.4f} ms", flush=True)
    return rec


def phase_flow_kernels(dev):
    """B4-B6 at full-HD shapes of the e2e path; returns {kernel: record}."""
    import torch
    import torch.nn.functional as F

    from rs_sfm_tpu_torch.ops.kernels import median as km
    from rs_sfm_tpu_torch.ops.kernels import sor as ks
    from rs_sfm_tpu_torch.ops.kernels import warp as kw

    _, i1, i2, flow = e2e_inputs(dev)
    n = H * W
    out = {}

    # B4: the 1080x1920 plane warped by make_flow; bit-exact.  Yardstick:
    # F.grid_sample with border padding and align_corners=True samples the
    # same clamped bilinear function (the port never calls it).
    got = kw.warp(i1, flow)
    ref = kw.warp_plain(i1, flow)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "B4 warp bit-exact to plain")
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([2.0 * (xs + flow[..., 0]) / (W - 1) - 1.0,
                        2.0 * (ys + flow[..., 1]) / (H - 1) - 1.0],
                       dim=-1)[None]

    def library():
        return F.grid_sample(i1[None, None], grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_err = float(torch.max(torch.abs(library()[0, 0] - ref)))
    out["warp"] = record(
        float(torch.max(torch.abs(got - ref))),
        time_ms(lambda: kw.warp(i1, flow)),
        time_ms(lambda: kw.warp_plain(i1, flow)), 4 * n + 8 * n + 4 * n,
        OPS_WARP * n, library_ms=time_ms(library))
    r = out["warp"]
    print(f"[3 kernels] B4 warp {H}x{W} by make_flow: bit-exact to plain; "
          f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms, grid_sample "
          f"{r['library_ms']:.4f} ms (max abs diff to it {lib_err:.2e}), "
          f"bound {r['bound_ms']:.4f} ms", flush=True)

    out["match_search"] = check_searches(i1, i2)

    # B6: both planes of make_flow; bit-exact.  As (2, H, W) planes, and as
    # the flow solver calls it: from SOR's separate u and v, and from an
    # (H, W, 2) flow, each into a contiguous (H, W, 2) flow.
    planes = flow.permute(2, 0, 1).contiguous()
    got = km.median3_planes(planes)
    ref = km.median3_plain(planes)
    u, v = planes[0].clone(), planes[1].clone()
    flows = {"u, v": (u, v), "(H, W, 2)": (flow[..., 0], flow[..., 1])}
    for a, b in flows.values():
        check(torch.equal(km.median3_flow(a, b), ref.permute(1, 2, 0)),
              "B6 median3_flow bit-exact to plain")
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "B6 median bit-exact to plain")
    out["median3_planes"] = record(
        float(torch.max(torch.abs(got - ref))),
        time_ms(lambda: km.median3_planes(planes)),
        time_ms(lambda: km.median3_plain(planes)), 2 * 4 * 2 * n,
        OPS_MEDIAN * 2 * n)
    r = out["median3_planes"]
    r["ms_flow"] = {k: time_ms(lambda a=a, b=b: km.median3_flow(a, b))
                    for k, (a, b) in flows.items()}
    print(f"[3 kernels] B6 median3_planes (2, {H}, {W}): bit-exact to plain;"
          f" {r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.4f} ms; median3_flow into ({H}, {W}, 2) from "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in r["ms_flow"].items()),
          flush=True)

    # B5: 20 sweeps on the finest level's coefficient planes; bit-exact.
    coef, u0, v0, prm = sor_inputs(i1, i2)
    uk, vk = ks.sor_sweeps(coef, u0, v0, **prm)
    up, vp = ks.sor_sweeps_plain(coef, u0, v0, **prm)
    torch.cuda.synchronize()
    check(torch.equal(uk, up) and torch.equal(vk, vp),
          "B5 SOR bit-exact to plain")
    moved = float(torch.max(torch.abs(uk - u0)))
    check(moved > 0.0, "B5 SOR moved the flow")
    out["sor_sweeps"] = record(
        max(float(torch.max(torch.abs(uk - up))),
            float(torch.max(torch.abs(vk - vp)))),
        time_ms(lambda: ks.sor_sweeps(coef, u0, v0, **prm)),
        time_ms(lambda: ks.sor_sweeps_plain(coef, u0, v0, **prm)),
        4 * (8 + 2 + 2) * n, OPS_SOR * n * prm["iters"])
    r = out["sor_sweeps"]
    print(f"[3 kernels] B5 sor_sweeps {H}x{W}, {prm['iters']} sweeps: "
          f"bit-exact to plain (max |du| {moved:.3e} px); {r['ms']:.3f} ms "
          f"vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms",
          flush=True)
    check_sor_plans(coef, u0, v0, prm)
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
    """Returns {config: {kernel: launches}} over its timed runs."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import SLICE_CONFIGS

    flow, intr = slice_inputs(dev)
    n = H * W
    image = torch.from_numpy(np.random.default_rng(0).uniform(
        0.1, 0.9, (H, W, 3)).astype(np.float32)).to(dev)
    wrap = wrappers()
    runs = 3
    launches = {}
    for name, cfg in SLICE_CONFIGS.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        run_slice(flow, intr, cfg, image, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrap.values():
            fn.launches = 0
        stages, walls = [], []
        for _ in range(runs):
            t0 = time.perf_counter()
            res, rect, st = run_slice(flow, intr, cfg, image, gen)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            stages.append(st)
        counts = {k: fn.launches for k, fn in wrap.items()}
        expect = {k: runs * c for k, c in estimation_launches(cfg).items()}
        expect.update(warp=0, match_search=0, sor_sweeps=0,
                      median3_planes=0, **OFF_MAIN_PATH)
        check(counts == expect, f"{name}: launches {counts} == {expect}")
        launches[name] = counts
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
    slice_picks(dev)
    return launches


def ransac_picks(flow, intr, cfg, draws, pixel_mask=None):
    """(best hypothesis, diversity top-J) that RANSAC picks on `flow` from
    the injected draws (a tensor on any device), as indices of the
    hypotheses: the result's v matched against every hypothesis' v (the
    same draws give the same hypotheses).  B1's error sums decide between
    hypotheses of equal count, so a change of their summation order can
    swap picks.  Uses only entry points that earlier trees of the port also
    have; their `ransac` takes draws on the host only (`host_draws` of the
    callers)."""
    import torch

    from rs_sfm_tpu_torch.solver.minimal import calculate_velocities
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import ransac

    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        flow, intr, GAMMA, cfg)
    if pixel_mask is not None:
        valid = valid & pixel_mask.reshape(-1)
    rr = ransac(coords, flow_n, alpha, alpha_k, valid, use_k=False,
                trials=cfg.ransac_trials, tolerance=cfg.ransac_tol,
                sample_indices=draws, engine=cfg.ransac_engine,
                top_j=cfg.refine_starts if cfg.use_refinement else 1,
                top_j_diversity=cfg.refine_start_diversity)
    idx = torch.as_tensor(draws, dtype=torch.int64).to(coords.device)
    f64 = torch.float64
    _, v_all, _ = calculate_velocities(
        coords[idx].to(f64), flow_n[idx].to(f64), alpha[idx].to(f64),
        alpha_k[idx].to(f64), False)

    def index(v):
        return int(torch.nonzero((v_all == v).all(dim=-1))[0])

    return index(rr.v), [index(v) for v in rr.top_v], int(rr.num_inliers)


def slice_picks(dev, host_draws=False):
    """Phase 4's picks: both slice configurations at full HD, seed-1 draws
    made on the card (moved to the host if `host_draws`)."""
    import torch

    from rs_sfm_tpu_torch.config import SLICE_CONFIGS
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    flow, intr = slice_inputs(dev)
    for name, cfg in SLICE_CONFIGS.items():
        valid = prepare_flow_inputs(flow, intr, GAMMA, cfg)[4]
        draws = sample_valid_indices(torch.Generator(device=dev).manual_seed(1),
                                     valid, cfg.ransac_trials)
        check(draws.is_cuda, "phase 4 draws made on the card")
        best, tops, num = ransac_picks(
            flow, intr, cfg, draws.cpu() if host_draws else draws)
        print(f"[4 slice] {name} {W}x{H} RANSAC picks (seed-1 draws): best "
              f"hypothesis {best} ({num} inliers), top-J {tops}", flush=True)


def parity_picks(dev, host_draws=False):
    """Phase 5's picks at 270x480 on the card: both slice configurations
    on the seed-2 draws, and the e2e estimation on the card's flow and
    occlusion mask with seed-3 draws; the draws are made on the host and
    handed over on the card (on the host if `host_draws`)."""
    import torch

    from rs_sfm_tpu_torch.config import (E2E_CONFIG, E2E_FLOW_PRESET,
                                         SLICE_CONFIGS)
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    h, w = 270, 480
    flow_c, intr = slice_inputs("cpu", h, w, scale=0.25)
    runs = []
    for name, cfg in SLICE_CONFIGS.items():
        valid = prepare_flow_inputs(flow_c, intr, GAMMA, cfg)[4]
        draws = sample_valid_indices(torch.Generator().manual_seed(2), valid,
                                     cfg.ransac_trials)
        runs.append((name, ransac_picks(flow_c.to(dev), intr, cfg,
                                        draws if host_draws
                                        else draws.to(dev))))
    _, i1, i2, _ = e2e_inputs(dev, h, w)
    fb = flow_forward_backward(i1, i2, E2E_FLOW_PRESET)
    keep = ~fb.occlusion
    valid = prepare_flow_inputs(fb.flow, intr, GAMMA, E2E_CONFIG)[4]
    draws = sample_valid_indices(torch.Generator().manual_seed(3),
                                 (valid & keep.reshape(-1)).cpu(),
                                 E2E_CONFIG.ransac_trials)
    runs.append(("e2e", ransac_picks(fb.flow, intr, E2E_CONFIG,
                                     draws if host_draws else draws.to(dev),
                                     pixel_mask=keep)))
    for name, (best, tops, num) in runs:
        print(f"[5 parity] {name} {w}x{h} RANSAC picks on the card: best "
              f"hypothesis {best} ({num} inliers), top-J {tops}", flush=True)


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
                       sample_indices=idx.to(dev))[0]
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

    # The e2e path: dense flow on the card (kernels) and on the CPU (plain
    # versions) from the same images, then both estimations with the same
    # RANSAC draws (taken on the CPU's trusted mask).
    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

    image_c, i1_c, i2_c, _ = e2e_inputs("cpu", h, w)
    fb_c = flow_forward_backward(i1_c, i2_c, E2E_FLOW_PRESET)
    fb_g = flow_forward_backward(i1_c.to(dev), i2_c.to(dev), E2E_FLOW_PRESET)
    d = torch.linalg.norm(fb_g.flow.cpu() - fb_c.flow, dim=-1).numpy()
    med, p99 = float(np.median(d)), float(np.percentile(d, 99))
    occ_diff = float((fb_g.occlusion.cpu() != fb_c.occlusion).float().mean())
    valid = prepare_flow_inputs(fb_c.flow, intr, GAMMA, E2E_CONFIG)[4]
    idx = sample_valid_indices(torch.Generator().manual_seed(3),
                               valid & ~fb_c.occlusion.reshape(-1),
                               E2E_CONFIG.ransac_trials)
    rc = estimate_with_feedback(fb_c.flow, intr, GAMMA, E2E_CONFIG,
                                sample_indices=idx,
                                pixel_mask=~fb_c.occlusion)
    rg = estimate_with_feedback(fb_g.flow, intr, GAMMA, E2E_CONFIG,
                                sample_indices=idx.to(dev),
                                pixel_mask=~fb_g.occlusion)
    vg, vc = unit(rg.v.cpu().numpy()), unit(rc.v.numpy())
    dv = float(np.max(np.abs(vg * np.sign(vg @ vc) - vc)))
    dw = float(np.max(np.abs(rg.w.cpu().numpy() - rc.w.numpy())))
    print(f"[5 parity] e2e {w}x{h} card vs CPU: flow |diff| median {med:.3e}"
          f" p99 {p99:.3e} max {float(d.max()):.3e} px; occlusion differs "
          f"on {occ_diff:.3e} of pixels ({float(fb_c.occlusion.float().mean()):.4f}"
          f" occluded); v diff {dv:.3e}, w diff {dw:.3e}; inliers "
          f"{int(rg.num_inliers)} vs {int(rc.num_inliers)}", flush=True)
    check(med <= E2E_GATES["flow_median_px"]
          and p99 <= E2E_GATES["flow_p99_px"],
          f"e2e {w}x{h}: flow median {med} / p99 {p99} within gates")
    check(occ_diff <= E2E_GATES["occlusion_share"],
          f"e2e {w}x{h}: occlusion masks differ on {occ_diff}")
    check(dv <= E2E_GATES["v_direction"] and dw <= E2E_GATES["w"],
          f"e2e {w}x{h}: v diff {dv}, w diff {dw} within gates")
    parity_picks(dev)


# Device kernels of the main path's kernels by name (csrc/*.cu), for their
# ms per e2e pass.
PASS_SYMBOLS = {"score_hypotheses": ("score_kernel",),
                "lm_iter": ("lm_iter_sweep", "lm_iter_reduce"),
                "lm_iter_multi": ("lm_iter_multi_sweep",
                                  "lm_iter_multi_reduce"),
                "warp": ("warp_kernel",),
                "match_search": ("match_kernel", "match_scan_kernel"),
                "sor_sweeps": ("sor_tile_kernel",),
                "median3_planes": ("median3_kernel",)}


def profile_pass(fn):
    """(device kernels, ms the device was busy, ms the pass took, the six
    operators called most often as (name, calls), {kernel name: device ms
    of its kernels}) of one fn() under torch.profiler."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = sorted(((a.key, a.count) for a in prof.key_averages()
                  if a.key.startswith("aten::")), key=lambda kc: -kc[1])
    by_kernel = {}
    for kname, symbols in PASS_SYMBOLS.items():
        pattern = re.compile(r"(?<!\w)(" + "|".join(symbols) + r")(?!\w)")
        by_kernel[kname] = sum(e.time_range.elapsed_us() for e in kernels
                               if pattern.search(e.name)) / 1e3
    return len(kernels), busy_ms, wall_ms, ops[:6], by_kernel


def run_e2e(i1, i2, image, intr, generator):
    """One pass of the main path; returns (flow result, estimation,
    rectified, stage ms)."""
    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    fb = flow_forward_backward(i1, i2, E2E_FLOW_PRESET, timer=mark)
    res = estimate_with_feedback(fb.flow, intr, GAMMA, E2E_CONFIG, generator,
                                 pixel_mask=~fb.occlusion, timer=mark)
    r, t = scanline_poses(res.v, res.w, res.k, i1.shape[0], GAMMA,
                          dtype=torch.float32)
    rect = backproject(image, res.depth_map, r, t, intr)
    mark("rectify")
    marks[-1][1].synchronize()
    stages = {name: marks[i][1].elapsed_time(ev)
              for i, (name, ev) in enumerate(marks[1:])}
    return fb, res, rect, stages


def phase_e2e(dev):
    """The main path at full HD; returns {kernel: launches} of the timed
    passes."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.ops.kernels.sor import card_limits

    image, i1, i2, flow = e2e_inputs(dev)
    _, intr = slice_inputs(dev)
    n = H * W
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    run_e2e(i1, i2, image, intr, gen)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wrap = wrappers()
    runs = 3
    torch.cuda.reset_peak_memory_stats()
    for fn in wrap.values():
        fn.launches = 0
    stages, walls = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        fb, res, rect, st = run_e2e(i1, i2, image, intr, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append(st)
    counts = {k: fn.launches for k, fn in wrap.items()}
    expect = {**estimation_launches(E2E_CONFIG),
              **flow_launches(E2E_FLOW_PRESET, H, W, card_limits(dev)),
              **OFF_MAIN_PATH}
    expect = {k: runs * c for k, c in expect.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    occ = float(fb.occlusion.float().mean())
    epe = torch.linalg.norm(fb.flow + flow, dim=-1)[~fb.occlusion]
    print(f"[6 e2e] {W}x{H}: v={res.v.cpu().numpy()} w={res.w.cpu().numpy()}"
          f" inliers={int(res.num_inliers)}/{n} occluded={occ:.4f}; flow vs "
          f"-make_flow on unoccluded pixels: median "
          f"{float(epe.median()):.3f} px", flush=True)
    print(f"[6 e2e] ms (median of {runs}, CUDA events): "
          + " ".join(f"{k}={v:.2f}" for k, v in med.items())
          + f" total={sum(med.values()):.2f}; host wall "
          f"{statistics.median(walls):.2f} (warm-up {warm_s:.1f} s); peak "
          f"{peak:.2f} GiB; launches {counts}", flush=True)
    check(counts == expect, f"e2e launches {counts} == {expect}")
    check(counts["sor_sweeps"] <= runs * SOR_LAUNCHES_PER_PASS,
          f"e2e: {counts['sor_sweeps'] / runs} SOR launches per pass <= "
          f"{SOR_LAUNCHES_PER_PASS}")
    for field in ("v", "w", "k", "depth_map", "refine_cost"):
        check(bool(torch.isfinite(getattr(res, field)).all()),
              f"e2e: {field} finite")
    check(tuple(fb.flow.shape) == (H, W, 2)
          and bool(torch.isfinite(fb.flow).all()), "e2e: flow finite (H, W, 2)")
    check(tuple(rect.gs_image.shape) == (H, W, 3)
          and bool(torch.isfinite(rect.gs_image).all()), "e2e: image finite")
    check(occ < 0.5, f"e2e: occluded share {occ} < 0.5")
    check(int(res.num_inliers) > 0.25 * n, "e2e: inliers > 0.25 N")
    # One more pass traced (after the counts were read): the device's busy
    # share, with the profiler's own host overhead in the traced time.
    n_kernels, busy, wall, top, pass_ms = profile_pass(
        lambda: run_e2e(i1, i2, image, intr, gen))
    print(f"[6 e2e] torch.profiler over one pass: {n_kernels} device "
          f"kernels, busy {busy:.2f} ms of {wall:.2f} ms traced "
          f"({100 * busy / wall:.1f} %); most called operators: "
          + ", ".join(f"{name} {calls}" for name, calls in top), flush=True)
    print("[6 e2e] device ms per pass by kernel: "
          + " ".join(f"{k}={v:.3f}" for k, v in pass_ms.items()), flush=True)
    for kname, ms in pass_ms.items():
        check(ms > 0.0, f"{kname}: device time in the profiled pass")
    return counts, pass_ms, (image, res, intr)


def sharded_rank(rank, world, flow_np, intr, draws, device):
    """One rank of phase 7 (run by parallel.launch.spawn in a fresh process
    on `device`, card 0 here): a warm-up pass, then one timed pass of the
    sharded estimation with the launch counts reset just before it; the
    draws go to the device first."""
    import torch
    import torch.distributed as dist

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG
    from rs_sfm_tpu_torch.parallel.api import estimate_sharded

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    run = estimate_sharded(dist.group.WORLD, intr, GAMMA, ESTIMATION_CONFIG)
    flow = torch.from_numpy(flow_np).to(dev)
    draws = torch.from_numpy(draws).to(dev)
    run(flow, sample_indices=draws)
    sync()
    wrap = reset_counts()
    t0 = time.perf_counter()
    res = run(flow, sample_indices=draws)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return {"v": res.v.cpu().numpy(), "w": res.w.cpu().numpy(),
            "k": res.k.cpu().numpy(), "num_inliers": int(res.num_inliers),
            "rows": res.depth_map.shape[0], "ms": ms,
            "launches": {k: fn.launches for k, fn in wrap.items()}}


def phase_sharded(dev):
    """The estimation sharded over 2 ranks on the one card; returns rank 0's
    launch counts of the timed pass."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG as cfg
    from rs_sfm_tpu_torch.parallel.api import pool_pixels
    from rs_sfm_tpu_torch.parallel.launch import spawn
    from rs_sfm_tpu_torch.solver.pipeline import (estimate_from_flow,
                                                  prepare_flow_inputs)
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    world = 2
    flow, intr = slice_inputs(dev)
    n = H * W
    # Draws into the shared pool, and the same pixels for the unsharded pass.
    valid = prepare_flow_inputs(flow, intr, GAMMA, cfg)[4].cpu().numpy()
    pixel = pool_pixels(H, W, world, cfg.ransac_sample_pool)
    pool_valid = valid[np.minimum(pixel, n - 1)] & (pixel < n)
    draws = sample_valid_indices(torch.Generator().manual_seed(4),
                                 torch.from_numpy(pool_valid),
                                 cfg.ransac_trials).numpy()
    picked = torch.from_numpy(pixel[draws]).to(dev)
    estimate_from_flow(flow, intr, GAMMA, cfg, sample_indices=picked)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = estimate_from_flow(flow, intr, GAMMA, cfg, sample_indices=picked)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    outs = spawn(sharded_rank, world, flow.cpu().numpy(), intr, draws,
                 str(dev))
    spawn_s = time.perf_counter() - t0
    for o in outs[1:]:
        for f in ("v", "w", "k", "num_inliers"):
            check(np.array_equal(o[f], outs[0][f]),
                  f"sharded: {f} bit-identical on both ranks")
    check([o["rows"] for o in outs] == [H // world] * world,
          "sharded: each rank holds its block of rows")
    expect = {k: 0 for k in outs[0]["launches"]}
    multi = estimation_launches(cfg)["lm_iter_multi"]
    expect.update(score_hypotheses=1, lm_sums_multi=multi, lm_decide=multi)
    for o in outs:
        check(o["launches"] == expect,
              f"sharded launches {o['launches']} == {expect}")
    got = outs[0]
    rank_ms = ", ".join(f"{o['ms']:.2f}" for o in outs)
    vs, vr = unit(got["v"]), unit(ref.v.cpu().numpy())
    dv = float(np.max(np.abs(vs * np.sign(vs @ vr) - vr)))
    dw = float(np.max(np.abs(got["w"] - ref.w.cpu().numpy())))
    dn = abs(got["num_inliers"] - int(ref.num_inliers))
    print(f"[7 sharded] estimation {W}x{H} over {world} ranks sharing one "
          f"card (gloo): v={got['v']} w={got['w']} inliers="
          f"{got['num_inliers']}/{n}, bit-identical on both ranks; vs the "
          f"unsharded pass on the same hypotheses: v diff {dv:.3e}, w diff "
          f"{dw:.3e}, inliers {int(ref.num_inliers)} (gates "
          f"{SHARDED_GATES}); B7 launches per rank {multi} sums + {multi} "
          f"decide; pass ms per rank {rank_ms} (two ranks on one card) vs "
          f"unsharded {ref_ms:.2f}; spawn + both ranks {spawn_s:.1f} s",
          flush=True)
    check(dv <= SHARDED_GATES["v_direction"] and dw <= SHARDED_GATES["w"],
          f"sharded: v diff {dv}, w diff {dw} within gates")
    check(dn <= SHARDED_GATES["inlier_share"] * n,
          f"sharded: inliers differ by {dn}")
    check(got["num_inliers"] > 0.9 * n, "sharded: inliers > 0.9 N")
    return got["launches"]


def packed_keys(depth):
    """csrc/zbuffer.cu's 64-bit keys (order-preserving depth bits << 32 |
    source id) of flat depths, with the sign bit flipped so that int64
    order is the kernel's unsigned order."""
    import torch

    bits = torch.where(depth == 0.0, 0.0, depth).view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                          bits | 0x80000000)
    src = torch.arange(depth.numel(), dtype=torch.int64, device=depth.device)
    return ((ordered << 32) | src) ^ torch.iinfo(torch.int64).min


def phase_rectify(dev, e2e):
    """B8 and the rectification engines at full HD on the last e2e pass's
    image, depth map and scanline poses; returns ({kernel: launches} of one
    backproject(method="pallas") call, B8's record)."""
    import torch

    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.ops.kernels import zbuffer as kz
    from rs_sfm_tpu_torch.rectify.backproject import (_resolve_packed24,
                                                      backproject,
                                                      splat_inputs)
    from rs_sfm_tpu_torch.rectify.crackfill import fill_cracks
    from rs_sfm_tpu_torch.rectify.warp import small_motion_warp

    image, res, intr = e2e
    n = H * W
    r, t = scanline_poses(res.v, res.w, res.k, H, GAMMA, dtype=torch.float32)
    depth = res.depth_map

    wrap = reset_counts()
    bp = backproject(image, depth, r, t, intr, method="pallas")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrap.items()}
    check(launches == {**{k: 0 for k in wrap}, "zbuffer_splat": 1},
          f"rectify pallas launches {launches}")

    # B8 on that call's inputs against its plain version: bit-exact.
    args = splat_inputs(image, depth, r, t, intr)
    gs_k, hit_k = kz.zbuffer_splat(*args)
    gs_p, hit_p = kz.zbuffer_splat_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(hit_k, hit_p) and torch.equal(gs_k, gs_p),
          "B8 zbuffer_splat bit-exact to plain")
    live = int(torch.isfinite(args[2]).sum())
    # Yardstick (never called by the port): the packed24 engine's conflict
    # resolution, key packing and its scatter_reduce_, on the same splats.
    flat, d = kz.splat_targets(*args[:3])
    colors = image.reshape(n, 3)
    rec = record(float(torch.max(torch.abs(gs_k - gs_p))),
                 time_ms(lambda: kz.zbuffer_splat(*args)),
                 time_ms(lambda: kz.zbuffer_splat_plain(*args)),
                 4 * 3 * n + 4 * 3 * n + 4 * 3 * n + n, OPS_ZBUFFER * n)
    packed24_ms = time_ms(lambda: _resolve_packed24(flat, d, colors, n,
                                                    image))
    # Library yardstick of the min stage only: one scatter_reduce_ "amin"
    # of B8's packed (depth, source id) keys, as int64, into the targets.
    keys = packed_keys(d)
    zbuf = torch.full((n + 1,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    zbuf.scatter_reduce_(0, flat, keys, "amin")
    check(torch.equal(zbuf[:n].reshape(H, W)
                      != torch.iinfo(torch.int64).max, hit_k),
          "B8 scatter_reduce_ amin of the packed keys hits B8's targets")
    rec["library_ms"] = time_ms(
        lambda: zbuf.scatter_reduce_(0, flat, keys, "amin"))
    print(f"[8 rectify] B8 zbuffer_splat {H}x{W} on the e2e depth map "
          f"({live} live splats, {int(hit_k.sum())} hit targets): bit-exact "
          f"to plain; {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.3f} ms, "
          f"packed24 resolve {packed24_ms:.4f} ms, scatter_reduce_ amin of "
          f"the packed keys (min stage only) {rec['library_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms", flush=True)

    engines = {}
    for method in ("packed24", "packed", "sort", "scatter", "pallas"):
        engines[method] = backproject(image, depth, r, t, intr, method=method)
        torch.cuda.synchronize()
        out = engines[method]
        check(tuple(out.gs_image.shape) == (H, W, 3)
              and bool(torch.isfinite(out.gs_image).all()),
              f"rectify {method}: image finite (H, W, 3)")
        # Every engine hits exactly the targets some live source reaches.
        check(torch.equal(out.scattered, bp.scattered),
              f"rectify {method}: hit mask equals pallas's")
    for f in ("gs_image", "scattered", "coords_3d", "valid"):
        check(torch.equal(getattr(engines["pallas"], f),
                          getattr(engines["scatter"], f)),
              f"rectify: pallas {f} equals scatter's")
    ms = {m: wall_ms(lambda m=m: backproject(image, depth, r, t, intr,
                                             method=m))
          for m in engines}
    holes = engines["scatter"].gs_image
    filled = fill_cracks(holes)
    smw = small_motion_warp(image, depth, res.v, res.w, res.k, GAMMA, intr)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(filled).all()), "fill_cracks: image finite")
    check(int(smw.scattered.sum()) > 0.5 * int(bp.scattered.sum()),
          "small_motion_warp: hits")
    ms["fill_cracks"] = wall_ms(lambda: fill_cracks(holes))
    ms["small_motion_warp"] = wall_ms(lambda: small_motion_warp(
        image, depth, res.v, res.w, res.k, GAMMA, intr))
    print(f"[8 rectify] {W}x{H}: pallas equals scatter (image, hit mask, "
          f"points); every engine's hit mask equal ({int(bp.scattered.sum())}"
          f" of {n}); fill_cracks filled {int((filled != holes).any(-1).sum())}"
          f" pixels; small_motion_warp hit {int(smw.scattered.sum())}; ms "
          f"per call (median of 10, host wall with synchronize): "
          + " ".join(f"{k}={v:.3f}" for k, v in ms.items()), flush=True)
    return launches, rec


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
    records = phase_kernels(dev)
    records.update(phase_flow_kernels(dev))
    phase_slice(dev)
    phase_parity(dev)
    launches, pass_ms, e2e = phase_e2e(dev)
    launches["lm_sums_multi"] = phase_sharded(dev)["lm_sums_multi"]
    rect_launches, records["zbuffer_splat"] = phase_rectify(dev, e2e)
    launches["zbuffer_splat"] = rect_launches["zbuffer_splat"]
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "rs_sfm_tpu")
                  for m in sys.modules), "no JAX module was imported")

    from rs_sfm_tpu_torch.ops.kernels import _build

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        check(launches[kname] > 0, f"{kname} launched on the main path")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": str(_build.source_path(src).relative_to(ROOT)),
            "replaces": "rs_sfm_tpu/ops/pallas/" + replaces,
            "launches": launches[kname], **records[kname],
            "pass_ms": pass_ms.get(kname)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
