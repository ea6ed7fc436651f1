#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (rs_sfm_tpu_torch) on one NVIDIA GPU.

Drives the port's main path -- dense flow (forward + half-resolution
backward + occlusion test) -> estimation with two model-feedback passes ->
per-scanline poses -> packed24 rectification -- at full HD (1920x1080) on
bench.py's input and, held to the renderer's truth, on the castle pair,
the solver slice (flow field -> RANSAC -> fused
Schur-LM -> rectification) in both slice configurations, the estimation
sharded over two ranks, every rectification engine, the STRESS.md protocol
on its four full-HD scenes, the command-line interface, the
acceleration model (k) on the castle, the relock pass, the pseudo-real
gate through the camera-pipeline nuisances, the video entry points and
the A10 flow options (the census data term, the shifted refine), through
the
hand-written CUDA kernels of rs_sfm_tpu_torch/csrc; holds each kernel and
each path against their plain PyTorch versions.

    python3 chip_smoke.py          # one CUDA device; a few minutes
    python3 chip_smoke.py --save-b8 PATH   # also saves B8's two inputs,
                                           # for time_b8 of another tree
    python3 chip_smoke.py --stress-evals 50   # STRESS.md's full protocol
                                              # in phase 9 (default 8)

Phases, each printing its lines before the next starts (any failure raises
and the script exits non-zero; nothing is caught and continued):
  [1 device]  the card's name, then nvidia-smi's "name, power.limit" line
  [2 build]   nvcc builds csrc/*.cu for sm_90a, all at once; seconds,
              ptxas usage, B1's SASS instructions per pixel and
              hypothesis, and B8's splat atomics (RED, not ATOM)
              (cuobjdump -sass, ops/kernels/_sass.py)
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
              parentheses); B4's search with a prior (the relock pass's
              tie-break) at the pass's 17x30 coarse and 34x60, 68x120
              refine searches, bit-exact to its plain version with a smooth
              prior and on exact ties, its ms beside the prior-free ms
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
  [6b castle] tests/test_fullhd_flow.py's production gates on the card:
              the castle pair rendered at full HD (gamma 0.9, the gate's
              v and w), its true flow and depth; the clean pair through the
              variational preset and the photometric pair (exposure 1.35,
              vignette 0.35, noise 0.005) through the robust preset, each
              into the production estimation, both as config.E2E_CONFIG
              (the kernel engines; checked equal to the test's EST_CFG but
              for them) and as the test's EST_CFG as written (the "xla"
              engines: solver/refine.py's LM, B1 for RANSAC), each case
              launching B1, and the packed24 rectification:
              flow EPE median, err_v, err3d and depth RMSE beside their
              gates, stage ms; the clean pair into E2E_CONFIG with
              feedback_mode "full" (each feedback pass the whole schedule
              again) at the clean gates, with each pass's RANSAC pick, the
              feedback stage's ms and its launches; then the clean pair
              through E2E_FLOW_PRESET, ungated
  [7 sharded] the estimation at full HD sharded over 2 ranks that share the
              one card over gloo (NCCL refuses two ranks on one device):
              (a) ESTIMATION_CONFIG on bench.py's flow; on the castle's
              true flow with k 0.8 (phase 11's input), (b) E2E_CONFIG and
              (c) the castle gate's EST_CFG ("xla" engines), both with the
              acceleration model and the prescore; each with both ranks'
              scalars bit-identical, within gates of the unsharded pass on
              the same draws (v, w, k, inlier masks), (b) and (c) also at
              the acceleration gate; launches per rank (B1; B7 under the
              fused engine), pass ms per rank beside the unsharded pass,
              global_mesh() over the ranks
  [8 rectify] B8 zbuffer_splat vs its plain version (bit-exact) on the e2e
              pass's depth map and poses and on the castle's frame 1 (its
              true depth and poses): live splats, hit targets, ms and the
              device ops of a call (torch.profiler) on each, two calls back
              to back on the two inputs, its min stage against one
              scatter_reduce_ "amin" of its packed keys; then the five
              engines, fill_cracks and small_motion_warp at full HD;
              "pallas" equals "scatter"
  [9 stress]  the STRESS.md protocol (scripts/stress_r5.py): the castle,
              the photometric castle, the stress scene (movers, a near
              slab) and the mesh-grade castle rendered at full HD in
              float64 on the card, each scene's flow preset, then N
              evaluations (--stress-evals) of fb2_final as written ("xla"
              engines: B1 and solver/refine.py's LM) and of E2E_CONFIG
              (B1-B3) on the same draws, each launching B1: err_v mean /
              median / p90, wrong basins (err_v > 0.2), err_w, err3d, depth
              RMSE, seconds, beside STRESS.md's TPU rows; gates on the
              fb2_final medians (the stress scene's: tests/test_fullhd_flow
              .py's full-HD stress gate); launches of the phase; the LM's
              ms per iteration, xla against B3 / B2, on the clean flow
  [10 cli]    cli.main in process at 600x600 on the card (in
              build/cli_smoke): generate, single-run on the GT flow and
              with --deep-flow --occlusion-mask --model-feedback,
              generate-sweep and sweep, test-flow; the files they write,
              tests/test_harness.py's gates on the GT flow, err_v 0.04 on
              the dense flow, "OK" for both flows; launches of the phase;
              single-run --acceleration on the GT flow, at the same gates;
              single-run --flow-model auto, which must print "variational";
              then the auto preset's probe on phase 6b's full-HD clean and
              photometric pairs (variational and robust, as
              tests/test_fullhd_flow.py's gate), its statistics and ms
  [11 accel]  the acceleration model: the castle rendered at full HD with
              k 0.8 (the castle gate's gamma, v and w; rendered in phase
              7), its true flow into
              estimate_with_feedback with (a) E2E_CONFIG (B1, B3, B2, k
              free), (b) the castle gate's EST_CFG ("xla" engines), (c) (a)
              with RANSAC's prescore (4096 pixels, keep 16), each gated at
              tests/test_synthetic_consistency.py's |k - 0.8| < 0.2 and v
              within 0.05 rad, with err_w, inliers, the hypothesis RANSAC
              picked, pass 1's stage ms (prepare, minimal solve, scoring,
              k-scan, refine) and launches; the device kernels of (a)
              (torch.profiler); (d) B1 on (a)'s 1,536 all-k hypotheses
              (invalid root slots included) and B2 / B3 (J = 4) with k free
              against their plain versions, with their ms; (e) the clean
              castle through dense flow into (a), ungated
  [12 relock] flow_with_relock with E2E_FLOW_PRESET and E2E_CONFIG: (a)
              phase 6b's clean castle, force=True, at the clean gates; (b)
              the repetitive-texture castle at full HD (STRESS.md's reptex
              probe, ungated): the ambiguous share, whether the trigger
              fired, the winning shift n, p_hat, EPE median and err_v of the
              single pass, the winning shift and the relocked result; (a)
              and (b) with their stage ms (flow pass 1, the five shift
              estimations, model feedback, flow pass 2, the final
              estimation) and launches asserted; (c) the clean and the
              repetitive castle at 135x240 on the card and on the CPU with
              the same draws: the ambiguity, p_hat and the winning n
              bit-exact, the second flow pass from the CPU's prior
              bit-exact on the card; the clean castle's final v and w
              within phase 5's gates
  [13 pseudo-real] tests/test_real_ingestion.py's gate: the full-HD castle
              with galaxy_stabil intrinsics, both frames through the Bayer
              demosaic and JPEG 82 (frame 2 also exposure, vignette and a 3
              px streak), 8-bit PNGs through cli.main single-run (robust
              flow, occlusion mask, tol 0.02, 4 starts): err_v <= 0.2,
              inliers > 0.3 of the pixels, the artifacts; then blur, the
              streak, the demosaic and JPEG on a full-HD frame, card
              against CPU: max |diff| and the JPEG levels rounded apart
  [14 video]  pair_flows_dense on phase 6b's castle frames [1, 2, 2] (the
              second pair static), estimate_video with ESTIMATION_CONFIG:
              ok [True, False], pair 0 at the clean err_v gate, pair 1
              zeroed, the pose held; process_video_checkpointed in windows
              of one pair, with and without depth in the checkpoints: a
              resume after window 1's file is lost estimates window 1 alone,
              one with every window saved estimates nothing, and both equal
              the first run
  [15 a10]    the A10 flow options: (a) B5 with the census term (24 more
              planes) at every level of the e2e pyramid (phase 3's SOR
              inputs and the census planes of the same warp), the census
              planes read from global memory on the plan without census,
              bit-exact to plain, ms, plans, launches, bound; (b) B4's
              search in its shifted mode at 17x30, 34x60 and 68x120,
              radius 4, with and without a prior, bit-exact to plain on
              every tile, ms beside the exact refine's; (c)
              tests/test_stress.py's census gates (mean EPE over
              unoccluded pixels: census < 0.7 x without, < 1.0 px) on its
              own 128x128 scene rendered on the card, and the ratio on
              phase 6b's full-HD photometric castle (exposure 1.35,
              vignette 0.35, noise 0.005; its EPE printed, see
              CENSUS_GATES), each flow's launches asserted, then cli.main
              single-run --flow-model census --occlusion-mask on a full-HD
              castle pair with those nuisances as 8-bit PNGs (err_v, not
              gated); (d) the clean castle through E2E_FLOW_PRESET with
              refine_shifted and E2E_CONFIG at phase 6b's clean gates, its
              launches asserted (every refine search shifted)
The last two lines are the per-kernel JSON record and
{"ok": true, "device": {...}}.
"""

import contextlib
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
# The same with the acceleration model and the prescore (phase 7 (b), (c)),
# on the castle's true flow, with the |k| difference.  Each rank prescores
# 4096 pixels of its block, so the prescore's pixels are not the unsharded
# pass's.  Measured on an NVIDIA H100: v 2.4e-8 and 3.6e-8, w 1.2e-10 and
# 2.3e-10, k 6.0e-8 and 2.4e-7, the inlier masks equal; the gates leave
# 30x or more.
SHARDED_ACCEL_GATES = {"v_direction": 1e-6, "w": 1e-8, "k": 1e-5,
                       "inlier_share": 1e-3}
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
# The shifted refine reads as the coarse search does and adds the flow to
# each candidate (1).
OPS_MATCH_SHIFTED = 28
# The census term per pixel and sweep (sor.cu): per channel the residual
# (4), its square and eps (2), root, reciprocal and weight (3), the two
# weighted gradients (2), five products and five sums (10, channel 0
# without the sums), then the five additions to the system.
OPS_SOR_CENSUS = 8 * 21 - 5 + 5
# With a prior, per (candidate, pixel): the distance's 2 subtractions, 2
# multiplies and add, the factor's multiply, add, divide and add, and the
# selection cost's multiply.
OPS_MATCH_PRIOR = 10
# Per source pixel (zbuffer.cu): two adds and floors, four bound compares,
# the target index and one 64-bit atomic min.
OPS_ZBUFFER = 10

# The full-HD castle gate (phase 6b): tests/test_fullhd_flow.py's two
# production gates at their own thresholds, case: (flow preset, gates).
CASTLE_GATES = {
    "clean": ("variational", {"epe_median": 0.3, "err_v": 0.04,
                              "err3d": 0.35, "depth_rmse": 0.9}),
    "photometric": ("robust", {"epe_median": 3.5, "err_v": 0.12,
                               "err3d": 1.0, "depth_rmse": 2.2}),
}
# That test's estimation configuration (EST_CFG, tests/test_fullhd_flow.py:
# 51-57); config.E2E_CONFIG must equal it but for the kernel engines and
# RANSAC's chunk, which change no result.
FULLHD_EST_CFG = dict(ransac_trials=256, ransac_tol=0.02,
                      refine_iterations=20, refine_starts=4,
                      refine_winnow_iters=8, refine_rel_tol=0.0,
                      depth_residual_px=2.0, refine_loss_delta_px=3.0,
                      feedback_passes=2, feedback_mode="refine",
                      feedback_refine_iterations=8)
ENGINE_FIELDS = {"refine_engine", "ransac_engine", "ransac_chunk"}

# The STRESS.md protocol (phase 9): scripts/stress_r5.py's four scenes at
# full HD (gamma 0.9, the castle gate's v and w, k 0), each scene's flow
# preset (scripts/stress_r5.py:112-113) and the fb2_final configuration
# (scripts/stress_r5.py:80-103), which is FULLHD_EST_CFG.
STRESS_PRESETS = {"castle_clean": "variational", "castle_photo": "robust",
                  "stress": "variational", "mesh": "variational"}
STRESS_EVALS = 8
STRESS_SEED = 11
# STRESS.md's fb2_final rows (results/stress_r5.json, 50 evaluations, TPU
# v5e): err_v mean, median, p90; err_w mean; err3d mean; depth RMSE mean.
# Accuracy values of the JAX package, printed beside the card's.
STRESS_TPU_ROWS = {
    "castle_clean": (0.006150, 0.006147, 0.006167, 0.000739, 0.1287, 0.4652),
    "castle_photo": (0.07437, 0.07437, 0.07438, 0.005816, 0.4053, 1.1604),
    "stress": (0.2990, 0.06014, 0.5812, 0.01192, 0.4994, 0.8211),
    "mesh": (0.01101, 0.01101, 0.01102, 0.001268, 0.1483, 0.4255),
}
# Gates on the medians of the fb2_final ("xla") configuration: the castle
# scenes' are tests/test_fullhd_flow.py's, the mesh (no full-HD gate of
# its own) takes the clean ones.  The stress scene's is that file's own
# full-HD stress gate (test_fullhd_stress_movers_and_seed_stability: err_v
# <= 0.16 a seed, on the exact warp, warp_engine "xla", as B4 is).  Twice
# STRESS.md's median (0.1203) is printed beside it, not gated: STRESS.md
# measured through the TPU warp kernel, whose residual displacements beyond
# warp_radius 24 sample its block window's edge, an approximation of the
# exact warp (rs_sfm_tpu/ops/pallas/warp.py:15-20) on which this scene's
# result turns (STRESS.md's warp-radius note: radius 16, 24, 32 give err_v
# 0.6155, 0.0576, 0.0817).  The stress mean is printed only (STRESS.md: ~3
# of 50 evaluations in a wrong basin).
STRESS_GATES = {
    "castle_clean": {"err_v": 0.04, "err3d": 0.35, "depth_rmse": 0.9},
    "castle_photo": {"err_v": 0.12, "err3d": 1.0, "depth_rmse": 2.2},
    "stress": {"err_v": 0.16},
    "mesh": {"err_v": 0.04, "err3d": 0.35, "depth_rmse": 0.9},
}
WRONG_BASIN = 0.2
# The CLI phase (10): tests/test_harness.py's gates on the GT flow, the
# clean castle gate's err_v on the dense flow.
CLI_SIZE = 600
CLI_GT_GATES = {"err_w": 1e-3, "err_v": 0.02, "reprojection": 0.2}
CLI_DEEP_ERR_V = 0.04

# The acceleration phase (11): the castle gate's render with k 0.8 and its
# true flow, held to tests/test_synthetic_consistency.py:111-123's
# thresholds (|k - 0.8| < 0.2, v within 0.05 rad); case (c) adds RANSAC's
# prescore.
ACCEL_K = 0.8
ACCEL_GATES = {"k_err": 0.2, "err_v": 0.05}
ACCEL_PRESCORE = dict(ransac_prescore_subsample=4096, ransac_prescore_keep=16)

# B4's search with a prior (phase 3): the e2e pass's searches at these
# (shape, mode), the full-HD pass's coarse search and its first two
# refines (the backward flow's pyramid).
PRIOR_SEARCHES = (((17, 30), "coarse"), ((34, 60), "refine"),
                  ((68, 120), "refine"))
# The relock phase (12): phase 6b's clean castle through flow_with_relock
# (force=True) at the clean gate; the repetitive-texture castle at full HD
# (STRESS.md's reptex probe: ungated); at 135x240 on the card against the
# CPU with the same draws, the clean castle (the final motion within phase
# 5's gates) and the repetitive one.  On the repetitive one the first
# flow pass, the ambiguity, p_hat, the winning shift and the second flow
# pass from one prior are held bit-exact, its motion printed only: its
# estimations fit about 7,000 of 32,400 pixels to a wrong model (w about
# 10x the truth), and the card's RANSAC breaks count ties by B1's
# approximate error sums (ROADMAP's hazards), so card and CPU models part
# by 1e-3 and more (chip run 2 of PR 12).
RELOCK_PARITY_SIZE = (135, 240)
# The pseudo-real gate (phase 13): tests/test_real_ingestion.py's pair.
PSEUDO_REAL = dict(v=(0.3, -0.1, 0.2), w=(0.002, -0.001, 0.003),
                   camera="galaxy_stabil", err_v=0.2, inlier_share=0.3)
PSEUDO_REAL_FRAMES = (
    dict(noise_sigma=0.003, demosaic=True, jpeg_quality=82),
    dict(exposure=1.25, vignette=0.25, noise_sigma=0.004,
         motion_blur_px=3.0, demosaic=True, jpeg_quality=82))
# The four camera-pipeline nuisances, card against CPU (phase 13).
NUISANCES = {"blur": dict(blur=True), "motion_blur": dict(motion_blur_px=3.0),
             "demosaic": dict(demosaic=True),
             "jpeg": dict(jpeg_quality=82)}
NUISANCE_ATOL = 1e-6
# The A10 flow options (phase 15).  The shifted refine's searches: the e2e
# pass's 34x60 and 68x120 refines and its 17x30 level (searched there by
# the coarse search), radius 4.
SHIFTED_SEARCHES = ((17, 30), (34, 60), (68, 120))
# tests/test_stress.py::test_census_handles_exposure_and_vignette: its
# scene (the castle at 128x128, gamma 0.9, its v and w; frame 2 with
# eval.gate.PHOTOMETRIC's exposure 1.35, vignette 0.35 and noise 0.005)
# and its gates on the mean EPE over the unoccluded pixels of
# flow_forward_backward with DenseFlowConfig(): census_weight 1.0 below
# 0.7 x the flow without census, and below 1.0 px.  Both gate that scene;
# on the full-HD photometric castle (the castle gate's motion, flows about
# 15x the 128x128 scene's) the ratio is gated and the EPE printed beside
# 1.0 px: the mean over unoccluded pixels grows with the flow's scale
# (7.52 px with census, 22.65 without, on an H100), and at full HD the JAX
# package's own flows are far above 1.0 px too: STRESS.md's raw
# unoccluded means are 3.08 px for the clean castle with the plain
# (production) preset and 8.94 px for the stress scene with census.
CENSUS_TEST_SCENE = dict(size=128, v=(0.12, -0.05, 0.08),
                         w=(0.003, -0.002, 0.004))
CENSUS_GATES = {"ratio": 0.7, "epe": 1.0}

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
    wrap["sor_sweeps"].census_launches = 0
    wrap["match_search"].shifted_launches = 0
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
                # The warp-local search (the shifted refine warps I2 once
                # first), then its median clean-up.
                search += 1
                med += 1
                warp += cfg.refine_shifted
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
    # RANSAC scores on B1 on the card under either engine, its prescore
    # too.
    score = 2 if cfg.ransac_prescore_subsample else 1
    if cfg.feedback_mode == "full":
        # Each feedback pass runs the whole schedule again.
        reps = 1 + cfg.feedback_passes
        multi, single, score = multi * reps, single * reps, score * reps
    else:
        fb_iters = cfg.feedback_refine_iterations or cfg.refine_iterations
        single += cfg.feedback_passes * (fb_iters + 1)
    if cfg.refine_engine != "pallas":
        multi = single = 0
    return {"score_hypotheses": score, "lm_iter": single,
            "lm_iter_multi": multi}


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
    # B8's splat: its 64-bit min is a reduction (RED), not an ATOM that
    # waits for the old value.
    zlib = str(_build.library_path("zbuffer"))
    for prefix in ("RED", "ATOM"):
        for line in _sass.opcodes(zlib, "splat_kernel", prefix):
            print(f"  zbuffer SASS: {line}")
    counts = _sass.opcode_counts(zlib, "splat_kernel")
    if counts is None:
        print("  zbuffer SASS: no cuobjdump, B8's RED not checked")
    else:
        ops = [op for found in counts.values() for op in found]
        check(counts and any(op.startswith("REDG") and ".MIN.64" in op
                             for op in ops)
              and not any(op.startswith("ATOM") for op in ops),
              "B8 splat_kernel's min is a REDG .MIN.64 and no ATOM")
        print("  zbuffer SASS: checked, the splat's min is a REDG .MIN.64 "
              "and it has no ATOM")
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
    for j in (1, 4):
        name = "lm_iter" if j == 1 else "lm_iter_multi"
        out[name], st, pxl, masks, rp, rc, rho = check_lm(
            "[3 kernels]", coords, flow_n, alpha, alpha_k, v_all[top[:j]],
            w_all[top[:j]], k_all[top[:j]], inl_j[:j], rho_j[:j], loss_delta,
            optimize_k=False)
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


def check_lm(tag, coords, flow_n, alpha, alpha_k, v0, w0, k0, inl, rho0,
             loss_delta, optimize_k):
    """B2 (one start) or B3 (J starts: v0, w0 (J, 3), k0 (J,), inl and
    rho0 (J, N)) against its plain version: one step from the same state
    (the bootstrap sweep, and a full step after two plain steps of history),
    then 21 sweeps of refine_pallas(_multi) against a plain loop (v
    direction, w, cost and, with k free, k within rtol 1e-4), and its ms.
    Returns (record, the state after 4 plain steps, the pixel record, the
    masks, rho_prev and rho_cand after the 21 plain sweeps, the depths)."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.ops.kernels import refine_kernels as rk
    from rs_sfm_tpu_torch.solver import refine_fused as rf

    j, n = inl.shape[0], coords.shape[0]
    name = "lm_iter" if j == 1 else "lm_iter_multi"
    f32 = torch.float32
    zero = torch.zeros_like(alpha)
    masks = inl.to(f32).contiguous()
    pxl = torch.stack([coords[:, 0], coords[:, 1], flow_n[:, 0],
                       flow_n[:, 1], alpha, alpha_k,
                       masks[0] if j == 1 else zero, zero]).to(f32)
    rho = rho0.to(f32).contiguous()
    state = rf.initial_state(v0, w0, k0, optimize_k=optimize_k,
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
    # leaves the 7x7 system nearly singular, and the solved delta's gauge
    # component is float32 rounding in any two summation orders.
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
    kw = dict(optimize_k=optimize_k, iterations=20, rel_tol=0.0,
              loss_delta=loss_delta)
    if j == 1:
        res = rf.refine_pallas(coords, flow_n, alpha, alpha_k, masks[0] > 0.5,
                               v0[0], w0[0], k0[0], rho[0], **kw)
        theta_k = torch.cat([res.v, res.w, res.k.reshape(1)])[None]
        cost_k = res.cost.reshape(1)
    else:
        res = rf.refine_pallas_multi(coords, flow_n, alpha, alpha_k,
                                     masks > 0.5, v0, w0, k0, rho, **kw)
        theta_k = torch.cat([res.v, res.w, res.k[:, None]], dim=1)
        cost_k = res.cost
    theta_k = theta_k.cpu().numpy().astype(np.float64)
    theta_p = st_p[:, 0:7].cpu().numpy().astype(np.float64)
    for s in range(j):
        vk, vp = unit(theta_k[s, 0:3]), unit(theta_p[s, 0:3])
        check(np.allclose(vk, vp, rtol=1e-4, atol=1e-6),
              f"{name} 21 sweeps: v direction {vk} vs plain {vp}")
    check(np.allclose(theta_k[:, 3:6], theta_p[:, 3:6], rtol=1e-4, atol=0.0),
          f"{name} 21 sweeps: w {theta_k[:, 3:6]} vs {theta_p[:, 3:6]}")
    if optimize_k:
        check(np.allclose(theta_k[:, 6], theta_p[:, 6], rtol=1e-4, atol=0.0),
              f"{name} 21 sweeps: k {theta_k[:, 6]} vs {theta_p[:, 6]}")
    check(torch.allclose(cost_k, st_p[:, rk.S_COST], rtol=1e-4, atol=0.0),
          f"{name} 21 sweeps: cost {cost_k} vs {st_p[:, rk.S_COST]}")
    err = float(np.max(np.abs(theta_k - theta_p)))
    ms = time_ms(lambda: kernel(state, rho, rho))
    plain_ms = time_ms(lambda: plain(state, rho, rho))
    rec = record(err, ms, plain_ms, lm_bytes(n, j), OPS_LM * n * j)
    free = ", k free" if optimize_k else ""
    print(f"{tag} {'B2' if j == 1 else 'B3'} {name} J={j} N={n}{free} Huber "
          f"delta={loss_delta:.4g}: one step matches plain (state rtol 1e-5; "
          f"largest diff at slot {worst}); 21 sweeps v, w"
          f"{', k' if optimize_k else ''}, cost within rtol 1e-4, theta max "
          f"abs diff {err:.3e}"
          + (f" (k {theta_k[:, 6]} vs plain {theta_p[:, 6]})"
             if optimize_k else "")
          + f"; {ms:.3f} ms/iteration vs plain {plain_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms", flush=True)
    return rec, st, pxl, masks, rp, rc, rho


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

    def recorded(*args, shifted=False):
        # (i1m, i2m, flow, radius, ratio, fallback); the pass has no prior
        # and searches in the exact modes.
        check(len(args) < 7 or args[6] is None, "the e2e pass has no prior")
        check(not shifted, "the e2e pass has no shifted search")
        calls.append(args[:6])
        return search(*args, shifted=shifted)

    # The wrapper counts on the module's match_search, this one meanwhile.
    recorded.launches = recorded.shifted_launches = 0
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


def _smooth_field(h, w, dev, seed, scale):
    """An (h, w, 2) float32 field on `dev`: uniform noise smoothed by a
    5x5 mean, times `scale`."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.rand((1, 2, h, w), generator=gen, device=dev) * 2.0 - 1.0
    return (F.avg_pool2d(noise, 5, 1, 2)[0].permute(1, 2, 0) * scale
            ).contiguous()


def check_prior_searches(i1, i2):
    """B4's search with a prior at PRIOR_SEARCHES of the e2e pass: a smooth
    random prior (3 px about the searched flow), and exact ties (frame 2's
    plane made periodic, period 3 columns, in its left half, the prior at
    the lock 3 px right of the prior-free pick), each bit-exact to the
    plain version; ms with and without the prior, and the bound with the
    prior's 8 bytes a pixel and its operations."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import match as km

    calls = {}
    for args in e2e_searches(i1, i2):
        key = (tuple(args[0].shape), "coarse" if args[2] is None
               else "refine")
        calls.setdefault(key, args)
    rows = []
    for key in PRIOR_SEARCHES:
        check(key in calls, f"the e2e pass searches {key}")
        i1m, i2m, flow, radius, _, _ = calls[key]
        (h, w), mode = key
        dev = i1m.device
        smooth = _smooth_field(h, w, dev, h, 3.0) + (
            flow if flow is not None else 0.0)
        stripe = torch.tensor([0.5, -0.25, 0.75], device=dev)
        i2t = i2m.clone()
        i2t[:, : w // 2] = stripe[torch.arange(w // 2, device=dev) % 3]
        free_t = km.match_search_plain(i1m, i2t, flow, radius)
        ties = free_t[0] + torch.tensor([3.0, 0.0], device=dev)
        moved = {}
        for name, planes, prior, free in (
                ("smooth", (i1m, i2m), smooth,
                 km.match_search_plain(i1m, i2m, flow, radius)),
                ("ties", (i1m, i2t), ties, free_t)):
            got = km.match_search(*planes, flow, radius, prior=prior)
            ref = km.match_search_plain(*planes, flow, radius, prior=prior)
            torch.cuda.synchronize()
            check(all(same_bits(g, r) for g, r in zip(got, ref)),
                  f"match_search {h}x{w} {mode} prior {name} bit-exact")
            moved[name] = float(torch.any(ref[0] != free[0], dim=-1)
                                .float().mean())
        ms = time_ms(lambda: km.match_search(i1m, i2m, flow, radius,
                                             prior=smooth))
        ms_free = time_ms(lambda: km.match_search(i1m, i2m, flow, radius))
        n, k = h * w, (2 * radius + 1) ** 2
        nbytes = n * (4 + 4 + (8 if flow is not None else 0) + 8 + 8 + 8
                      + 1)
        ops = ((OPS_MATCH_REFINE if flow is not None else OPS_MATCH_COARSE)
               + OPS_MATCH_PRIOR) * k * n
        b_ms, b_by = bound(nbytes, ops)
        rows.append({"shape": [h, w], "mode": mode, "candidates": k,
                     "ms": ms, "ms_without_prior": ms_free, "bound_ms": b_ms,
                     "bound_by": b_by, "moved": moved})
        print(f"[3 kernels] B4 match_search {h}x{w} {mode} K={k} with a "
              f"prior: bit-exact to plain (smooth prior and exact ties; "
              f"picks moved by the prior {moved['smooth']:.4f} / "
              f"{moved['ties']:.4f} of pixels); {ms:.4f} ms vs "
              f"{ms_free:.4f} ms without, bound {b_ms:.6f} ms ({b_by})",
              flush=True)
    return rows


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
    out["match_search"]["prior"] = check_prior_searches(i1, i2)

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


def stage_marks():
    """(mark, read): mark(name) records a CUDA event after the work issued
    so far; read() synchronises and returns {stage: ms since the mark
    before}."""
    import torch

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def read():
        marks[-1][1].synchronize()
        return {name: marks[i][1].elapsed_time(ev)
                for i, (name, ev) in enumerate(marks[1:])}

    mark("start")
    return mark, read


def run_e2e(i1, i2, image, intr, generator):
    """One pass of the main path; returns (flow result, estimation,
    rectified, stage ms)."""
    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

    mark, read = stage_marks()
    fb = flow_forward_backward(i1, i2, E2E_FLOW_PRESET, timer=mark)
    res = estimate_with_feedback(fb.flow, intr, GAMMA, E2E_CONFIG, generator,
                                 pixel_mask=~fb.occlusion, timer=mark)
    r, t = scanline_poses(res.v, res.w, res.k, i1.shape[0], GAMMA,
                          dtype=torch.float32)
    rect = backproject(image, res.depth_map, r, t, intr)
    mark("rectify")
    return fb, res, rect, read()


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


def phase_castle(dev):
    """The castle gate: tests/test_fullhd_flow.py's production gates at
    full HD on the card, held to the renderer's truth; returns the castle
    truth (phase 8 splats its frame 1)."""
    import dataclasses

    import torch

    from rs_sfm_tpu_torch.config import (E2E_CONFIG, E2E_FLOW_PRESET,
                                         PipelineConfig)
    from rs_sfm_tpu_torch.data.synthetic import apply_photometric
    from rs_sfm_tpu_torch.eval.gate import (PHOTOMETRIC, castle_truth,
                                            production_gate)
    from rs_sfm_tpu_torch.models import get_flow_preset

    est = PipelineConfig(**FULLHD_EST_CFG)
    differ = {f.name for f in dataclasses.fields(PipelineConfig)
              if getattr(E2E_CONFIG, f.name) != getattr(est, f.name)}
    check(differ == ENGINE_FIELDS,
          f"E2E_CONFIG equals the gate's EST_CFG but in {differ}")
    t0 = time.perf_counter()
    truth = castle_truth(H, W, dev)
    torch.cuda.synchronize()
    truth_s = time.perf_counter() - t0
    moving = torch.linalg.vector_norm(truth.gt_flow, dim=-1) > 0
    mag = torch.linalg.vector_norm(truth.gt_flow, dim=-1)[moving]
    print(f"[6b castle] {W}x{H} castle rendered (both frames, RS and GS), "
          f"true flow and true depth in {truth_s:.2f} s: "
          f"{float((truth.true_depth > 0).float().mean()):.4f} of pixels "
          f"hit, true flow median {float(mag.median()):.3f} px, max "
          f"{float(mag.max()):.3f} px; E2E_CONFIG equals "
          f"tests/test_fullhd_flow.py's EST_CFG but in {sorted(differ)}",
          flush=True)
    i2p = apply_photometric(truth.i2, torch.Generator(device=dev).manual_seed(
        1), **PHOTOMETRIC)
    # Each gated case through E2E_CONFIG (the kernel engines) and through
    # the test's EST_CFG as written (the "xla" engines: solver/refine.py's
    # LM; RANSAC scores on B1 under either engine).
    cases = [(f"{case}, {name}", get_flow_preset(preset),
              i2p if case == "photometric" else truth.i2, gates, cfg)
             for case, (preset, gates) in CASTLE_GATES.items()
             for name, cfg in (("E2E_CONFIG", E2E_CONFIG),
                               ("EST_CFG", est))]
    # feedback_mode "full" (each feedback pass the whole schedule again, on
    # its own generator) at the clean gate.
    full = dataclasses.replace(E2E_CONFIG, feedback_mode="full")
    cases.append(("clean, E2E_CONFIG feedback_mode full",
                  get_flow_preset(CASTLE_GATES["clean"][0]), truth.i2,
                  CASTLE_GATES["clean"][1], full))
    cases.append(("clean, E2E_FLOW_PRESET, E2E_CONFIG (no gate)",
                  E2E_FLOW_PRESET, truth.i2, None, E2E_CONFIG))
    b1 = wrappers()["score_hypotheses"]
    for case, flow_cfg, i2, gates, est_cfg in cases:
        wrap = reset_counts()
        mark, read = stage_marks()
        with record_passes() as passes:
            got = production_gate(truth, i2, flow_cfg, est_cfg,
                                  torch.Generator(device=dev).manual_seed(0),
                                  timer=mark)
        stages = read()
        check(b1.launches > 0, f"castle {case}: B1 launched")
        shown = " ".join(
            f"{k}={v:.4f}" + (f" (gate {gates[k]})" if gates and k in gates
                              else "")
            for k, v in got.items())
        print(f"[6b castle] {case}: {shown}; ms "
              + " ".join(f"{k}={v:.2f}" for k, v in stages.items()),
              flush=True)
        if est_cfg.feedback_mode == "full":
            expect = estimation_launches(est_cfg)
            counts = {k: wrap[k].launches for k in expect}
            check(counts == expect, f"castle {case}: launches {counts} == "
                  f"{expect}")
            print(f"[6b castle] {case}: each pass's RANSAC pick (v, w, "
                  f"inliers): "
                  + "; ".join(f"pass {i + 1} v={r.ransac_v.cpu().numpy()} "
                              f"w={r.ransac_w.cpu().numpy()} "
                              f"{int(r.num_inliers)}"
                              for i, r in enumerate(passes))
                  + f"; feedback stage {stages['feedback']:.2f} ms; "
                  f"launches {counts}", flush=True)
            check(len(passes) == 1 + est_cfg.feedback_passes,
                  f"castle {case}: {len(passes)} RANSAC passes")
        if gates:
            for k, gate in gates.items():
                check(got[k] <= gate, f"castle {case}: {k} {got[k]} <= {gate}")
    return truth, i2p


@contextlib.contextmanager
def record_passes():
    """Collects the result of every estimate_from_flow call that
    estimate_with_feedback makes meanwhile (one a pass)."""
    from rs_sfm_tpu_torch.solver import pipeline

    inner = pipeline.estimate_from_flow
    results = []

    def recording(*args, **kwargs):
        results.append(inner(*args, **kwargs))
        return results[-1]

    pipeline.estimate_from_flow = recording
    try:
        yield results
    finally:
        pipeline.estimate_from_flow = inner


def sharded_rank(rank, world, flow_np, intr, draws, device, cfg=None):
    """One rank of phase 7 (run by parallel.launch.spawn in a fresh process
    on `device`, card 0 here): a warm-up pass, then one timed pass of the
    sharded estimation (cfg, by default ESTIMATION_CONFIG) with the launch
    counts reset just before it; the draws go to the device first.  Also
    builds global_mesh() over the ranks."""
    import torch
    import torch.distributed as dist

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG
    from rs_sfm_tpu_torch.parallel.api import estimate_sharded
    from rs_sfm_tpu_torch.parallel.distributed import global_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = cfg or ESTIMATION_CONFIG
    run = estimate_sharded(dist.group.WORLD, intr, GAMMA, cfg,
                           pool_per_shard=cfg.ransac_sample_pool)
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
            "inlier_mask": res.inlier_mask.cpu().numpy(),
            "launches": {k: fn.launches for k, fn in wrap.items()},
            "mesh": global_mesh().shape}


def pool_draws(flow, intr, cfg, world, seed):
    """(draws into the valid pixels of the pool that estimate_sharded
    shares over `world` ranks, the same pixels as indices into the whole
    image, on the flow's device)."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.parallel.api import pool_pixels
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    h, w = flow.shape[:2]
    n = h * w
    valid = prepare_flow_inputs(flow, intr, GAMMA, cfg)[4].cpu().numpy()
    pixel = pool_pixels(h, w, world, cfg.ransac_sample_pool)
    pool_valid = valid[np.minimum(pixel, n - 1)] & (pixel < n)
    draws = sample_valid_indices(torch.Generator().manual_seed(seed),
                                 torch.from_numpy(pool_valid),
                                 cfg.ransac_trials).numpy()
    return draws, torch.from_numpy(pixel[draws]).to(flow.device)


def sharded_run(case, flow, intr, cfg, gates, truth_gates=None):
    """One sharded estimation over 2 ranks on the card against the
    unsharded pass on the same draws: both ranks bit-identical, the gates
    (v direction, w, |k| difference, inlier share), the launches per rank
    (B1 per rank, B7 under the fused engine), and, given `truth_gates`,
    the castle's acceleration gate.  Returns rank 0's launch counts."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.parallel.launch import spawn
    from rs_sfm_tpu_torch.solver.pipeline import estimate_from_flow

    import dataclasses

    world = 2
    h, w = flow.shape[:2]
    n = h * w
    draws, picked = pool_draws(flow, intr, cfg, world, seed=4)
    estimate_from_flow(flow, intr, GAMMA, cfg, sample_indices=picked)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = estimate_from_flow(flow, intr, GAMMA, cfg, sample_indices=picked)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    outs = spawn(sharded_rank, world, flow.cpu().numpy(), intr, draws,
                 str(flow.device), cfg)
    spawn_s = time.perf_counter() - t0
    for o in outs[1:]:
        for f in ("v", "w", "k", "num_inliers"):
            check(np.array_equal(o[f], outs[0][f]),
                  f"sharded {case}: {f} bit-identical on both ranks")
    check([o["rows"] for o in outs] == [h // world] * world,
          f"sharded {case}: each rank holds its block of rows")
    check(all(o["mesh"] == {"pairs": 1, "pixels": world} for o in outs),
          f"sharded {case}: global_mesh() {outs[0]['mesh']}")
    expect = {k: 0 for k in outs[0]["launches"]}
    # estimate_sharded runs estimate_from_flow: no feedback passes.
    est = estimation_launches(dataclasses.replace(cfg, feedback_passes=0))
    expect["score_hypotheses"] = est["score_hypotheses"]
    expect.update(lm_sums_multi=est["lm_iter_multi"] + est["lm_iter"],
                  lm_decide=est["lm_iter_multi"] + est["lm_iter"])
    for o in outs:
        check(o["launches"] == expect,
              f"sharded {case}: launches {o['launches']} == {expect}")
    got = outs[0]
    rank_ms = ", ".join(f"{o['ms']:.2f}" for o in outs)
    vs, vr = unit(got["v"]), unit(ref.v.cpu().numpy())
    dv = float(np.max(np.abs(vs * np.sign(vs @ vr) - vr)))
    dw = float(np.max(np.abs(got["w"] - ref.w.cpu().numpy())))
    dk = abs(float(got["k"]) - float(ref.k))
    mask = np.concatenate([o["inlier_mask"] for o in outs])
    share = float(np.mean(mask != ref.inlier_mask.cpu().numpy()))
    line = (f"[7 sharded] {case} {w}x{h} over {world} ranks sharing one "
            f"card (gloo): v={got['v']} w={got['w']} k={float(got['k']):.6g}"
            f" inliers={got['num_inliers']}/{n}, bit-identical on both "
            f"ranks; vs the unsharded pass on the same draws: v diff "
            f"{dv:.3e}, w diff {dw:.3e}, k diff {dk:.3e}, inlier masks "
            f"differ on {share:.3e} of pixels, inliers "
            f"{int(ref.num_inliers)} (gates {gates}); launches per rank "
            f"B1 {expect['score_hypotheses']}, B7 {expect['lm_sums_multi']} "
            f"sums + {expect['lm_decide']} decide; pass ms per rank "
            f"{rank_ms} (two ranks on one card) vs unsharded {ref_ms:.2f}; "
            f"spawn + both ranks {spawn_s:.1f} s")
    if truth_gates:
        errs = accel_errors(ref._replace(
            v=torch.from_numpy(got["v"]), w=torch.from_numpy(got["w"]),
            k=torch.tensor(float(got["k"])),
            num_inliers=torch.tensor(got["num_inliers"])))
        line += f"; against the truth {show(errs)} (gates {truth_gates})"
    print(line, flush=True)
    check(dv <= gates["v_direction"] and dw <= gates["w"],
          f"sharded {case}: v diff {dv}, w diff {dw} within gates")
    check(dk <= gates.get("k", 0.0), f"sharded {case}: k diff {dk}")
    check(share <= gates["inlier_share"],
          f"sharded {case}: inlier masks differ on {share}")
    check(got["num_inliers"] > 0.9 * n, f"sharded {case}: inliers > 0.9 N")
    if truth_gates:
        for key, gate in truth_gates.items():
            check(errs[key] < gate, f"sharded {case}: {key} {errs[key]} < "
                  f"{gate}")
    return got["launches"]


def phase_sharded(dev):
    """The estimation sharded over 2 ranks on the one card: (a)
    ESTIMATION_CONFIG on the full-HD flow, then on the castle's true flow
    with k 0.8 (phase 11's inputs), (b) E2E_CONFIG and (c) the castle
    gate's EST_CFG ("xla"), both with the acceleration model and the
    prescore.  Returns (rank 0's launch counts of (a), the castle truth
    with k 0.8)."""
    import dataclasses

    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, ESTIMATION_CONFIG
    from rs_sfm_tpu_torch.config import PipelineConfig
    from rs_sfm_tpu_torch.eval.gate import castle_truth

    flow, intr = slice_inputs(dev)
    launches = sharded_run("(a) ESTIMATION_CONFIG", flow, intr,
                           ESTIMATION_CONFIG, SHARDED_GATES)
    truth = castle_truth(H, W, dev, k=ACCEL_K)
    extra = dict(use_acceleration=True, **ACCEL_PRESCORE)
    for case, cfg in (
            ("(b) E2E_CONFIG + acceleration + prescore",
             dataclasses.replace(E2E_CONFIG, **extra)),
            ("(c) EST_CFG (xla) + acceleration + prescore",
             PipelineConfig(**FULLHD_EST_CFG, **extra))):
        torch.cuda.synchronize()
        sharded_run(case, truth.gt_flow, truth.intr, cfg,
                    SHARDED_ACCEL_GATES, ACCEL_GATES)
    return launches, truth


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


def op_split(fn, calls=20):
    """{device op name: (ops per call, ms per call)} of fn() over `calls`
    calls under torch.profiler (kernels and memsets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count, us = split.get(e.name, (0, 0.0))
            split[e.name] = (count + 1, us + e.time_range.elapsed_us())
    return {name: (count / calls, us / calls / 1e3)
            for name, (count, us) in split.items()}


def splat_bytes(n, hits):
    """The bytes B8 must move on n pixels of which `hits` targets are hit:
    tx, ty and depth read (12 a pixel), the image and hit flags written
    (13 a pixel), and each hit target's winning colour read (12)."""
    return 25 * n + 12 * hits


def splat_exact(out, args):
    """Whether B8's (gs_image, scattered) on `args` equal its plain
    version's bit for bit."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import zbuffer as kz

    gs_p, hit_p = kz.zbuffer_splat_plain(*args)
    return torch.equal(out[0], gs_p) and torch.equal(out[1], hit_p)


def time_b8(path, label, rounds=3):
    """B8 of the rs_sfm_tpu_torch that `import` finds, on the inputs that
    `chip_smoke.py --save-b8 PATH` saved: bit-exact to its plain version,
    then per input `rounds` medians of 20 CUDA-event timings and the
    device ops of a call.  Run it from another checkout (the parent's) to
    time that tree's B8 on the same inputs, in the same chip call:

        cd PARENT && python3 -c "import runpy; runpy.run_path(
            'CHANGE/chip_smoke.py')['time_b8']('INPUTS', 'parent')"
    """
    import torch

    from rs_sfm_tpu_torch.ops.kernels import zbuffer as kz

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for what, args in torch.load(path).items():
        args = [a.to(dev) for a in args]
        check(splat_exact(kz.zbuffer_splat(*args), args),
              f"{label}: B8 bit-exact to plain on the {what} input")
        ms = [time_ms(lambda args=args: kz.zbuffer_splat(*args))
              for _ in range(rounds)]
        split = op_split(lambda args=args: kz.zbuffer_splat(*args))
        print(f"[b8 {label}] {what}: bit-exact to plain; ms "
              + ", ".join(f"{m:.4f}" for m in ms) + "; device ops a call: "
              + "; ".join(f"{name.split('(')[0]} x{count:g} {op_ms:.4f} ms"
                          for name, (count, op_ms) in split.items()),
              flush=True)


def phase_rectify(dev, e2e, castle, save_b8=None):
    """B8 and the rectification engines at full HD on the last e2e pass's
    image, depth map and scanline poses, and B8 on the castle's frame 1
    (its RS image, true depth and true scanline poses); returns
    ({kernel: launches} of one backproject(method="pallas") call, B8's
    record on the e2e input).  With `save_b8`, B8's two inputs are also
    saved there for time_b8."""
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

    # B8 on both inputs against its plain version: bit-exact.
    inputs = {
        "e2e": splat_inputs(image, depth, r, t, intr),
        "castle": splat_inputs(castle.i1, castle.true_depth, castle.poses_r,
                               castle.poses_t, castle.intr)}
    ms, hits = {}, {}
    for what, args in inputs.items():
        out = kz.zbuffer_splat(*args)
        check(splat_exact(out, args),
              f"B8 zbuffer_splat bit-exact to plain on the {what} input")
        live = int((kz.splat_targets(*args[:3])[0] < n).sum())
        hits[what] = int(out[1].sum())
        ms[what] = time_ms(lambda args=args: kz.zbuffer_splat(*args))
        split = op_split(lambda args=args: kz.zbuffer_splat(*args))
        bound_ms = bound(splat_bytes(n, hits[what]), OPS_ZBUFFER * n)[0]
        print(f"[8 rectify] B8 zbuffer_splat {H}x{W} on the {what} input: "
              f"bit-exact to plain; {live} live splats, {hits[what]} hit "
              f"targets, {live / max(hits[what], 1):.4f} splats a hit "
              f"target; {ms[what]:.4f} ms, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms[what]:.1f} % of it reached); "
              f"device ops a call (torch.profiler, 20 calls): "
              + "; ".join(f"{name} x{count:g} {op_ms:.4f} ms"
                          for name, (count, op_ms) in split.items()),
              flush=True)
    if save_b8:
        torch.save({k: [a.cpu() for a in v] for k, v in inputs.items()},
                   save_b8)
    # Back to back, with no synchronisation between: a key left behind by
    # the first call would show in the second.
    a, b = inputs["castle"], inputs["e2e"]
    first = kz.zbuffer_splat(*a)
    second = kz.zbuffer_splat(*b)
    for got, args, what in ((first, a, "castle"), (second, b, "e2e")):
        check(splat_exact(got, args),
              f"B8 back to back: the {what} call bit-exact to plain")

    args = inputs["e2e"]
    gs_k, _ = kz.zbuffer_splat(*args)
    gs_p, _ = kz.zbuffer_splat_plain(*args)
    # Yardstick (never called by the port): the packed24 engine's conflict
    # resolution, key packing and its scatter_reduce_, on the same splats.
    flat, d = kz.splat_targets(*args[:3])
    colors = image.reshape(n, 3)
    rec = record(float(torch.max(torch.abs(gs_k - gs_p))), ms["e2e"],
                 time_ms(lambda: kz.zbuffer_splat_plain(*args)),
                 splat_bytes(n, hits["e2e"]), OPS_ZBUFFER * n)
    # The bound as first counted, with every source's colour read: 37
    # bytes a pixel.
    bound37_ms = bound(37 * n, OPS_ZBUFFER * n)[0]
    packed24_ms = time_ms(lambda: _resolve_packed24(flat, d, colors, n,
                                                    image))
    # Library yardstick of the min stage only: one scatter_reduce_ "amin"
    # of B8's packed (depth, source id) keys, as int64, into the targets.
    keys = packed_keys(d)
    zbuf = torch.full((n + 1,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    zbuf.scatter_reduce_(0, flat, keys, "amin")
    check(torch.equal(zbuf[:n].reshape(H, W)
                      != torch.iinfo(torch.int64).max, bp.scattered),
          "B8 scatter_reduce_ amin of the packed keys hits B8's targets")
    rec["library_ms"] = time_ms(
        lambda: zbuf.scatter_reduce_(0, flat, keys, "amin"))
    print(f"[8 rectify] B8 zbuffer_splat {H}x{W} on the e2e input: "
          f"{rec['ms']:.4f} ms vs plain {rec['plain_ms']:.3f} ms, packed24 "
          f"resolve {packed24_ms:.4f} ms, scatter_reduce_ amin of the packed "
          f"keys (min stage only) {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}"
          f" % of it reached; at 37 bytes a pixel {bound37_ms:.4f} ms, "
          f"{100 * bound37_ms / rec['ms']:.1f} %)", flush=True)

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


def stress_scene_data(dev, name):
    """(i1, i2, true depth, poses_r, poses_t, mover share) of one STRESS.md
    scene: rendered at full HD in float64 on the card, the images and
    truth cast to float32 (scripts/stress_fullhd.py:60-90,
    scripts/render_mesh_scene.py); the photometric scene's frame 2 with
    exposure 1.35, vignette 0.35 and noise 0.005 from a torch generator."""
    import torch

    from rs_sfm_tpu_torch.data import synthetic as syn
    from rs_sfm_tpu_torch.data.dataset import true_depth_from_unprojection
    from rs_sfm_tpu_torch.eval.gate import PHOTOMETRIC, V_TRUE, W_TRUE

    f64 = torch.float64
    make = {"stress": syn.stress_scene, "mesh": syn.castle_mesh_scene}.get(
        name, syn.castle_scene)
    pair = syn.render_pair(make(f64, dev), syn.default_intrinsics(H, W), H, W,
                           gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE, dtype=f64)
    f1 = pair.frame1
    td = true_depth_from_unprojection(f1.rs_unproject, f1.poses_r,
                                      f1.poses_t)
    i1 = f1.rs_image.to(torch.float32)
    i2 = pair.frame2.rs_image.to(torch.float32)
    if name == "castle_photo":
        i2 = syn.apply_photometric(
            i2, torch.Generator(device=dev).manual_seed(1), **PHOTOMETRIC)
    return (i1, i2, td.to(torch.float32), f1.poses_r.to(torch.float32),
            f1.poses_t.to(torch.float32),
            float(f1.mover_mask.float().mean()))


def stress_row(errs):
    """The protocol's numbers of one scene and configuration."""
    import numpy as np

    ev = errs.error_v_vec
    return {"err_v_mean": float(np.mean(ev)), "err_v_med": float(np.median(ev)),
            "err_v_p90": float(np.percentile(ev, 90)),
            "wrong_basin": int(np.sum(ev > WRONG_BASIN)),
            "err_w_mean": float(np.mean(errs.error_w_vec)),
            "err3d_mean": float(np.nanmean(errs.error_reproject_vec)),
            "err3d_med": float(np.nanmedian(errs.error_reproject_vec)),
            "depth_rmse_mean": float(np.nanmean(errs.depth_rmse_vec)),
            "depth_rmse_med": float(np.nanmedian(errs.depth_rmse_vec))}


def refine_engine_ms(flow, mask, intr, draws):
    """ms per LM iteration of the "xla" refinement (solver/refine.py) and
    of the fused one (B3 at J = 4, B2 at J = 1) on one full-HD flow: the
    production estimation's RANSAC top-4 starts (E2E_CONFIG's scoring on
    `draws`), 8 iterations a call, Huber 3 px; CUDA events, median of 5."""
    from rs_sfm_tpu_torch.config import E2E_CONFIG as cfg
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import _score_hypotheses, ransac
    from rs_sfm_tpu_torch.solver.refine import refine
    from rs_sfm_tpu_torch.solver.refine_fused import (refine_pallas,
                                                      refine_pallas_multi)

    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        flow, intr, GAMMA, cfg)
    valid = valid & mask.reshape(-1)
    rr = ransac(coords, flow_n, alpha, alpha_k, valid, use_k=False,
                trials=cfg.ransac_trials, tolerance=cfg.ransac_tol,
                sample_indices=draws, engine="pallas",
                top_j=cfg.refine_starts,
                top_j_diversity=cfg.refine_start_diversity)
    _, _, rho, inl = _score_hypotheses(coords, flow_n, alpha, alpha_k, valid,
                                       rr.top_v, rr.top_w, rr.top_k,
                                       cfg.ransac_tol)
    iters = 8
    kw = dict(optimize_k=False, iterations=iters, rel_tol=0.0,
              loss_delta=cfg.refine_loss_delta_px / math.sqrt(intr.fx
                                                              * intr.fy))
    px = (coords, flow_n, alpha, alpha_k)
    four = (inl, rr.top_v, rr.top_w, rr.top_k, rho)
    one = tuple(t[0] for t in four)
    calls = {"xla J=4": lambda: refine(*px, *four, **kw),
             "fused B3 J=4": lambda: refine_pallas_multi(*px, *four, **kw),
             "xla J=1": lambda: refine(*px, *one, **kw),
             "fused B2 J=1": lambda: refine_pallas(*px, *one, **kw)}
    return {name: time_ms(fn, runs=5, warmup=1) / iters
            for name, fn in calls.items()}


def phase_stress(dev, n_evals):
    """The STRESS.md protocol on the card (ROADMAP A2.4): per scene, its
    flow (flow_forward_backward with its preset on the kernel engines) and
    n_evals evaluations of fb2_final ("xla" engines as written: B1 and
    solver/refine.py's LM) and of E2E_CONFIG (B1-B3) on the same draws;
    gates on the fb2_final medians."""
    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, PipelineConfig
    from rs_sfm_tpu_torch.data.dataset import FrameData, PairData
    from rs_sfm_tpu_torch.data.synthetic import default_intrinsics
    from rs_sfm_tpu_torch.eval.gate import V_TRUE, W_TRUE
    from rs_sfm_tpu_torch.eval.harness import (evaluate_velocities_batched,
                                               evaluation_generators)
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.models import get_flow_preset
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    fb2 = PipelineConfig(**FULLHD_EST_CFG)
    configs = {"fb2_final": fb2, "E2E_CONFIG": E2E_CONFIG}
    intr = default_intrinsics(H, W)
    wrap = reset_counts()
    t_phase = time.perf_counter()
    rows, timing_input = {}, None
    for label, preset in STRESS_PRESETS.items():
        t0 = time.perf_counter()
        i1, i2, td, pr, pt, movers = stress_scene_data(dev, label)
        torch.cuda.synchronize()
        t_render = time.perf_counter() - t0
        t0 = time.perf_counter()
        flow_cfg = get_flow_preset(preset, warp_engine="pallas",
                                   sor_engine="pallas")
        fb = flow_forward_backward(i1, i2, flow_cfg)
        mask = ~fb.occlusion
        torch.cuda.synchronize()
        t_flow = time.perf_counter() - t0
        valid = prepare_flow_inputs(fb.flow, intr, GAMMA, fb2)[4] & \
            mask.reshape(-1)
        draws = torch.stack([
            sample_valid_indices(g, valid, fb2.ransac_trials)
            for g in evaluation_generators(STRESS_SEED, n_evals, dev)])
        frame = FrameData(rs_image=i1, gs_image=None, depth_image=None,
                          poses_r=pr, poses_t=pt, rs_unproject=None,
                          gs_unproject=None)
        pair = PairData(frame1=frame, frame2=None, intrinsics=intr,
                        gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE)
        print(f"[9 stress] {label}: rendered (float64) in {t_render:.2f} s, "
              f"movers {movers:.4f} of frame 1; flow ({preset}) "
              f"{t_flow:.2f} s, occluded "
              f"{float(fb.occlusion.float().mean()):.4f}", flush=True)
        for cname, cfg in configs.items():
            b1 = wrap["score_hypotheses"].launches
            t0 = time.perf_counter()
            errs = evaluate_velocities_batched(
                pair, cfg, gamma=GAMMA, num_evaluations=n_evals,
                dtype=torch.float32, flow_px=fb.flow, true_depth=td,
                pixel_mask=mask, sample_indices=draws)
            seconds = time.perf_counter() - t0
            check(wrap["score_hypotheses"].launches - b1 >= n_evals,
                  f"{label} {cname}: B1 scored every evaluation")
            row = stress_row(errs)
            rows[(label, cname)] = row
            print(f"[9 stress] {label} {cname} (N={n_evals}, {seconds:.2f} s"
                  f", {1e3 * seconds / n_evals:.1f} ms an evaluation): "
                  + " ".join(f"{k}={v:.4g}" for k, v in row.items()),
                  flush=True)
            for key in ("err_v_mean", "err_w_mean", "err3d_mean",
                        "depth_rmse_mean"):
                check(math.isfinite(row[key]), f"{label} {cname}: {key}")
        tpu = dict(zip(("err_v_mean", "err_v_med", "err_v_p90", "err_w_mean",
                        "err3d_mean", "depth_rmse_mean"),
                       STRESS_TPU_ROWS[label]))
        print(f"[9 stress] {label} STRESS.md fb2_final (TPU v5e, 50 "
              f"evaluations, accuracy only): "
              + " ".join(f"{k}={v:.4g}" for k, v in tpu.items()), flush=True)
        if label == "castle_clean":
            timing_input = (fb.flow, mask, draws[0])
    counts = {k: fn.launches for k, fn in wrap.items()}
    print(f"[9 stress] {len(STRESS_PRESETS)} scenes in "
          f"{time.perf_counter() - t_phase:.1f} s; launches {counts}",
          flush=True)
    for kname in ("score_hypotheses", "lm_iter", "lm_iter_multi", "warp",
                  "match_search", "sor_sweeps", "median3_planes"):
        check(counts[kname] > 0, f"phase 9 launched {kname}")
    for label, gates in STRESS_GATES.items():
        row = rows[(label, "fb2_final")]
        for key, gate in gates.items():
            got = row[f"{key}_med"]
            check(got <= gate, f"stress {label}: median {key} {got} <= {gate}")
    print("[9 stress] gates held on the fb2_final medians: "
          + "; ".join(f"{label} " + " ".join(
              f"{k} {rows[(label, 'fb2_final')][k + '_med']:.4g} <= {g}"
              for k, g in gates.items())
              for label, gates in STRESS_GATES.items())
          + f"; stress err_v median beside twice STRESS.md's (TPU warp "
          f"clamp, printed only): {rows[('stress', 'fb2_final')]['err_v_med']:.4g}"
          f" vs {2 * STRESS_TPU_ROWS['stress'][1]:.4g}", flush=True)
    ms = refine_engine_ms(*timing_input[:2], intr, timing_input[2])
    print("[9 stress] LM ms per iteration on the castle_clean flow "
          "(E2E_CONFIG's top-4 starts, 8 iterations a call, CUDA events): "
          + " ".join(f"{k}={v:.3f}" for k, v in ms.items()), flush=True)


def accel_configs():
    """Phase 11's estimations on the true flow, case: configuration: (a)
    E2E_CONFIG (B1, B3, B2), (b) the castle gate's EST_CFG as written (the
    "xla" engines), (c) (a) with RANSAC's prescore; all with the
    acceleration model."""
    import dataclasses

    from rs_sfm_tpu_torch.config import E2E_CONFIG, PipelineConfig

    prod = dataclasses.replace(E2E_CONFIG, use_acceleration=True)
    return {"a E2E_CONFIG": prod,
            "b EST_CFG": PipelineConfig(**FULLHD_EST_CFG,
                                        use_acceleration=True),
            "c prescore": dataclasses.replace(prod, **ACCEL_PRESCORE)}


def accel_errors(res):
    """{err_v, err_w, k, k_err, inliers} of an estimate of the castle's
    motion (eval/metrics: the angle of v to the truth, the rotation
    error)."""
    from rs_sfm_tpu_torch.eval.gate import V_TRUE, W_TRUE
    from rs_sfm_tpu_torch.eval.metrics import (rotation_error,
                                               translation_error)

    k = float(res.k)
    return {"err_v": float(translation_error(res.v.double(), V_TRUE)),
            "err_w": float(rotation_error(res.w.double(), W_TRUE)),
            "k": k, "k_err": abs(k - ACCEL_K),
            "inliers": int(res.num_inliers)}


def accel_estimate(flow, intr, cfg, generator=None, sample_indices=None):
    """(estimate_with_feedback's result, its pass 1 run again with stage
    marks on the same draws, {stage: ms} of that run (CUDA events; empty on
    the CPU))."""
    from rs_sfm_tpu_torch.solver.pipeline import (estimate_from_flow,
                                                  estimate_with_feedback)

    state = None if generator is None else generator.get_state()
    res = estimate_with_feedback(flow, intr, GAMMA, cfg, generator,
                                 sample_indices=sample_indices)
    if state is not None:
        generator.set_state(state)
    if not flow.is_cuda:
        return res, estimate_from_flow(flow, intr, GAMMA, cfg, generator,
                                       sample_indices=sample_indices), {}
    mark, read = stage_marks()
    first = estimate_from_flow(flow, intr, GAMMA, cfg, generator,
                               sample_indices=sample_indices, timer=mark)
    return res, first, read()


def show(values):
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in values.items())


def accel_cpu_check(npz="build/accel_gate_jax.npz"):
    """Phase 11's three estimations on the CPU, on the flow and RANSAC draws
    that scripts/accel_gate_jax.py saved (the castle with k 0.8, 270x480 by
    default), beside the JAX package's values from the same draws for
    EST_CFG and for EST_CFG with the prescore.  Run from the repository
    root:
        python3 -c "import runpy; runpy.run_path('chip_smoke.py')
                    ['accel_cpu_check']()"
    """
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from rs_sfm_tpu_torch.data.synthetic import default_intrinsics

    torch.set_num_threads(4)
    saved = np.load(npz)
    flow = torch.from_numpy(saved["flow"])
    intr = default_intrinsics(*flow.shape[:2])
    # The JAX rows: EST_CFG with the acceleration model, and with the
    # prescore (the "xla" engines; the kernels' Pallas engines are not run).
    jax_rows = {"b EST_CFG": "est_cfg", "c prescore": "prescore"}
    for case, cfg in accel_configs().items():
        t0 = time.perf_counter()
        res, first, _ = accel_estimate(flow, intr, cfg,
                                       sample_indices=saved["draws"])
        got = accel_errors(res)
        line = f"[11 accel, CPU] {case} {tuple(flow.shape[:2])}: {show(got)}"
        if case in jax_rows:
            line += "; JAX " + show({k: float(saved[f"{jax_rows[case]}_{k}"])
                                     for k in got})
        print(line + f"; picked v={first.ransac_v.numpy()} "
              f"k={float(first.ransac_k):.6g}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def sharded_cpu_check(npz="build/sharded_gate_jax.npz"):
    """The port's sharded estimation over 2 gloo ranks on the CPU with the
    configuration of tests/test_parallel.py::test_sharded_full_features,
    on the flow that scripts/sharded_gate_jax.py saved, beside the JAX
    package's sharded (8 shards) and unsharded estimates from that script.
    The pools and draws differ (torch's against jax.random's), so v is
    compared as a direction and w as that test compares the JAX sharded
    and unsharded runs.  Run from the repository root:
        python3 -c "import runpy; runpy.run_path('chip_smoke.py')
                    ['sharded_cpu_check']()"
    """
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from rs_sfm_tpu_torch.config import PipelineConfig
    from rs_sfm_tpu_torch.data.synthetic import default_intrinsics
    from rs_sfm_tpu_torch.parallel.launch import spawn

    saved = np.load(npz)
    flow = torch.from_numpy(saved["flow"])
    intr = default_intrinsics(*flow.shape[:2])
    cfg = PipelineConfig(ransac_trials=64, ransac_tol=0.01,
                         refine_iterations=20, refine_starts=2,
                         use_acceleration=True, k_scan_points=9,
                         ransac_prescore_subsample=256,
                         ransac_prescore_keep=8, ransac_sample_pool=256)
    draws, _ = pool_draws(flow, intr, cfg, 2, seed=3)
    t0 = time.perf_counter()
    got = spawn(sharded_rank, 2, saved["flow"], intr, draws, "cpu", cfg)[0]
    seconds = time.perf_counter() - t0

    def angle(a, b):
        a, b = unit(np.asarray(a, np.float64)), unit(np.asarray(b,
                                                               np.float64))
        return float(np.arccos(np.clip(abs(a @ b), -1.0, 1.0)))

    print(f"[sharded, CPU] port over 2 gloo ranks: v={got['v']} w={got['w']}"
          f" k={float(got['k']):.6g} inliers={got['num_inliers']} "
          f"({seconds:.1f} s)", flush=True)
    for name in ("sharded", "unsharded"):
        v, w = saved[f"{name}_v"], saved[f"{name}_w"]
        print(f"[sharded, CPU] JAX {name}: v={v} w={w} k="
              f"{float(saved[f'{name}_k']):.6g} inliers="
              f"{int(saved[f'{name}_num_inliers'])}; port - JAX: v angle "
              f"{angle(got['v'], v):.3e} (the JAX test's 2e-3), w diff "
              f"{np.linalg.norm(got['w'] - w):.3e} (1e-4), k diff "
              f"{abs(float(got['k']) - float(saved[f'{name}_k'])):.3e}",
              flush=True)


def phase_accel(dev, truth):
    """The acceleration model at full HD on the card (see the module
    docstring) on `truth`, the castle rendered with k 0.8 (phase 7);
    returns {kernel: its record at the acceleration model's shapes} for
    B1, B2 and B3."""
    import dataclasses

    import torch

    from rs_sfm_tpu_torch.config import E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.eval.gate import production_gate
    from rs_sfm_tpu_torch.ops.kernels import score as sk
    from rs_sfm_tpu_torch.solver.kscan import k_scan
    from rs_sfm_tpu_torch.solver.minimal import calculate_velocities_all_k
    from rs_sfm_tpu_torch.solver.pipeline import prepare_flow_inputs
    from rs_sfm_tpu_torch.solver.ransac import (_score_hypotheses, ransac,
                                                sample_valid_indices)

    t_phase = time.perf_counter()
    intr, flow = truth.intr, truth.gt_flow
    cases = accel_configs()
    firsts = {}
    for case, cfg in cases.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        accel_estimate(flow, intr, cfg, gen)  # warm-up
        torch.cuda.synchronize()
        wrap = reset_counts()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        res, first, stages = accel_estimate(flow, intr, cfg, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {k: fn.launches for k, fn in wrap.items()}
        # The estimation with its feedback passes, then pass 1 again.
        first_only = estimation_launches(dataclasses.replace(
            cfg, feedback_passes=0))
        expect = {k: c + first_only[k]
                  for k, c in estimation_launches(cfg).items()}
        got = {k: counts[k] for k in expect}
        firsts[case] = first
        errs = accel_errors(res)
        print(f"[11 accel] {case} {W}x{H} (true flow, k {ACCEL_K}): "
              f"{show(errs)}; gates {ACCEL_GATES}; picked v="
              f"{first.ransac_v.cpu().numpy()} w={first.ransac_w.cpu().numpy()}"
              f" k={float(first.ransac_k):.6g}", flush=True)
        print(f"[11 accel] {case} pass 1 ms (CUDA events): "
              + " ".join(f"{k}={v:.2f}" for k, v in stages.items())
              + f" total={sum(stages.values()):.2f}; estimate_with_feedback "
              f"and pass 1 again {wall:.1f} ms host wall; launches {got}",
              flush=True)
        for field in ("v", "w", "k", "depth_map", "refine_cost"):
            check(bool(torch.isfinite(getattr(res, field)).all()),
                  f"accel {case}: {field} finite")
        for key, gate in ACCEL_GATES.items():
            check(errs[key] < gate, f"accel {case}: {key} {errs[key]} < "
                  f"{gate}")
        check(got == expect, f"accel {case}: launches {got} == {expect}")
    # The device kernels of one production estimation (a).
    gen = torch.Generator(device=dev).manual_seed(0)
    n_kernels, busy, wall, top, _ = profile_pass(lambda: accel_estimate(
        flow, intr, cases["a E2E_CONFIG"], gen)[0])
    print(f"[11 accel] torch.profiler over (a) and its pass 1 again: "
          f"{n_kernels} device kernels, busy {busy:.2f} ms of {wall:.2f} ms "
          f"traced; most called operators: "
          + ", ".join(f"{name} {calls}" for name, calls in top), flush=True)

    # (d) B1 on (a)'s all-k hypotheses (its seed-0 draws), invalid root
    # slots included.
    cfg = cases["a E2E_CONFIG"]
    coords, flow_n, alpha, alpha_k, valid = prepare_flow_inputs(
        flow, intr, GAMMA, cfg)
    n = coords.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = sample_valid_indices(gen, valid, cfg.ransac_trials)
    f64 = torch.float64
    w6, v6, k6, ok6 = calculate_velocities_all_k(
        coords[idx].to(f64), flow_n[idx].to(f64), alpha[idx].to(f64),
        alpha_k[idx].to(f64))
    ok6 = ok6.reshape(-1)
    v_all = torch.where(ok6[:, None], v6.reshape(-1, 3), 0.0)
    w_all = torch.where(ok6[:, None], w6.reshape(-1, 3), 0.0)
    k_all = k6.reshape(-1)
    px = sk.pack_pixels(coords, flow_n, alpha, alpha_k, valid)
    hy = sk.pack_hyps(v_all, w_all, k_all)
    tol = cfg.ransac_tol
    num_k, err_k = sk.score_hypotheses(px, hy, tol)
    num_p, err_p = sk.score_hypotheses_plain(px, hy, tol)
    torch.cuda.synchronize()
    check(torch.equal(num_k, num_p), "B1 all-k inlier counts equal to plain")
    check(torch.allclose(err_k, err_p, rtol=1e-5, atol=0.0),
          "B1 all-k error sums within rtol 1e-5 of plain")
    t = hy.shape[0]
    n_valid = int((px[6] > 0.5).sum())
    rec = record(float(torch.max(torch.abs(err_k - err_p))),
                 time_ms(lambda: sk.score_hypotheses(px, hy, tol)),
                 time_ms(lambda: sk.score_hypotheses_plain(px, hy, tol)),
                 4 * (px.numel() + hy.numel() + 2 * t),
                 OPS_SCORE * n_valid * t + OPS_SCORE_PIXEL * n_valid)
    print(f"[11 accel] B1 score_hypotheses all-k N={n} ({n_valid} valid) "
          f"T={t} ({int((~ok6).sum())} invalid root slots, k in "
          f"[{float(k_all[ok6].min()):.3g}, {float(k_all[ok6].max()):.3g}]):"
          f" counts equal (best {int(num_k.max())}), error sums max abs diff "
          f"{rec['max_abs_err']:.3e}; {rec['ms']:.3f} ms vs plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms",
          flush=True)
    # B2 and B3 with k free from the seeds (a)'s pass 1 gives them: RANSAC's
    # diversity top-4 of these draws, their inlier sets, through the
    # k-scan.  (A spurious root's start left off the scan can run k off to
    # 1e9 along a flat valley, where two summation orders part.)
    rr = ransac(coords, flow_n, alpha, alpha_k, valid, use_k=True,
                trials=cfg.ransac_trials, tolerance=tol, sample_indices=idx,
                engine=cfg.ransac_engine, top_j=cfg.refine_starts,
                top_j_diversity=cfg.refine_start_diversity)
    _, _, rho_j, inl_j = _score_hypotheses(
        coords, flow_n, alpha, alpha_k, valid, rr.top_v, rr.top_w, rr.top_k,
        tol)
    k_grid = torch.linspace(cfg.k_scan_min, cfg.k_scan_max,
                            cfg.k_scan_points, dtype=coords.dtype, device=dev)
    v0, w0, k0, rho0, _ = k_scan(coords, flow_n, alpha, alpha_k, inl_j,
                                 rr.top_v, rr.top_w, k_grid,
                                 iters=cfg.k_scan_iters)
    print(f"[11 accel] B2/B3 seeds: RANSAC's top-{cfg.refine_starts} k "
          f"{rr.top_k.cpu().numpy()}, after the k-scan {k0.cpu().numpy()}",
          flush=True)
    loss_delta = cfg.refine_loss_delta_px / math.sqrt(intr.fx * intr.fy)
    lm = {}
    for j in (1, 4):
        lm[j] = check_lm("[11 accel]", coords, flow_n, alpha, alpha_k,
                         v0[:j], w0[:j], k0[:j], inl_j[:j], rho0[:j],
                         loss_delta, optimize_k=True)[0]

    # (e) The clean castle through dense flow and the production
    # estimation with the acceleration model: no gate yet.
    wrap = reset_counts()
    mark, read = stage_marks()
    got = production_gate(truth, truth.i2, E2E_FLOW_PRESET, cfg,
                          torch.Generator(device=dev).manual_seed(0),
                          timer=mark)
    stages = read()
    counts = {k: fn.launches for k, fn in wrap.items()}
    print(f"[11 accel] dense flow (E2E_FLOW_PRESET), E2E_CONFIG with the "
          f"acceleration model, k {ACCEL_K}: {show(got)} (no gate); ms "
          + " ".join(f"{k}={v:.2f}" for k, v in stages.items())
          + f"; launches {counts}", flush=True)
    check(all(math.isfinite(v) for v in got.values()),
          "accel dense flow: finite values")
    for kname in ("score_hypotheses", "lm_iter", "lm_iter_multi", "warp",
                  "match_search", "sor_sweeps", "median3_planes"):
        check(counts[kname] > 0, f"accel dense flow launched {kname}")
    print(f"[11 accel] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"score_hypotheses": rec, "lm_iter": lm[1],
            "lm_iter_multi": lm[4]}


def phase_cli(dev, castle, castle_photo):
    """The CLI in process on the card (cli.main) in build/cli_smoke:
    generate, single-run on the GT flow (also with --acceleration and with
    --flow-model auto) and on the dense flow with the occlusion mask and
    the feedback passes, generate-sweep, sweep and test-flow, at 600x600;
    checks the files they write and the gates.  Then the auto preset's
    probe on phase 6b's full-HD clean and photometric castle pairs
    (`castle`'s frames, `castle_photo` its photometric frame 2)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from rs_sfm_tpu_torch import cli
    from rs_sfm_tpu_torch.data import png
    from rs_sfm_tpu_torch.eval.metrics import rotation_error, translation_error

    work = ROOT / "build" / "cli_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    wrap = reset_counts()

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main([str(a) for a in argv] + ["--device", str(dev)])
        torch.cuda.synchronize()
        text = buf.getvalue()
        tail = " | ".join(text.strip().splitlines()[-3:])
        print(f"[10 cli] {argv[0]} ({time.perf_counter() - t0:.1f} s): "
              f"{tail}", flush=True)
        return text

    def estimate_errors(ds, out, text):
        est = json.loads((out / "estimate.json").read_text())
        f64 = dict(dtype=torch.float64)
        v_true = torch.tensor(np.loadtxt(ds / "v.csv", delimiter=","), **f64)
        w_true = torch.tensor(np.loadtxt(ds / "w.csv", delimiter=","), **f64)
        return {"err_w": float(rotation_error(torch.tensor(est["w"], **f64),
                                              w_true)),
                "err_v": float(translation_error(
                    torch.tensor(est["v"], **f64), v_true)),
                "reprojection": float(text.split(
                    "mean reprojection error:")[1].split()[0])}

    def check_single_run(out):
        for name in ("optical_flow.png", "optical_flow_arrow.png",
                     "MinimalDepth.png", "backprojection.png",
                     "error_image.png", "gs_image.png", "difference.png",
                     "remainder.png", "overlay_gs_rs.png",
                     "overlay_gs_bp.png"):
            img = png.read(str(out / name))
            check(img.shape[:2] == (CLI_SIZE, CLI_SIZE), f"cli {out.name}: "
                  f"{name} {img.shape}")
        depth = png.read(str(out / "MinimalDepth.png"))
        check(float((depth > 0).mean()) > 0.2,
              f"cli {out.name}: depth PNG covers > 0.2 of the pixels")
        ply = (out / "point_cloud.ply").read_text().splitlines()
        check(ply[0] == "ply" and int(ply[2].split()[-1]) == len(ply) - 10
              > 0.2 * CLI_SIZE ** 2, f"cli {out.name}: point_cloud.ply")

    ds = work / "ds"
    run("generate", "--out", ds, "--size", CLI_SIZE)
    check((ds / "images" / "1_rs.png").exists()
          and (ds / "images" / "2_rs_unproject_z.csv").exists()
          and (ds / "v.csv").exists(), "cli generate: the dataset layout")
    gt = work / "gt"
    text = run("single-run", "--data", ds, "--out", gt)
    check_single_run(gt)
    errs = estimate_errors(ds, gt, text)
    for key, gate in CLI_GT_GATES.items():
        check(errs[key] < gate, f"cli single-run (GT flow): {key} "
              f"{errs[key]} < {gate}")
    accel = work / "accel"
    text = run("single-run", "--data", ds, "--out", accel, "--acceleration")
    check_single_run(accel)
    accel_errs = estimate_errors(ds, accel, text)
    accel_errs["k"] = json.loads((accel / "estimate.json").read_text())["k"]
    for key, gate in CLI_GT_GATES.items():
        check(accel_errs[key] < gate, f"cli single-run --acceleration (GT "
              f"flow): {key} {accel_errs[key]} < {gate}")
    auto = work / "auto"
    text = run("single-run", "--data", ds, "--out", auto, "--flow-model",
               "auto")
    auto_lines = [line for line in text.splitlines()
                  if line.startswith("flow model auto -> ")]
    check(auto_lines == ["flow model auto -> variational"],
          f"cli single-run --flow-model auto: {auto_lines}")
    deep = work / "deep"
    text = run("single-run", "--data", ds, "--out", deep, "--deep-flow",
               "--occlusion-mask", "--model-feedback")
    check_single_run(deep)
    deep_errs = estimate_errors(ds, deep, text)
    check(deep_errs["err_v"] < CLI_DEEP_ERR_V, f"cli single-run --deep-flow:"
          f" err_v {deep_errs['err_v']} < {CLI_DEEP_ERR_V}")
    sw = work / "sweep"
    run("generate-sweep", "--out", sw, "--size", CLI_SIZE, "--gammas",
        "0.5,0.9")
    tasks = (sw / "tasks.txt").read_text().split()
    run("sweep", "--path", sw, "--num-evaluations", 2)
    (res,) = (sw / "results").iterdir()
    lines = (res / "errors.csv").read_text().splitlines()
    check(lines[0] == "task,error_w,error_v,reproject_error"
          and [r.split(",")[0] for r in lines[1:]] == tasks,
          f"cli sweep: errors.csv rows {lines}")
    sweep_errs = [dict(zip(("err_w", "err_v", "reprojection"),
                           map(float, r.split(",")[1:]))) for r in lines[1:]]
    for row in sweep_errs:
        for key, gate in CLI_GT_GATES.items():
            check(row[key] < gate, f"cli sweep: {key} {row[key]} < {gate}")
    check(json.loads((res / "progress.json").read_text())["done"]
          == sorted(tasks), "cli sweep: progress.json lists every task")
    for i in range(len(tasks)):
        for run_i in range(2):
            check((res / "depthMaps" / str(i) / f"depth_{run_i}.png").exists()
                  and (res / "depthMaps" / str(i)
                       / f"point_cloud_{run_i}.ply").exists(),
                  f"cli sweep: task {i} run {run_i} depth PNG and PLY")
    text = run("test-flow", "--data", ds)
    verdicts = [line.split()[0] + " " + line.split()[-1]
                for line in text.splitlines()]
    check(verdicts == ["true OK", "dense OK"], f"cli test-flow: {verdicts}")
    counts = {k: fn.launches for k, fn in wrap.items()}
    for kname in ("score_hypotheses", "warp", "match_search", "sor_sweeps",
                  "median3_planes"):
        check(counts[kname] > 0, f"phase 10 launched {kname}")
    # data/png.py's reader on a full-HD RGB frame, every row with one filter
    # (photo writers mostly pick Paeth): host seconds, median of 3.
    frame = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    read_s = {}
    for name, row_filter in (("up", 2), ("average", 3), ("paeth", 4)):
        blob = png.encode(frame, row_filter=row_filter)
        check(np.array_equal(png.decode(blob), frame), f"png {name} round trip")
        read_s[name] = wall_ms(lambda: png.decode(blob), runs=3,
                               warmup=0) / 1e3
    print(f"[10 cli] {CLI_SIZE}x{CLI_SIZE}: GT flow "
          + " ".join(f"{k}={v:.4g}" for k, v in errs.items())
          + f" (gates {CLI_GT_GATES}); --acceleration on the GT flow "
          + " ".join(f"{k}={v:.4g}" for k, v in accel_errs.items())
          + "; dense flow "
          + " ".join(f"{k}={v:.4g}" for k, v in deep_errs.items())
          + f" (err_v gate {CLI_DEEP_ERR_V}); sweep "
          + "; ".join(" ".join(f"{k}={v:.4g}" for k, v in r.items())
                      for r in sweep_errs)
          + f"; test-flow {verdicts}; --flow-model auto: {auto_lines[0]};"
          f" launches {counts}; png.read of a "
          f"{W}x{H} RGB frame (host s): "
          + " ".join(f"{k}={v:.3f}" for k, v in read_s.items()), flush=True)
    shutil.rmtree(work, ignore_errors=True)

    # The auto preset's probe (flow/auto.py: 1/8 scale, B4-B6) on the
    # full-HD castle pairs of phase 6b: tests/test_fullhd_flow.py's gate
    # wants variational on the clean pair and robust on the photometric one.
    from rs_sfm_tpu_torch.flow.auto import probe_flow_preset

    for case, i2, want in (("clean", castle.i2, "variational"),
                           ("photometric", castle_photo, "robust")):
        wrap = reset_counts()
        name, stats = probe_flow_preset(castle.i1, i2, return_stats=True)
        counts = {k: wrap[k].launches for k in ("warp", "match_search",
                                                "sor_sweeps",
                                                "median3_planes")}
        ms = wall_ms(lambda: probe_flow_preset(castle.i1, i2), runs=5)
        print(f"[10 cli] auto probe, {case} castle {W}x{H} (probed at "
              f"1/8 scale): {name} (want {want}); "
              + " ".join(f"{k}={v:.5f}" for k, v in stats.items())
              + f"; {ms:.2f} ms host wall (median of 5); launches {counts}",
              flush=True)
        check(name == want, f"auto probe {case}: {name} == {want}")
        check(all(c > 0 for c in counts.values()),
              f"auto probe {case}: B4-B6 launched {counts}")


def relock_launches(res, flow_cfg, est_cfg, h, w, limits):
    """Kernel launches of one flow_with_relock call at (h, w): one flow
    pass and the estimation, or when the relock fired two flow passes, the
    five shift estimations and the final one."""
    import dataclasses

    flow = flow_launches(flow_cfg, h, w, limits)
    est = estimation_launches(est_cfg)
    if res.shift is None:
        return {k: flow.get(k, 0) + est.get(k, 0)
                for k in set(flow) | set(est)}
    score_cfg = dataclasses.replace(
        est_cfg, ransac_trials=min(est_cfg.ransac_trials, 128),
        refine_starts=1, refine_iterations=8, feedback_passes=0)
    score = estimation_launches(score_cfg)
    keys = set(flow) | set(est) | set(score)
    return {k: 2 * flow.get(k, 0) + 5 * score.get(k, 0) + est.get(k, 0)
            for k in keys}


def phase_relock(dev, castle):
    """The relock pass (flow/relock.py): (a) phase 6b's clean castle, (b)
    the repetitive-texture castle at full HD, (c) the repetitive-texture
    castle at 135x240 on the card and on the CPU (see the module
    docstring)."""
    import numpy as np
    import torch

    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.data.synthetic import repetitive_scene
    from rs_sfm_tpu_torch.eval.gate import (castle_truth, gate_metrics,
                                            V_TRUE)
    from rs_sfm_tpu_torch.eval.metrics import translation_error
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward
    from rs_sfm_tpu_torch.flow.relock import flow_with_relock
    from rs_sfm_tpu_torch.ops.kernels.sor import card_limits
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback
    from rs_sfm_tpu_torch.solver.ransac import sample_valid_indices

    limits = card_limits(dev)

    def relock(truth, force, gen_seed=0):
        wrap = reset_counts()
        mark, read = stage_marks()
        res = flow_with_relock(truth.i1, truth.i2, E2E_FLOW_PRESET,
                               truth.intr, GAMMA, E2E_CONFIG,
                               torch.Generator(device=dev).manual_seed(
                                   gen_seed), force=force, timer=mark)
        stages = read()
        counts = {k: fn.launches for k, fn in wrap.items()}
        expect = relock_launches(res, E2E_FLOW_PRESET, E2E_CONFIG, H, W,
                                 limits)
        for kname, n in expect.items():
            check(counts[kname] == n, f"relock launches {kname} "
                  f"{counts[kname]} == {n}")
        return res, stages, counts

    def show(res):
        return (f"ambiguous {float(res.ambiguous_frac):.4f}, fired "
                f"{res.shift is not None}, n {res.shift}, p_hat "
                + ("-" if res.period is None
                   else np.array2string(res.period.cpu().numpy(),
                                        precision=4)))

    # (a) The clean castle: the relock must not hurt it.
    t0 = time.perf_counter()
    res, stages, counts = relock(castle, force=True)
    got = gate_metrics(castle, res.fb.flow, res.result)
    gates = CASTLE_GATES["clean"][1]
    print(f"[12 relock] (a) clean castle {W}x{H}, force=True: {show(res)}; "
          + " ".join(f"{k}={got[k]:.4f} (gate {g})" for k, g in gates.items())
          + "; ms " + " ".join(f"{k}={v:.2f}" for k, v in stages.items())
          + f"; launches {counts}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    for k, gate in gates.items():
        check(got[k] <= gate, f"relock clean castle: {k} {got[k]} <= {gate}")

    # (b) The repetitive-texture castle at full HD (reptex): ungated.
    t0 = time.perf_counter()
    rep = castle_truth(H, W, dev, scene=repetitive_scene(torch.float32, dev))
    moving = torch.linalg.vector_norm(rep.gt_flow, dim=-1) > 0

    def epe(flow):
        d = torch.linalg.vector_norm(flow - rep.gt_flow, dim=-1)[moving]
        return float(torch.quantile(d.double(), 0.5))

    fb1 = flow_forward_backward(rep.i1, rep.i2, E2E_FLOW_PRESET)
    single = estimate_with_feedback(
        fb1.flow, rep.intr, GAMMA, E2E_CONFIG,
        torch.Generator(device=dev).manual_seed(0), pixel_mask=~fb1.occlusion)
    res, stages, counts = relock(rep, force=False)
    print(f"[12 relock] (b) repetitive castle {W}x{H} (STRESS.md reptex: "
          f"38.8 px, 1.98 rad through a single pass; ungated): {show(res)}; "
          f"pass 1 EPE median {epe(fb1.flow):.3f} px err_v "
          f"{float(translation_error(single.v, V_TRUE)):.4f}; winning shift "
          f"err_v {float(translation_error(res.first_pass.v, V_TRUE)):.4f}; "
          f"relocked EPE median {epe(res.fb.flow):.3f} px err_v "
          f"{float(translation_error(res.result.v, V_TRUE)):.4f}; ms "
          + " ".join(f"{k}={v:.2f}" for k, v in stages.items())
          + f"; launches {counts}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    for f in ("v", "w", "k"):
        check(bool(torch.isfinite(getattr(res.result, f)).all()),
              f"relock repetitive castle: {f} finite")

    # (c) 135x240, card against CPU, the same draws on each stage.
    h, w = RELOCK_PARITY_SIZE

    def draws(stage, valid):
        seed = 1 + sum(d * 1000 ** i for i, d in enumerate(stage))
        return sample_valid_indices(
            torch.Generator().manual_seed(seed), valid.cpu(),
            E2E_CONFIG.ransac_trials if stage == (7,)
            else min(E2E_CONFIG.ransac_trials, 128)).to(valid.device)

    for name, scene in (("clean", None),
                        ("repetitive", repetitive_scene(torch.float64,
                                                        "cpu"))):
        t0 = time.perf_counter()
        small = castle_truth(h, w, "cpu", scene=scene)
        out = []
        for where in (dev, torch.device("cpu")):
            wrap = reset_counts()
            out.append(flow_with_relock(
                small.i1.to(where), small.i2.to(where), E2E_FLOW_PRESET,
                small.intr, GAMMA, E2E_CONFIG, force=True,
                sample_indices=draws))
            if where.type == "cuda":
                check(wrap["match_search"].launches > 0,
                      "relock on the card launched match_search")
        g, c = out
        # The second pass from the CPU's prior on the card.
        fb2 = flow_forward_backward(small.i1.to(dev), small.i2.to(dev),
                                    E2E_FLOW_PRESET, prior=c.prior.to(dev))
        same_flow2 = torch.equal(fb2.flow.cpu(), c.fb.flow)
        same_p = torch.equal(g.period.cpu(), c.period)
        errs = []
        for tag, rg, rc in (("winning shift", g.first_pass, c.first_pass),
                            ("final", g.result, c.result)):
            vg, vc = unit(rg.v.cpu().numpy()), unit(rc.v.numpy())
            errs.append((tag, float(np.max(np.abs(vg * np.sign(vg @ vc)
                                                  - vc))),
                         float(np.max(np.abs(rg.w.cpu().numpy()
                                             - rc.w.numpy()))),
                         int(rg.num_inliers), int(rc.num_inliers)))
        d = torch.linalg.norm(g.fb.flow.cpu() - c.fb.flow, dim=-1)
        print(f"[12 relock] (c) {name} castle {w}x{h}, card vs CPU, force="
              f"True, the same draws: card {show(g)}; CPU {show(c)}; p_hat "
              f"bit-exact {same_p}; second pass from the CPU's prior "
              f"bit-exact {same_flow2}; second-pass flows |diff| median "
              f"{float(d.median()):.3e} max {float(d.max()):.3e} px; "
              + "; ".join(f"{tag}: v diff {dv:.3e} w diff {dw:.3e} inliers "
                          f"{ng} vs {nc}" for tag, dv, dw, ng, nc in errs)
              + f"; {time.perf_counter() - t0:.1f} s", flush=True)
        check(g.shift == c.shift, f"relock {name} {h}x{w}: the same "
              f"winning shift ({g.shift} vs {c.shift})")
        check(same_p and torch.equal(g.ambiguous_frac.cpu(),
                                     c.ambiguous_frac),
              f"relock {name} {h}x{w}: ambiguity and p_hat bit-exact")
        check(same_flow2, f"relock {name} {h}x{w}: the second pass from one "
              "prior bit-exact")
        if name == "clean":
            # The final motion within phase 5's gates (the winning shift's
            # 8 unconverged iterations are printed only).
            _, dv, dw, _, _ = errs[1]
            check(dv <= E2E_GATES["v_direction"] and dw <= E2E_GATES["w"],
                  f"relock clean {h}x{w}: v diff {dv}, w diff {dw} within "
                  "gates")


def phase_pseudo_real(dev):
    """tests/test_real_ingestion.py's gate on the card: its full-HD castle
    pair with the camera-pipeline nuisances as 8-bit PNGs through the
    port's `single-run` (robust flow, occlusion mask, tol 0.02, 4 starts);
    then each of the four nuisances on one full-HD frame on the card
    against the CPU."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from rs_sfm_tpu_torch import cli
    from rs_sfm_tpu_torch.data import png
    from rs_sfm_tpu_torch.data.intrinsics import REGISTRY
    from rs_sfm_tpu_torch.data.synthetic import (apply_photometric,
                                                 castle_scene, jpeg_levels,
                                                 render_pair)
    from rs_sfm_tpu_torch.eval.metrics import translation_error

    t0 = time.perf_counter()
    work = ROOT / "build" / "pseudo_real"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pair = render_pair(castle_scene(torch.float32, dev),
                       REGISTRY[PSEUDO_REAL["camera"]], H, W, gamma=GAMMA,
                       k=0.0, v=PSEUDO_REAL["v"], w=PSEUDO_REAL["w"],
                       dtype=torch.float32)
    frames = []
    for i, (frame, opts) in enumerate(zip((pair.frame1, pair.frame2),
                                          PSEUDO_REAL_FRAMES)):
        img = apply_photometric(frame.rs_image, torch.Generator(
            device=dev).manual_seed(2 + i), **opts)
        frames.append(img)
        png.write(str(work / f"frame{i + 1}.png"), np.clip(np.round(
            img.cpu().numpy() * 255), 0, 255).astype(np.uint8))
    prep_s = time.perf_counter() - t0
    wrap = reset_counts()
    out = work / "results"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["single-run", "--data", str(work), "--camera",
                  PSEUDO_REAL["camera"], "--out", str(out), "--flow-model",
                  "robust", "--occlusion-mask", "--ransac-tol", "0.02",
                  "--refine-starts", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrap.items()}
    est = json.loads((out / "estimate.json").read_text())
    err_v = float(translation_error(torch.tensor(est["v"], dtype=torch.float64),
                                    PSEUDO_REAL["v"]))
    share = est["num_inliers"] / (H * W)
    arts = sorted(p.name for p in out.iterdir())
    ply = (out / "point_cloud.ply").stat().st_size
    print(f"[13 pseudo-real] {W}x{H} castle, {PSEUDO_REAL['camera']}, "
          f"demosaic + JPEG 82 (+ exposure, vignette, 3 px streak on frame "
          f"2), 8-bit PNGs ({prep_s:.1f} s), single-run --flow-model robust "
          f"--occlusion-mask --ransac-tol 0.02 --refine-starts 4 "
          f"({run_s:.1f} s): err_v {err_v:.4f} (gate {PSEUDO_REAL['err_v']}),"
          f" inliers {est['num_inliers']} = {share:.4f} of pixels (gate > "
          f"{PSEUDO_REAL['inlier_share']}); point_cloud.ply {ply} bytes; "
          f"launches {counts}; "
          + " | ".join(buf.getvalue().strip().splitlines()[-4:]), flush=True)
    check(err_v <= PSEUDO_REAL["err_v"], f"pseudo-real err_v {err_v}")
    check(share > PSEUDO_REAL["inlier_share"], f"pseudo-real inliers {share}")
    for name in ("optical_flow.png", "MinimalDepth.png", "backprojection.png",
                 "point_cloud.ply"):
        check(name in arts, f"pseudo-real: {name} written")
    check(ply > 1e6, f"pseudo-real: point cloud of {ply} bytes")
    # The CLI's estimation runs the JAX default engines ("xla" LM; B1
    # scores RANSAC on the card).
    for kname in ("score_hypotheses", "warp", "match_search", "sor_sweeps",
                  "median3_planes"):
        check(counts[kname] > 0, f"pseudo-real launched {kname}")
    shutil.rmtree(work, ignore_errors=True)

    # Each nuisance on frame 1, card against CPU (float32, no noise).
    frame = pair.frame1.rs_image
    frame_c = frame.cpu()
    rows = []
    for name, opts in NUISANCES.items():
        got = apply_photometric(frame, **opts)
        ms = wall_ms(lambda: apply_photometric(frame, **opts), runs=5)
        ref = apply_photometric(frame_c, **opts)
        diff = float(torch.abs(got.cpu() - ref).max())
        row = f"{name} max |card - CPU| {diff:.3e}, {ms:.2f} ms"
        if name == "jpeg":
            lg = jpeg_levels(frame, opts["jpeg_quality"])[0].cpu()
            lc = jpeg_levels(frame_c, opts["jpeg_quality"])[0]
            flips = int((lg != lc).sum())
            row += f", {flips} of {lc.numel()} coefficients rounded apart"
            check(flips <= 1e-5 * lc.numel(), f"JPEG levels apart: {flips}")
        rows.append(row)
        check(diff <= NUISANCE_ATOL, f"nuisance {name} card vs CPU {diff}")
    print(f"[13 pseudo-real] nuisances on the {W}x{H} frame, card vs CPU "
          f"(float32; DCT without matmul, so no TF32): " + "; ".join(rows),
          flush=True)


def phase_video(dev, castle):
    """Video (video.py, video_ckpt.py) on phase 6b's full-HD castle frames
    [frame 1, frame 2, frame 2]: dense flow per pair, the estimation per
    pair with fault isolation, the trajectory, checkpointed windows with a
    resume (see the module docstring)."""
    import shutil

    import torch

    from rs_sfm_tpu_torch.config import ESTIMATION_CONFIG
    from rs_sfm_tpu_torch.eval.gate import V_TRUE
    from rs_sfm_tpu_torch.eval.metrics import translation_error
    from rs_sfm_tpu_torch.models import get_flow_preset
    from rs_sfm_tpu_torch.video import (VideoResult, accumulate_trajectory,
                                        estimate_video, pair_flows_dense)
    from rs_sfm_tpu_torch.video_ckpt import process_video_checkpointed

    t0 = time.perf_counter()
    wrap = reset_counts()
    frames = torch.stack([castle.i1, castle.i2, castle.i2])
    flows = pair_flows_dense(frames, get_flow_preset(
        "variational", warp_engine="pallas", sor_engine="pallas"))
    intr, cfg = castle.intr, ESTIMATION_CONFIG
    res = estimate_video(flows, intr, GAMMA, cfg,
                         torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in wrap.items()}
    ok = res.ok.cpu().tolist()
    err_v = float(translation_error(res.v[0], V_TRUE))
    rot, t = accumulate_trajectory(res, GAMMA, H)
    gate = CASTLE_GATES["clean"][1]["err_v"]
    print(f"[14 video] {W}x{H} castle frames [1, 2, 2]: pair flows max |f| "
          f"{float(flows[0].abs().max()):.2f} / {float(flows[1].abs().max()):.2e}"
          f" px; ok {ok}; pair 0 err_v {err_v:.4f} (gate {gate}), inliers "
          f"{res.num_inliers.cpu().tolist()}; trajectory t "
          f"{t.cpu().numpy().round(4).tolist()}; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(ok == [True, False], f"video ok {ok}")
    check(err_v <= gate, f"video pair 0 err_v {err_v}")
    for f in ("v", "w", "k", "depth_maps"):
        check(not bool(torch.any(getattr(res, f)[1] != 0)),
              f"video pair 1 {f} zero")
    check(torch.equal(rot[2], rot[1]) and torch.equal(t[2], t[1]),
          "video: pose held across pair 1")
    for kname in ("score_hypotheses", "lm_iter_multi", "warp", "match_search",
                  "sor_sweeps", "median3_planes"):
        check(counts[kname] > 0, f"video launched {kname}")

    # Checkpointed windows of one pair; a resume after window 1's file is
    # lost restores window 0 and recomputes window 1 alone.
    for save_depth in (True, False):
        t0 = time.perf_counter()
        ckpt = ROOT / "build" / "video_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)

        def run():
            gen = torch.Generator(device=dev).manual_seed(1)
            with record_passes() as est:
                got = process_video_checkpointed(
                    flows, intr, GAMMA, cfg, gen, ckpt_dir=str(ckpt),
                    window=1, save_depth=save_depth)
            return got, len(est)

        first, n1 = run()
        (ckpt / "window_000001.npz").unlink()
        second, n2 = run()
        third, n3 = run()
        same = all(torch.equal(getattr(first, f), getattr(second, f))
                   and torch.equal(getattr(first, f), getattr(third, f))
                   for f in VideoResult._fields)
        size = sum(p.stat().st_size for p in ckpt.iterdir())
        print(f"[14 video] checkpointed, window 1, save_depth={save_depth}: "
              f"estimations {n1}, after losing window 1 {n2}, all restored "
              f"{n3}; results equal to the first run's {same}; checkpoints "
              f"{size} bytes; {time.perf_counter() - t0:.1f} s", flush=True)
        check((n1, n2, n3) == (2, 1, 0), f"video estimations {(n1, n2, n3)}")
        check(same, "video: resumed results equal the first run's")
        shutil.rmtree(ckpt, ignore_errors=True)


def check_census_sor(i1, i2):
    """B5 with the census term at each level of the e2e pyramid: phase 3's
    SOR inputs (the full-HD planes linearised around the preset's flow)
    with the census planes of the same warp, subsampled to each level's
    shape; the wrapper (csrc/sor.cu on the plan without census, the census
    planes read from global memory) bit-exact to the plain version, with
    its launches, and timed beside the call without census.  Returns the
    full-HD level's record with every level's timings."""
    import torch

    from rs_sfm_tpu_torch.config import E2E_FLOW_PRESET as fc
    from rs_sfm_tpu_torch.flow.dense import _census_channels, census_planes
    from rs_sfm_tpu_torch.ops.kernels import sor as ks
    from rs_sfm_tpu_torch.ops.kernels.warp import warp_plain

    coef, u0, v0, prm = sor_inputs(i1, i2)
    f0 = torch.stack([u0, v0], dim=-1)
    census = census_planes(_census_channels(i1, fc.census_sigma),
                           warp_plain(i2, f0), f0,
                           fc.census_sigma).contiguous()
    cprm = dict(prm, census_weight=1.0)
    limits = ks.card_limits(u0.device)
    levels, full = [], None
    for step in (1, 2, 4, 8, 16, 32, 64):
        c = coef[:, ::step, ::step].contiguous()
        cen = census[:, ::step, ::step].contiguous()
        u, v = u0[::step, ::step].contiguous(), v0[::step, ::step].contiguous()
        h, w = u.shape
        up, vp = ks.sor_sweeps_plain(c, u, v, census=cen, **cprm)
        before = ks.sor_sweeps.census_launches
        uk, vk = ks.sor_sweeps(c, u, v, census=cen, **cprm)
        torch.cuda.synchronize()
        launches = ks.sor_sweeps.census_launches - before
        check(launches == ks.launches_per_call(h, w, prm["iters"], limits),
              f"B5 census {h}x{w}: {launches} launches")
        check(torch.equal(uk, up) and torch.equal(vk, vp),
              f"B5 census {h}x{w} bit-exact to plain")
        check(not torch.equal(up, ks.sor_sweeps_plain(c, u, v, **prm)[0]),
              f"B5 census {h}x{w}: the census term moved the solve")
        n = h * w
        b_ms, b_by = bound(4 * (8 + ks.CENSUS_PLANES + 2 + 2) * n,
                           (OPS_SOR + OPS_SOR_CENSUS) * n * prm["iters"])
        plan = ks.tile_plan(h, w, prm["iters"], limits)
        row = {"shape": [h, w], "bound_ms": b_ms, "bound_by": b_by,
               "plan": list(plan), "launches": launches,
               "ms": time_ms(lambda: ks.sor_sweeps(c, u, v, census=cen,
                                                   **cprm)),
               "ms_without_census": time_ms(lambda: ks.sor_sweeps(
                   c, u, v, **prm))}
        print(f"[15 a10] (a) B5 census {h}x{w}, {prm['iters']} sweeps: "
              f"bit-exact to plain; {plan[0]}x{plan[1]} K={plan[3]} "
              f"{row['ms']:.4f} ms ({launches}); without census "
              f"{row['ms_without_census']:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        if full is None:
            full = record(
                max(float(torch.max(torch.abs(uk - up))),
                    float(torch.max(torch.abs(vk - vp)))),
                row["ms"],
                time_ms(lambda: ks.sor_sweeps_plain(c, u, v, census=cen,
                                                    **cprm), runs=3,
                        warmup=1),
                4 * (8 + ks.CENSUS_PLANES + 2 + 2) * n,
                (OPS_SOR + OPS_SOR_CENSUS) * n * prm["iters"])
            full.update(shape=[h, w], launches_per_call=launches)
            print(f"[15 a10] (a) B5 census {h}x{w} through the wrapper: "
                  f"{full['ms']:.3f} ms vs plain {full['plain_ms']:.1f} ms, "
                  f"bound {full['bound_ms']:.4f} ms ({full['bound_by']}), "
                  f"{launches} launches a call", flush=True)
        levels.append(row)
    full["levels"] = levels
    return full


def check_shifted_searches(i1, i2):
    """B4's search in its shifted mode at SHIFTED_SEARCHES, radius 4:
    frame 2's matching plane warped once by the flow (B4's warp), then the
    search, with and without a prior (a smooth random field 3 px about the
    flow), bit-exact to the plain version through the wrapper and on every
    tile; ms beside the exact refine's on the same flow.  The flows are the
    e2e pass's at 34x60 and 68x120 and a smooth random field (3 px) at
    17x30, which the pass searches coarsely."""
    import torch

    from rs_sfm_tpu_torch.ops.kernels import match as km
    from rs_sfm_tpu_torch.ops.kernels import warp as kw

    calls = {}
    for args in e2e_searches(i1, i2):
        # A refine's planes and flow where the pass refines at the shape.
        key = tuple(args[0].shape)
        if key not in calls or calls[key][2] is None:
            calls[key] = args
    limits = km.card_limits(i1.device)
    rows = []
    for h, w in SHIFTED_SEARCHES:
        check((h, w) in calls, f"the e2e pass searches {h}x{w}")
        i1m, i2m, flow = calls[(h, w)][:3]
        dev = i1m.device
        if flow is None:
            flow = _smooth_field(h, w, dev, h, 3.0)
        warped = kw.warp(i2m, flow)
        prior = _smooth_field(h, w, dev, w, 3.0) + flow
        for name, pr in (("without a prior", None), ("with a prior", prior)):
            args = (i1m, warped, flow, 4, 0.0, None, pr)
            ref = km.match_search_plain(*args, shifted=True)
            before = km.match_search.shifted_launches
            got = km.match_search(*args, shifted=True)
            torch.cuda.synchronize()
            check(km.match_search.shifted_launches == before + 1,
                  f"match_search {h}x{w} shifted: one launch")
            check(all(same_bits(g, r) for g, r in zip(got, ref)),
                  f"match_search {h}x{w} shifted {name} bit-exact")
            for tile in range(len(km.TILES)):
                if km.smem_bytes(tile, 4) > limits[1]:
                    continue
                res = km.match_launch(*args[:6], tile, pr, shifted=True)
                torch.cuda.synchronize()
                check(all(same_bits(g, r) for g, r in zip(res, ref)),
                      f"match_search {h}x{w} shifted {name} tile {tile}")
        n, k = h * w, 81
        ms = time_ms(lambda: km.match_search(i1m, warped, flow, 4,
                                             shifted=True))
        ms_prior = time_ms(lambda: km.match_search(
            i1m, warped, flow, 4, prior=prior, shifted=True))
        ms_exact = time_ms(lambda: km.match_search(i1m, i2m, flow, 4))
        ms_warp = time_ms(lambda: kw.warp(i2m, flow))
        plain_ms = time_ms(lambda: km.match_search_plain(
            i1m, warped, flow, 4, shifted=True), runs=5, warmup=1)
        b_ms, b_by = bound(n * (4 + 4 + 8 + 8 + 8 + 1),
                           OPS_MATCH_SHIFTED * k * n)
        bp_ms, _ = bound(n * (4 + 4 + 8 + 8 + 8 + 8 + 1),
                         (OPS_MATCH_SHIFTED + OPS_MATCH_PRIOR) * k * n)
        rows.append({"shape": [h, w], "candidates": k, "ms": ms,
                     "ms_with_prior": ms_prior, "ms_exact_refine": ms_exact,
                     "ms_warp": ms_warp, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_ms_with_prior": bp_ms})
        print(f"[15 a10] (b) B4 match_search {h}x{w} shifted K={k}: "
              f"bit-exact to plain with and without a prior, every tile; "
              f"{ms:.4f} ms (with a prior {ms_prior:.4f}) + its warp "
              f"{ms_warp:.4f} ms vs the exact refine {ms_exact:.4f} ms; "
              f"plain {plain_ms:.2f} ms; bound {b_ms:.6f} ms ({b_by}), with "
              f"a prior {bp_ms:.6f}", flush=True)
    return rows


def census_epe(i1, i2, gt, limits):
    """tests/test_stress.py's census comparison on the pair (i1, i2):
    flow_forward_backward with DenseFlowConfig() and with census_weight
    1.0, the mean EPE against `gt` over each flow's unoccluded pixels;
    each flow's launches asserted from its configuration, the census
    term's launches all of B5's with census.  Returns {name: EPE}, and
    {name: (ms, occluded share)}."""
    import torch

    from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
    from rs_sfm_tpu_torch.flow.dense import flow_forward_backward

    h, w = gt.shape[:2]
    epe, info = {}, {}
    for name, cfg in (("plain", DenseFlowConfig()),
                      ("census", DenseFlowConfig(census_weight=1.0))):
        wrap = reset_counts()
        t0 = time.perf_counter()
        fb = flow_forward_backward(i1, i2, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: wrap[k].launches for k in ("warp", "match_search",
                                                "sor_sweeps",
                                                "median3_planes")}
        expect = flow_launches(cfg, h, w, limits)
        check(counts == expect, f"census {name} {h}x{w}: launches {counts} "
              f"== {expect}")
        census_l = wrap["sor_sweeps"].census_launches
        check(census_l == (counts["sor_sweeps"] if name == "census" else 0),
              f"census {name} {h}x{w}: {census_l} census launches")
        use = ~fb.occlusion
        epe[name] = float(torch.linalg.vector_norm(fb.flow - gt, dim=-1)[use]
                          .mean())
        info[name] = (ms, float(fb.occlusion.float().mean()))
    return epe, info


def phase_a10(dev, castle, castle_photo):
    """The A10 flow options: (a) B5 with the census term and (b) B4's
    shifted search against their plain versions; (c) the census term end
    to end: tests/test_stress.py's census gates on its own 128x128 scene
    and on phase 6b's full-HD photometric castle pair, then the CLI's
    single-run --flow-model census on a full-HD castle pair with those
    nuisances (galaxy_stabil intrinsics, 8-bit PNGs); (d) the clean castle
    through E2E_FLOW_PRESET with refine_shifted and E2E_CONFIG at the
    clean gates.  Returns {"census": B5's record, "shifted": B4's rows}."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from rs_sfm_tpu_torch import cli
    from rs_sfm_tpu_torch.config import E2E_CONFIG, E2E_FLOW_PRESET
    from rs_sfm_tpu_torch.data import png
    from rs_sfm_tpu_torch.data.intrinsics import REGISTRY
    from rs_sfm_tpu_torch.data.synthetic import (apply_photometric,
                                                 castle_scene,
                                                 default_intrinsics,
                                                 render_pair)
    from rs_sfm_tpu_torch.eval.gate import (PHOTOMETRIC, V_TRUE, W_TRUE,
                                            production_gate)
    from rs_sfm_tpu_torch.eval.metrics import translation_error
    from rs_sfm_tpu_torch.flow.true_flow import true_flow
    from rs_sfm_tpu_torch.ops.kernels.sor import card_limits

    t_phase = time.perf_counter()
    limits = card_limits(dev)
    _, i1, i2, _ = e2e_inputs(dev)
    out = {"census": check_census_sor(i1, i2),
           "shifted": check_shifted_searches(i1, i2)}

    # (c) The census gates: first on tests/test_stress.py's own scene,
    # rendered on the card in float64 as the test renders it.
    size = CENSUS_TEST_SCENE["size"]
    intr = default_intrinsics(size, size)
    pair = render_pair(castle_scene(torch.float64, dev), intr, size, size,
                       gamma=GAMMA, k=0.0, v=CENSUS_TEST_SCENE["v"],
                       w=CENSUS_TEST_SCENE["w"], dtype=torch.float64)
    gt = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                   pair.frame2.poses_t, intr).float()
    i2n = apply_photometric(pair.frame2.rs_image.float(), torch.Generator(
        device=dev).manual_seed(1), **PHOTOMETRIC)
    failed = []
    for scene, (a, b, g), epe_gated in (
            (f"tests/test_stress.py's {size}x{size} castle",
             (pair.frame1.rs_image.float(), i2n, gt), True),
            (f"phase 6b's {W}x{H} photometric castle",
             (castle.i1, castle_photo, castle.gt_flow), False)):
        epe, info = census_epe(a, b, g, limits)
        ratio = epe["census"] / epe["plain"]
        print(f"[15 a10] (c) census on {scene}: mean EPE over unoccluded "
              f"pixels {epe['census']:.4f} px ("
              + ("gate" if epe_gated else "not gated; the test's")
              + f" {CENSUS_GATES['epe']}) vs without census "
              f"{epe['plain']:.4f} px, ratio {ratio:.4f} (gate "
              f"{CENSUS_GATES['ratio']}); occluded {info['census'][1]:.4f} "
              f"/ {info['plain'][1]:.4f}; host {info['census'][0]:.1f} / "
              f"{info['plain'][0]:.1f} ms", flush=True)
        if not (ratio < CENSUS_GATES["ratio"] and (
                epe["census"] < CENSUS_GATES["epe"] or not epe_gated)):
            failed.append(f"census gates on {scene}: {epe}")

    # The CLI on a full-HD castle pair with the census nuisances.
    work = ROOT / "build" / "census_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cam = PSEUDO_REAL["camera"]
    pair = render_pair(castle_scene(torch.float32, dev), REGISTRY[cam], H,
                       W, gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                       dtype=torch.float32)
    frames = (pair.frame1.rs_image, apply_photometric(
        pair.frame2.rs_image, torch.Generator(device=dev).manual_seed(1),
        **PHOTOMETRIC))
    for i, img in enumerate(frames):
        png.write(str(work / f"frame{i + 1}.png"), np.clip(np.round(
            img.cpu().numpy() * 255), 0, 255).astype(np.uint8))
    wrap = reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["single-run", "--data", str(work), "--camera", cam,
                  "--out", str(work / "results"), "--flow-model", "census",
                  "--occlusion-mask", "--ransac-tol", "0.02",
                  "--refine-starts", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in wrap.items()}
    est = json.loads((work / "results" / "estimate.json").read_text())
    err_v = float(translation_error(torch.tensor(est["v"],
                                                 dtype=torch.float64),
                                    V_TRUE))
    census_l = wrap["sor_sweeps"].census_launches
    print(f"[15 a10] (c) cli single-run --flow-model census --occlusion-mask "
          f"on the {W}x{H} castle ({cam}) with those nuisances on frame 2 "
          f"({run_s:.1f} s): err_v {err_v:.4f} (not gated), inliers "
          f"{est['num_inliers']} = {est['num_inliers'] / (H * W):.4f} of "
          f"pixels; B5 census launches {census_l}; launches {counts}",
          flush=True)
    check(census_l == counts["sor_sweeps"] > 0,
          "the CLI's census flow ran B5's census term")
    check(counts["score_hypotheses"] > 0, "the CLI's census run launched B1")
    shutil.rmtree(work, ignore_errors=True)

    # (d) The clean castle through the shifted refine at the clean gates.
    flow_cfg = E2E_FLOW_PRESET._replace(refine_shifted=True)
    gates = CASTLE_GATES["clean"][1]
    wrap = reset_counts()
    mark, read = stage_marks()
    got = production_gate(castle, castle.i2, flow_cfg, E2E_CONFIG,
                          torch.Generator(device=dev).manual_seed(0),
                          timer=mark)
    stages = read()
    counts = {k: fn.launches for k, fn in wrap.items()}
    expect = {**flow_launches(flow_cfg, H, W, limits),
              **estimation_launches(E2E_CONFIG)}
    shifted = wrap["match_search"].shifted_launches
    print(f"[15 a10] (d) clean castle, E2E_FLOW_PRESET with refine_shifted, "
          f"E2E_CONFIG: "
          + " ".join(f"{k}={v:.4f}" + (f" (gate {gates[k]})" if k in gates
                                       else "") for k, v in got.items())
          + "; ms " + " ".join(f"{k}={v:.2f}" for k, v in stages.items())
          + f"; shifted searches {shifted}; launches {counts}", flush=True)
    check({k: counts[k] for k in expect} == expect,
          f"shifted castle launches {counts} == {expect}")
    # Every refine search was shifted (the coarse ones of the forward and
    # backward passes are not).
    check(shifted == counts["match_search"] - 2 > 0,
          f"shifted searches {shifted}")
    for k, gate in gates.items():
        check(got[k] <= gate, f"shifted castle: {k} {got[k]} <= {gate}")
    print(f"[15 a10] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check(not failed, "; ".join(failed))
    return out


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "NVIDIA GPU (see the module docstring).")
    ap.add_argument("--save-b8", default=None, metavar="PATH",
                    help="also save B8's two inputs, for time_b8")
    ap.add_argument("--stress-evals", type=int, default=STRESS_EVALS,
                    metavar="N", help="evaluations a scene and configuration "
                    f"in phase 9 (default {STRESS_EVALS}; 50 is STRESS.md's "
                    "protocol)")
    args = ap.parse_args()
    save_b8 = args.save_b8
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
    castle, castle_photo = phase_castle(dev)
    sharded, accel_truth = phase_sharded(dev)
    launches["lm_sums_multi"] = sharded["lm_sums_multi"]
    rect_launches, records["zbuffer_splat"] = phase_rectify(dev, e2e,
                                                              castle, save_b8)
    launches["zbuffer_splat"] = rect_launches["zbuffer_splat"]
    phase_stress(dev, args.stress_evals)
    phase_cli(dev, castle, castle_photo)
    for kname, rec in phase_accel(dev, accel_truth).items():
        # The acceleration model's shapes beside the main path's.
        records[kname].update({f"{key}_accel": rec[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms")})
    phase_relock(dev, castle)
    phase_pseudo_real(dev)
    phase_video(dev, castle)
    a10 = phase_a10(dev, castle, castle_photo)
    records["sor_sweeps"]["census"] = a10["census"]
    records["match_search"]["shifted"] = a10["shifted"]
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
