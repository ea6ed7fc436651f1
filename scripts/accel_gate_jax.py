"""The acceleration model's castle gate in the JAX package, on the CPU.

Renders the castle pair (float32) with gamma 0.9, k 0.8 and the castle
gate's motion (v (0.35, -0.15, 0.25), w (0.003, -0.002, 0.004)), takes its
true flow, and runs `estimate_with_feedback` with the full-HD gate's
estimation configuration (tests/test_fullhd_flow.py's EST_CFG, the "xla"
engines, 2 feedback passes) and the acceleration model, with and without
RANSAC's prescore (4096 pixels, keep 16).  Prints, per case, the angle of
v to the truth and the rotation error (eval/metrics.py), k, |k - 0.8| and
the inlier count beside tests/test_synthetic_consistency.py's acceleration
thresholds (|k - 0.8| < 0.2, angle < 0.05 rad), and saves the flow, the
RANSAC draws and the results to an .npz for the port's run on the same
draws (`chip_smoke.accel_cpu_check`).

    JAX_PLATFORMS=cpu python scripts/accel_gate_jax.py [--size 270x480]
        [--out build/accel_gate_jax.npz]

x64 is on, as in the tests, so RANSAC's minimal solver runs in float64.
"""

import argparse
import os
import time

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from rs_sfm_tpu.config import PipelineConfig  # noqa: E402
from rs_sfm_tpu.data.synthetic import (castle_scene,  # noqa: E402
                                       default_intrinsics, render_pair)
from rs_sfm_tpu.eval.metrics import (rotation_error,  # noqa: E402
                                     translation_error)
from rs_sfm_tpu.flow.true_flow import true_flow  # noqa: E402
from rs_sfm_tpu.solver.pipeline import (  # noqa: E402
    estimate_with_feedback, prepare_flow_inputs)
from rs_sfm_tpu.solver.ransac import sample_valid_indices  # noqa: E402

GAMMA = 0.9
K_TRUE = 0.8
V_TRUE = np.array([0.35, -0.15, 0.25])
W_TRUE = np.array([0.003, -0.002, 0.004])
GATES = {"k_err": 0.2, "err_v": 0.05}
EST_CFG = dict(ransac_trials=256, ransac_tol=0.02, refine_iterations=20,
               refine_starts=4, refine_winnow_iters=8, refine_rel_tol=0.0,
               depth_residual_px=2.0, refine_loss_delta_px=3.0,
               feedback_passes=2, feedback_mode="refine",
               feedback_refine_iterations=8, use_acceleration=True)
CASES = {"est_cfg": {}, "prescore": dict(ransac_prescore_subsample=4096,
                                         ransac_prescore_keep=16)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="270x480")
    ap.add_argument("--out", default="build/accel_gate_jax.npz")
    args = ap.parse_args()
    rows, cols = (int(x) for x in args.size.split("x"))
    intr = default_intrinsics(rows, cols)
    pair = render_pair(castle_scene(dtype=jnp.float32), intr, rows, cols,
                       gamma=GAMMA, k=K_TRUE, v=V_TRUE, w=W_TRUE,
                       dtype=jnp.float32)
    flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr)
    key = jax.random.PRNGKey(0)
    saved = {"flow": np.asarray(flow)}
    for name, extra in CASES.items():
        cfg = PipelineConfig(**EST_CFG, **extra)
        valid = prepare_flow_inputs(flow, intr, GAMMA, cfg)[4]
        saved["draws"] = np.asarray(sample_valid_indices(
            key, valid, cfg.ransac_trials))
        t0 = time.perf_counter()
        res = jax.block_until_ready(estimate_with_feedback(
            flow, intr, GAMMA, cfg, key))
        seconds = time.perf_counter() - t0
        got = {"err_v": float(translation_error(res.v, V_TRUE)),
               "err_w": float(rotation_error(res.w, W_TRUE)),
               "k": float(res.k), "k_err": abs(float(res.k) - K_TRUE),
               "inliers": int(res.num_inliers)}
        for field, value in got.items():
            saved[f"{name}_{field}"] = value
        verdict = all(got[g] < limit for g, limit in GATES.items())
        print(f"{name} {rows}x{cols}: " + " ".join(
            f"{k}={v:.6g}" for k, v in got.items())
            + f" (gates {GATES}: {'pass' if verdict else 'MISS'}); "
            f"{seconds:.1f} s with the compile", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **saved)
    print(f"saved {sorted(saved)} to {args.out}")


if __name__ == "__main__":
    main()
