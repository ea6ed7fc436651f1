"""The JAX package's sharded estimation with its full feature set, on the
CPU.

Runs `rs_sfm_tpu.parallel.api.estimate_sharded` with the configuration of
tests/test_parallel.py::test_sharded_full_features (the 64x64 castle, k 0,
gamma 0.9; 64 RANSAC trials, tol 0.01, 20 LM iterations, 2 starts, the
acceleration model with 9 k points, the prescore on 256 pixels keeping 8,
256 pool pixels a shard, the default "xla" engines) over a (1, 8) mesh of
8 virtual CPU devices, key 3, and the unsharded estimate_from_flow on the
same flow and key.  Prints v, w, k and the inlier count of both beside
that test's thresholds, and saves them with the flow to an .npz, for the
port's sharded run on the same flow (`chip_smoke.sharded_cpu_check`).

    JAX_PLATFORMS=cpu python scripts/sharded_gate_jax.py
        [--out build/sharded_gate_jax.npz]

x64 is on, as in the tests.
"""

import argparse
import os
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from rs_sfm_tpu.config import PipelineConfig  # noqa: E402
from rs_sfm_tpu.data.synthetic import (castle_scene,  # noqa: E402
                                       default_intrinsics, render_pair)
from rs_sfm_tpu.flow.true_flow import true_flow  # noqa: E402
from rs_sfm_tpu.parallel.api import estimate_sharded  # noqa: E402
from rs_sfm_tpu.parallel.mesh import make_mesh  # noqa: E402
from rs_sfm_tpu.solver.pipeline import estimate_from_flow  # noqa: E402

SIZE, GAMMA = 64, 0.9
V_TRUE = np.array([0.12, -0.05, 0.08])
W_TRUE = np.array([0.003, -0.002, 0.004])
CFG = dict(ransac_trials=64, ransac_tol=0.01, refine_iterations=20,
           refine_starts=2, use_acceleration=True, k_scan_points=9,
           ransac_prescore_subsample=256, ransac_prescore_keep=8)
POOL = 256


def angle(a, b):
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    return float(np.arccos(np.clip(abs(a @ b), -1.0, 1.0)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/sharded_gate_jax.npz")
    args = ap.parse_args()
    intr = default_intrinsics(SIZE, SIZE)
    pair = render_pair(castle_scene(dtype=jnp.float64), intr, SIZE, SIZE,
                       gamma=GAMMA, k=0.0, v=V_TRUE, w=W_TRUE,
                       dtype=jnp.float64)
    flow = true_flow(pair.frame1.rs_unproject, pair.frame2.poses_r,
                     pair.frame2.poses_t, intr)
    cfg = PipelineConfig(**CFG)
    key = jax.random.PRNGKey(3)
    saved = {"flow": np.asarray(flow)}
    mesh = make_mesh(pairs=1, pixels=8)
    runs = {"sharded": lambda: estimate_sharded(
                mesh, intr, GAMMA, cfg, pool_per_shard=POOL)(flow, key),
            "unsharded": lambda: estimate_from_flow(flow, intr, GAMMA, cfg,
                                                    key)}
    for name, run in runs.items():
        t0 = time.perf_counter()
        res = jax.block_until_ready(run())
        seconds = time.perf_counter() - t0
        for field in ("v", "w", "k", "num_inliers"):
            saved[f"{name}_{field}"] = np.asarray(getattr(res, field))
        print(f"{name}: v={np.asarray(res.v)} w={np.asarray(res.w)} "
              f"k={float(res.k):.6g} inliers={int(res.num_inliers)}/"
              f"{SIZE * SIZE}; v angle to the truth "
              f"{angle(res.v, V_TRUE):.6g} (< 0.05), |w - w_true| "
              f"{np.linalg.norm(np.asarray(res.w) - W_TRUE):.3e} (< 2e-3), "
              f"|k| {abs(float(res.k)):.3e} (< 0.3); {seconds:.1f} s "
              f"(compile included)", flush=True)
    print(f"sharded vs unsharded: v angle "
          f"{angle(saved['sharded_v'], saved['unsharded_v']):.3e}, w diff "
          f"{np.linalg.norm(saved['sharded_w'] - saved['unsharded_w']):.3e}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **saved)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
