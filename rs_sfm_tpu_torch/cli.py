"""Command-line interface of the port (port of rs_sfm_tpu/cli.py): the
reference's comment-toggled main() entry points (src/main.cc:133-142) as
subcommands, with the JAX CLI's flags, outputs and files.

  generate        render a synthetic RS dataset (the MATLAB generator's role)
  generate-sweep  render a parameter-sweep dataset grid + tasks.txt
  single-run      end-to-end single pair + artifacts (evaluateSingleRun,
                  src/main.cc:302-559)
  sweep           task-list evaluation harness + result CSVs, --resume
                  (evaluateParameterSweep, src/main.cc:148-299)
  test-flow       flow warp self-check (testFlow, src/main.cc:563-609)

`--device` (default cuda) picks where everything runs; without a CUDA
device `--device cuda` raises rather than falling back to the CPU.
`--x64` runs the solver in float64 (the dense flow and the fused kernels
stay float32).  `--warp-engine` / `--sor-engine` are accepted, and both of
their values run the port's flow kernels.  `--census-weight` and
`--flow-model census` run the census data term through the SOR kernel.

Examples:
  python -m rs_sfm_tpu_torch.cli generate --out /tmp/ds --size 128
  python -m rs_sfm_tpu_torch.cli single-run --data /tmp/ds --out /tmp/res
  python -m rs_sfm_tpu_torch.cli sweep --path /tmp/sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys



def _setup(args):
    """(device, dtype) of the run; a CUDA device must exist when asked."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           f"--device cpu to run on the CPU")
    return device, (torch.float64 if args.x64 else torch.float32)


def _add_common(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--x64", action="store_true",
                   help="float64 solver and renderer")


def _est_config(args):
    from rs_sfm_tpu_torch.config import PipelineConfig

    return PipelineConfig(
        ransac_trials=args.ransac_trials, ransac_tol=args.ransac_tol,
        use_acceleration=args.acceleration,
        use_global_shutter=args.global_shutter,
        use_refinement=not args.no_refinement,
        refine_starts=args.refine_starts)


def _flow_config(args, pair=None, device=None):
    """The flow preset of --flow-model; "auto" probes `pair`'s frames on
    `device` and prints the preset it resolved to."""
    from rs_sfm_tpu_torch.eval.harness import unit_image
    from rs_sfm_tpu_torch.models import resolve_flow_preset

    auto = args.flow_model == "auto"
    cfg, resolved = resolve_flow_preset(
        args.flow_model,
        unit_image(pair.frame1.rs_image, device) if auto else None,
        unit_image(pair.frame2.rs_image, device) if auto else None,
        warp_engine=args.warp_engine, sor_engine=args.sor_engine)
    if auto:
        print(f"flow model auto -> {resolved}")
    if args.census_weight is not None:
        cfg = cfg._replace(census_weight=args.census_weight)
    return cfg


def _render(args, device, dtype, gamma, k, v, w):
    from rs_sfm_tpu_torch.data.synthetic import (castle_scene,
                                                 default_intrinsics,
                                                 render_pair)

    intr = default_intrinsics(args.size, args.size)
    return render_pair(castle_scene(dtype, device), intr, args.size,
                       args.size, gamma=gamma, k=k, v=v, w=w, dtype=dtype)


def cmd_generate(args):
    from rs_sfm_tpu_torch.data.dataset import save_synthetic_pair

    device, dtype = _setup(args)
    v = [float(x) for x in args.v.split(",")]
    w_rot = [float(x) for x in args.w.split(",")]
    pair = _render(args, device, dtype, args.gamma, args.k, v, w_rot)
    prefix = save_synthetic_pair(pair, args.out)
    print(f"wrote dataset to {args.out} (images under {prefix})")


def cmd_generate_sweep(args):
    """One task directory per parameter combination + tasks.txt (the MATLAB
    castle.m sweep script, matlab_synthetic_data/castle.m:11-30)."""
    from rs_sfm_tpu_torch.data.dataset import save_synthetic_pair

    device, dtype = _setup(args)
    gammas = [float(x) for x in args.gammas.split(",")]
    ks = [float(x) for x in args.ks.split(",")]
    vs = [float(x) for x in args.vs.split(",")]
    ws = [float(x) for x in args.ws.split(",")]
    # Mean scene depth scaling of |v| (start_generating.m:56-58) with the
    # castle's ~6-unit mean depth.
    mean_depth = 6.0
    tasks = []
    for g in gammas:
        for k in ks:
            for vmag in vs:
                for wmag in ws:
                    name = f"g{g}_k{k}_v{vmag}_w{wmag}"
                    v_vec = [vmag * mean_depth, vmag * mean_depth, 0.0]
                    pair = _render(args, device, dtype, g, k, v_vec,
                                   [0.0, 0.0, wmag])
                    save_synthetic_pair(pair, os.path.join(args.out, name))
                    tasks.append(name)
                    print("rendered", name)
    with open(os.path.join(args.out, "tasks.txt"), "w") as f:
        f.write("\n".join(tasks) + "\n")
    print(f"{len(tasks)} task(s) under {args.out}")


def cmd_single_run(args):
    import torch

    from rs_sfm_tpu_torch.data import intrinsics as intr_registry
    from rs_sfm_tpu_torch.data.dataset import (load_real_pair,
                                               load_synthetic_pair)
    from rs_sfm_tpu_torch.eval import artifacts
    from rs_sfm_tpu_torch.eval.harness import (compute_flow, pair_true_depth,
                                               unit_image)
    from rs_sfm_tpu_torch.eval.metrics import mean_reprojection_error
    from rs_sfm_tpu_torch.flow.dense import as_device_tensor
    from rs_sfm_tpu_torch.geom.rspose import scanline_poses
    from rs_sfm_tpu_torch.rectify.backproject import backproject
    from rs_sfm_tpu_torch.rectify.crackfill import fill_cracks
    from rs_sfm_tpu_torch.solver.pipeline import estimate_with_feedback

    device, dtype = _setup(args)
    if args.camera:
        pair = load_real_pair(args.data, intr_registry.get(args.camera))
        use_flow = True
    else:
        pair = load_synthetic_pair(args.data)
        use_flow = args.deep_flow
    cfg = _est_config(args)
    gamma = args.gamma if args.gamma is not None else (pair.gamma or 0.9)
    flow_cfg = _flow_config(args, pair, device)
    pixel_mask = None
    if use_flow and args.occlusion_mask:
        from rs_sfm_tpu_torch.flow.dense import flow_forward_backward

        i1 = unit_image(pair.frame1.rs_image, device)
        fb = flow_forward_backward(
            i1, unit_image(pair.frame2.rs_image, device), flow_cfg)
        flow_px = fb.flow.to(dtype)
        pixel_mask = ~fb.occlusion
        print(f"occlusion-masked pixels: "
              f"{float(fb.occlusion.float().mean()):.1%}")
    else:
        flow_px = compute_flow(pair, use_flow, dtype=dtype,
                               flow_cfg=flow_cfg, device=device)
    if use_flow and args.model_feedback:
        # The model-feedback passes of the production setting
        # (flow/feedback.py): 2 passes of 8 warm-start iterations.
        cfg = dataclasses.replace(cfg, feedback_passes=2,
                                  feedback_refine_iterations=8)
    res = estimate_with_feedback(
        flow_px, pair.intrinsics, gamma, cfg,
        torch.Generator(device=device).manual_seed(args.seed),
        pixel_mask=pixel_mask)
    v, w = res.v.cpu().numpy(), res.w.cpu().numpy()
    print("num_inliers:", int(res.num_inliers))
    print("w:", w)
    print("v:", v)
    print("k:", float(res.k))

    h = flow_px.shape[0]
    r_sl, t_sl = scanline_poses(res.v, res.w, res.k, h, gamma, dtype=dtype)
    rs_img = as_device_tensor(pair.frame1.rs_image, device)
    rect = backproject(rs_img, res.depth_map, r_sl, t_sl, pair.intrinsics)
    gs = fill_cracks(fill_cracks(rect.gs_image, offset=1), offset=2)

    out_dir = args.out or os.path.join(args.data, "results")
    artifacts.save_single_run_artifacts(
        out_dir, flow_px=flow_px, rs_image=pair.frame1.rs_image,
        depth_map=res.depth_map, gs_image=gs, coords_3d=rect.coords_3d,
        valid=rect.valid)
    with open(os.path.join(out_dir, "estimate.json"), "w") as f:
        json.dump({"v": v.tolist(), "w": w.tolist(), "k": float(res.k),
                   "gamma": float(gamma),
                   "num_inliers": int(res.num_inliers)}, f, indent=1)
    print(f"artifacts written to {out_dir}")

    if pair.frame1.rs_unproject is not None:
        td = pair_true_depth(pair, device, dtype)
        err3d, scale, true3d = mean_reprojection_error(
            rect.coords_3d, rect.valid, td,
            as_device_tensor(pair.frame1.poses_r, device, dtype),
            as_device_tensor(pair.frame1.poses_t, device, dtype),
            pair.intrinsics)
        print("mean reprojection error:", float(err3d),
              " (scale", float(scale), ")")
        artifacts.imwrite(os.path.join(out_dir, "error_image.png"),
                          artifacts.error_image(rect.coords_3d, true3d,
                                                rect.valid))
        if pair.frame1.gs_image is not None:
            # The synthetic-only difference / remainder / overlay set
            # (reference src/main.cc:533-556).
            for name, img in artifacts.synthetic_eval_images(
                    pair.frame1.rs_image, pair.frame1.gs_image, gs).items():
                artifacts.imwrite(os.path.join(out_dir, name), img)


def cmd_sweep(args):
    from rs_sfm_tpu_torch.data.dataset import load_synthetic_pair
    from rs_sfm_tpu_torch.eval.harness import evaluate_velocities

    device, dtype = _setup(args)
    path = args.path
    with open(os.path.join(path, "tasks.txt")) as f:
        tasks = [line.strip() for line in f if line.strip()]

    # --resume continues an existing results dir, skipping the tasks its
    # progress file records.
    done: set = set()
    if args.resume:
        results_dir = args.resume
        progress_path = os.path.join(results_dir, "progress.json")
        if os.path.exists(progress_path):
            with open(progress_path) as f:
                done = set(json.load(f)["done"])
        print(f"resuming {results_dir}: {len(done)} task(s) already done")
    else:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        results_dir = os.path.join(path, "results", stamp)
    os.makedirs(results_dir, exist_ok=True)
    progress_path = os.path.join(results_dir, "progress.json")

    cfg = _est_config(args)
    with open(os.path.join(results_dir, "configuration"), "w") as f:
        f.write(f"ransac trials: {cfg.ransac_trials}\n"
                f"evaluation runs: {args.num_evaluations}\n"
                f"use deep flow: {int(args.deep_flow)}\n"
                f"use GS assumption: {int(cfg.use_global_shutter)}\n"
                f"use const acceleration: {int(cfg.use_acceleration)}\n"
                f"use refinement: {int(cfg.use_refinement)}\n"
                f"refine starts: {cfg.refine_starts}\n"
                + "-" * 46 + "\n" + "\n".join(tasks) + "\n")

    mode = "a" if args.resume else "w"
    files = {name: open(os.path.join(results_dir, name + ".csv"), mode)
             for name in ["w", "v", "k", "reproject_errors", "error_v",
                          "error_w"]}
    errors_f = open(os.path.join(results_dir, "errors.csv"), mode)
    if not args.resume:
        errors_f.write("task,error_w,error_v,reproject_error\n")
    for i, task in enumerate(tasks):
        if task in done:
            print(f"\nSkipping {task} (already done)")
            continue
        print(f"\nExecuting task {task}...")
        pair = load_synthetic_pair(os.path.join(path, task))
        flow_cfg = _flow_config(args, pair, device)
        errs = evaluate_velocities(
            pair, cfg, num_evaluations=args.num_evaluations,
            use_deep_flow=args.deep_flow, seed=args.seed + i,
            image_path=os.path.join(results_dir, "depthMaps", str(i)),
            dtype=dtype, flow_cfg=flow_cfg,
            use_occlusion_mask=args.occlusion_mask, device=device)
        errors_f.write(f"{task},{errs.error_w},{errs.error_v},"
                       f"{errs.error_reproject}\n")
        n = errs.k.shape[0]
        files["w"].write(",".join(
            " ".join(map(str, errs.w[:, j])) for j in range(n)) + "\n")
        files["v"].write(",".join(
            " ".join(map(str, errs.v[:, j])) for j in range(n)) + "\n")
        files["k"].write(",".join(map(str, errs.k)) + "\n")
        files["reproject_errors"].write(
            ",".join(map(str, errs.error_reproject_vec)) + "\n")
        files["error_v"].write(",".join(map(str, errs.error_v_vec)) + "\n")
        files["error_w"].write(",".join(map(str, errs.error_w_vec)) + "\n")
        print(f"  error_w={errs.error_w:.6f} error_v={errs.error_v:.6f} "
              f"reproject={errs.error_reproject:.4f}")
        done.add(task)
        for f in files.values():
            f.flush()
        errors_f.flush()
        with open(progress_path, "w") as f:
            json.dump({"done": sorted(done)}, f)
    for f in files.values():
        f.close()
    errors_f.close()
    print(f"\nresults written to {results_dir}")


def cmd_test_flow(args):
    """The flow self-check (the reference's testFlow, src/main.cc:563-609)
    as a number: the warp error of each flow against no flow."""
    import torch

    from rs_sfm_tpu_torch.data.dataset import load_synthetic_pair
    from rs_sfm_tpu_torch.eval.harness import compute_flow
    from rs_sfm_tpu_torch.flow.check import flow_consistency_error
    from rs_sfm_tpu_torch.flow.dense import as_device_tensor

    device, dtype = _setup(args)
    pair = load_synthetic_pair(args.data)
    i1 = as_device_tensor(pair.frame1.rs_image, device, dtype) / 255.0
    i2 = as_device_tensor(pair.frame2.rs_image, device, dtype) / 255.0
    for name, deep in [("true", False), ("dense", True)]:
        try:
            flow = compute_flow(pair, deep, dtype=dtype, device=device)
        except ValueError:
            continue
        err = float(flow_consistency_error(i1, i2, flow))
        base = float(flow_consistency_error(i1, i2, torch.zeros_like(flow)))
        verdict = "OK" if err < 0.7 * base else "SUSPECT"
        print(f"{name} flow: warp error {err:.4f} (no-flow baseline "
              f"{base:.4f}) -> {verdict}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="rs_sfm_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="render a synthetic RS dataset")
    g.add_argument("--out", required=True)
    g.add_argument("--size", type=int, default=128)
    g.add_argument("--gamma", type=float, default=0.9)
    g.add_argument("--k", type=float, default=0.0)
    g.add_argument("--v", default="0.12,-0.05,0.08")
    g.add_argument("--w", default="0.003,-0.002,0.004")
    _add_common(g)
    g.set_defaults(fn=cmd_generate)

    gs = sub.add_parser("generate-sweep",
                        help="render a parameter-sweep dataset grid")
    gs.add_argument("--out", required=True)
    gs.add_argument("--size", type=int, default=128)
    gs.add_argument("--gammas", default="0.1,0.5,0.9")
    gs.add_argument("--ks", default="0")
    gs.add_argument("--vs", default="0.02")
    gs.add_argument("--ws", default="0.001")
    _add_common(gs)
    gs.set_defaults(fn=cmd_generate_sweep)

    def add_est_flags(p):
        p.add_argument("--ransac-trials", type=int, default=256)
        p.add_argument("--ransac-tol", type=float, default=0.05)
        p.add_argument("--refine-starts", type=int, default=1,
                       help="multi-start refinement (top-J RANSAC "
                            "hypotheses; 4 recommended on estimated flow)")
        p.add_argument("--acceleration", action="store_true",
                       help="constant-acceleration model (estimate k)")
        p.add_argument("--global-shutter", action="store_true")
        p.add_argument("--no-refinement", action="store_true")
        p.add_argument("--deep-flow", action="store_true")
        p.add_argument("--flow-model", default="variational",
                       help="dense-flow preset from rs_sfm_tpu_torch.models "
                            "(variational / fast / robust / census / auto: "
                            "a coarse probe of each pair picks variational "
                            "or robust)")
        p.add_argument("--warp-engine", choices=("xla", "pallas"),
                       default="xla",
                       help="accepted; both run the warp kernel")
        p.add_argument("--sor-engine", choices=("xla", "pallas"),
                       default="xla",
                       help="accepted; both run the SOR kernel")
        p.add_argument("--census-weight", type=float, default=None,
                       help="ternary-census data term weight (real imagery "
                            "with illumination changes; 0 = off; overrides "
                            "the flow-model preset, including explicit 0)")
        p.add_argument("--occlusion-mask", action="store_true",
                       help="forward-backward occlusion check; occluded "
                            "pixels are excluded from RANSAC/refinement")
        p.add_argument("--model-feedback", action="store_true",
                       help="2 model-feedback re-estimation passes on the "
                            "trusted mask (flow/feedback.py)")
        p.add_argument("--gamma", type=float, default=None)
        p.add_argument("--seed", type=int, default=0)
        _add_common(p)

    s = sub.add_parser("single-run", help="end-to-end single pair")
    s.add_argument("--data", required=True)
    s.add_argument("--out", default=None)
    s.add_argument("--camera", default=None,
                   help="named intrinsics for real pairs (frame{1,2}.png)")
    add_est_flags(s)
    s.set_defaults(fn=cmd_single_run)

    sw = sub.add_parser("sweep", help="task-list evaluation harness")
    sw.add_argument("--path", required=True)
    sw.add_argument("--num-evaluations", type=int, default=2)
    sw.add_argument("--resume", default=None,
                    help="existing results dir to continue")
    add_est_flags(sw)
    sw.set_defaults(fn=cmd_sweep)

    tf = sub.add_parser("test-flow", help="flow warp self-check")
    tf.add_argument("--data", required=True)
    _add_common(tf)
    tf.set_defaults(fn=cmd_test_flow)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
