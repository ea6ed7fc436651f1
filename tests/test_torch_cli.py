"""The port's command-line interface end to end on the CPU, pure torch (no
JAX): generate → single-run → generate-sweep → sweep (and --resume) →
test-flow at 32x32 with --device cpu, held to tests/test_harness.py's
gates (err_w < 1e-3, err_v < 0.02, reprojection < 0.2), single-run with
--acceleration too (and |k| < 0.2 on the k = 0 dataset), --flow-model auto
in single-run and sweep (the probe picks variational on the clean castle);
--census-weight and --flow-model census reach dense flow with --deep-flow,
and --device cuda without a card raises instead of running on the CPU."""

import json
import shutil

import numpy as np
import pytest
import torch

from rs_sfm_tpu_torch import cli
from rs_sfm_tpu_torch.data import png
from rs_sfm_tpu_torch.data.dataset import load_synthetic_pair
from rs_sfm_tpu_torch.flow import dense as tdense

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)

CPU = ["--device", "cpu"]
# tests/test_harness.py's configuration.
EST = ["--ransac-trials", "32", "--ransac-tol", "0.01"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli") / "ds"
    cli.main(["generate", "--out", str(out), "--size", "32"] + CPU)
    return out


def test_generate_writes_the_reference_layout(dataset):
    pair = load_synthetic_pair(str(dataset))
    assert pair.frame1.rs_image.shape == (32, 32, 3)
    assert pair.frame1.rs_image.dtype == np.uint8
    assert pair.frame1.rs_unproject.shape == (32, 32, 3)
    assert pair.frame2.poses_r.shape == (32, 3, 3)
    assert pair.gamma == 0.9 and pair.k == 0.0
    # Rendered in float32: v as its float32 rounding.
    np.testing.assert_allclose(pair.v, [0.12, -0.05, 0.08], rtol=1e-7)
    assert png.read(str(dataset / "images" / "1_rs_depth.png")).shape == (32,
                                                                          32)


def test_single_run_gt_flow(dataset, tmp_path, capsys):
    out = tmp_path / "res"
    cli.main(["single-run", "--data", str(dataset), "--out", str(out)]
             + EST + CPU)
    est = json.loads((out / "estimate.json").read_text())
    v, w = np.array(est["v"]), np.array(est["w"])
    v_true = np.array([0.12, -0.05, 0.08])
    angle = np.arccos(abs(v @ v_true) / np.linalg.norm(v)
                      / np.linalg.norm(v_true))
    assert angle < 0.02
    assert np.abs(w - [0.003, -0.002, 0.004]).max() < 1e-3
    assert est["num_inliers"] > 0.4 * 32 * 32
    text = capsys.readouterr().out
    err3d = float(text.split("mean reprojection error:")[1].split()[0])
    assert err3d < 0.2
    for name in ("optical_flow.png", "optical_flow_arrow.png",
                 "MinimalDepth.png", "backprojection.png", "error_image.png",
                 "gs_image.png", "difference.png", "remainder.png",
                 "overlay_gs_rs.png", "overlay_gs_bp.png"):
        assert png.read(str(out / name)).shape[:2] == (32, 32), name
    ply = (out / "point_cloud.ply").read_text().splitlines()
    assert ply[0] == "ply"
    assert int(ply[2].split()[-1]) == len(ply) - 10 > 0.4 * 32 * 32


def test_single_run_acceleration_gt_flow(dataset, tmp_path, capsys):
    """--acceleration (the constant-acceleration model, k estimated) on the
    GT flow of the k = 0 dataset: the same gates, k near 0."""
    out = tmp_path / "res"
    cli.main(["single-run", "--data", str(dataset), "--out", str(out),
              "--acceleration"] + EST + CPU)
    est = json.loads((out / "estimate.json").read_text())
    v, w = np.array(est["v"]), np.array(est["w"])
    v_true = np.array([0.12, -0.05, 0.08])
    angle = np.arccos(abs(v @ v_true) / np.linalg.norm(v)
                      / np.linalg.norm(v_true))
    assert angle < 0.02
    assert np.abs(w - [0.003, -0.002, 0.004]).max() < 1e-3
    assert abs(est["k"]) < 0.2
    text = capsys.readouterr().out
    err3d = float(text.split("mean reprojection error:")[1].split()[0])
    assert err3d < 0.2
    assert (out / "gs_image.png").exists()


def test_sweep_and_resume(tmp_path, capsys):
    sw = tmp_path / "sweep"
    cli.main(["generate-sweep", "--out", str(sw), "--size", "32",
              "--gammas", "0.5,0.9"] + CPU)
    tasks = (sw / "tasks.txt").read_text().split()
    assert tasks == ["g0.5_k0.0_v0.02_w0.001", "g0.9_k0.0_v0.02_w0.001"]
    cli.main(["sweep", "--path", str(sw), "--num-evaluations", "2"]
             + EST + CPU)
    (res,) = (sw / "results").iterdir()
    rows = (res / "errors.csv").read_text().splitlines()
    assert rows[0] == "task,error_w,error_v,reproject_error"
    assert [r.split(",")[0] for r in rows[1:]] == tasks
    for row in rows[1:]:
        err_w, err_v, err3d = map(float, row.split(",")[1:])
        assert err_w < 1e-3 and err_v < 0.02 and err3d < 0.2
    for name in ("w", "v", "k", "reproject_errors", "error_v", "error_w"):
        assert len((res / f"{name}.csv").read_text().splitlines()) == 2
    assert (res / "depthMaps" / "1" / "depth_1.png").exists()
    assert (res / "depthMaps" / "0" / "point_cloud_0.ply").exists()
    assert json.loads((res / "progress.json").read_text()) == {
        "done": sorted(tasks)}
    # --resume on the finished directory skips every task.
    capsys.readouterr()
    cli.main(["sweep", "--path", str(sw), "--resume", str(res)] + EST + CPU)
    text = capsys.readouterr().out
    assert "2 task(s) already done" in text
    assert text.count("(already done)") == 2
    assert len((res / "errors.csv").read_text().splitlines()) == 3


def test_test_flow(dataset, capsys):
    cli.main(["test-flow", "--data", str(dataset)] + CPU)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["true", "dense"]
    for line in lines:
        err = float(line.split("warp error ")[1].split()[0])
        base = float(line.split("baseline ")[1].split(")")[0])
        assert 0.0 < err < base
    assert lines[1].endswith("-> OK")


@pytest.mark.parametrize("flags,weight", [
    (["--acceleration", "--census-weight", "0.5"], 0.5),
    (["--flow-model", "census"], 1.0),
    (["--census-weight", "0.5"], 0.5)])
def test_census_flags_reach_dense_flow(dataset, tmp_path, monkeypatch,
                                       flags, weight):
    """--census-weight and the census preset run (ROADMAP A10): single-run
    and sweep with --deep-flow hand dense flow the census weight, and
    finish with a finite estimate."""
    weights = []
    inner = tdense.dense_flow_aux

    def spy(image1, image2, cfg, prior=None):
        weights.append(cfg.census_weight)
        return inner(image1, image2, cfg, prior)

    monkeypatch.setattr(tdense, "dense_flow_aux", spy)
    out = tmp_path / "res"
    cli.main(["single-run", "--data", str(dataset), "--out", str(out),
              "--deep-flow"] + EST + flags + CPU)
    est = json.loads((out / "estimate.json").read_text())
    assert np.isfinite(est["v"]).all() and est["num_inliers"] > 0
    sweep = tmp_path / "sweep"
    shutil.copytree(dataset, sweep / "t0",
                    ignore=shutil.ignore_patterns("results"))
    (sweep / "tasks.txt").write_text("t0\n")
    cli.main(["sweep", "--path", str(sweep), "--num-evaluations", "1",
              "--deep-flow"] + EST + flags + CPU)
    assert len(weights) >= 2 and set(weights) == {weight}


@pytest.mark.parametrize("flags", [["--acceleration", "--flow-model", "auto"],
                                   ["--flow-model", "auto"]])
def test_flow_model_auto_runs(dataset, tmp_path, capsys, flags):
    """--flow-model auto probes the pair and prints the preset it picked
    (the clean castle: variational), in single-run and (without
    --acceleration) in sweep."""
    out = tmp_path / "res"
    cli.main(["single-run", "--data", str(dataset), "--out", str(out)]
             + EST + flags + CPU)
    assert "flow model auto -> variational" in capsys.readouterr().out
    est = json.loads((out / "estimate.json").read_text())
    assert np.isfinite(est["v"]).all() and est["num_inliers"] > 0
    if "--acceleration" in flags:
        return
    sweep = tmp_path / "sweep"
    shutil.copytree(dataset, sweep / "t0",
                    ignore=shutil.ignore_patterns("results"))
    (sweep / "tasks.txt").write_text("t0\n")
    cli.main(["sweep", "--path", str(sweep), "--num-evaluations", "1"]
             + EST + flags + CPU)
    assert "flow model auto -> variational" in capsys.readouterr().out


def test_cuda_without_a_card_raises(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["generate", "--out", str(tmp_path / "x"), "--size", "16"],
                ["single-run", "--data", str(dataset)],
                ["test-flow", "--data", str(dataset)],
                ["sweep", "--path", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(cmd)
    assert not (tmp_path / "x").exists()
