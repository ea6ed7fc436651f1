"""rs_sfm_tpu_torch configuration vs the JAX package's, and the port's
independence from JAX."""

import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import rs_sfm_tpu_torch
from rs_sfm_tpu.config import PipelineConfig as JaxPipelineConfig
from rs_sfm_tpu.flow.dense import DenseFlowConfig as JaxDenseFlowConfig
from rs_sfm_tpu.geom.camera import Intrinsics as JaxIntrinsics
from rs_sfm_tpu.models import FLOW_PRESETS as JAX_FLOW_PRESETS
from rs_sfm_tpu.models import get_flow_preset as jax_get_flow_preset
from rs_sfm_tpu_torch import config as tconfig
from rs_sfm_tpu_torch.flow.dense import DenseFlowConfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.models import FLOW_PRESETS

# The test workers share the CPU with the JAX tests: a few intra-op threads
# each (the results do not depend on the count).
torch.set_num_threads(2)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("jax_cls,port_cls", [
    (JaxPipelineConfig, tconfig.PipelineConfig),
    (JaxIntrinsics, Intrinsics),
])
def test_fields_and_defaults_equal(jax_cls, port_cls):
    assert _fields(port_cls) == _fields(jax_cls)


@pytest.mark.parametrize("jax_obj", [
    JaxPipelineConfig(),
    JaxPipelineConfig(ransac_trials=256, ransac_chunk=32, ransac_tol=0.02,
                      refine_iterations=20, refine_rel_tol=0.0,
                      refine_starts=4, refine_winnow_iters=8,
                      depth_residual_px=2.0, refine_loss_delta_px=3.0,
                      refine_engine="pallas", ransac_engine="pallas"),
    JaxIntrinsics(fx=1803.3, fy=1799.4, cx=945.3, cy=544.7),
])
def test_from_jax_round_trip(jax_obj):
    port = tconfig.from_jax(jax_obj)
    assert type(port).__name__ == type(jax_obj).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_obj)
    assert type(jax_obj)(**dataclasses.asdict(port)) == jax_obj


def test_dense_flow_config_fields_and_defaults_equal():
    assert DenseFlowConfig._fields == JaxDenseFlowConfig._fields
    assert DenseFlowConfig._field_defaults == JaxDenseFlowConfig._field_defaults


def test_flow_presets_equal():
    assert list(FLOW_PRESETS) == list(JAX_FLOW_PRESETS)
    for name, preset in JAX_FLOW_PRESETS.items():
        assert FLOW_PRESETS[name]._asdict() == preset._asdict(), name


@pytest.mark.parametrize("jax_obj", [
    JaxDenseFlowConfig(),
    jax_get_flow_preset("variational", warp_engine="pallas",
                        sor_engine="pallas", backward_scale=2),
])
def test_from_jax_dense_flow_config(jax_obj):
    port = tconfig.from_jax(jax_obj)
    assert type(port) is DenseFlowConfig
    assert port._asdict() == jax_obj._asdict()
    assert JaxDenseFlowConfig(**port._asdict()) == jax_obj


def test_e2e_configs_are_bench_py_s():
    """bench.py:170-194: the flow preset and the estimation with two
    8-iteration warm-start feedback passes."""
    assert tconfig.E2E_FLOW_PRESET == tconfig.from_jax(jax_get_flow_preset(
        "variational", warp_engine="pallas", sor_engine="pallas",
        backward_scale=2))
    assert tconfig.E2E_CONFIG == tconfig.from_jax(JaxPipelineConfig(
        ransac_trials=256, ransac_chunk=32, ransac_tol=0.02,
        refine_iterations=20, refine_rel_tol=0.0, refine_starts=4,
        refine_winnow_iters=8, depth_residual_px=2.0,
        refine_loss_delta_px=3.0, feedback_passes=2, feedback_mode="refine",
        feedback_refine_iterations=8, refine_engine="pallas",
        ransac_engine="pallas"))


def test_from_jax_rejects_other_dataclasses():
    @dataclasses.dataclass
    class Other:
        a: int = 0

    with pytest.raises(TypeError):
        tconfig.from_jax(Other())


REPO = pathlib.Path(rs_sfm_tpu_torch.__file__).parents[1]


def test_port_imports_no_jax():
    root = pathlib.Path(rs_sfm_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "rs_sfm_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")


def test_config_loads_no_flow_algorithm():
    """`config` and `models` name DenseFlowConfig without loading the
    dense-flow code or the kernel wrappers."""
    code = ("import sys; import rs_sfm_tpu_torch.config, "
            "rs_sfm_tpu_torch.models; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('rs_sfm_tpu_torch.flow.dense', 'rs_sfm_tpu_torch.ops'))))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_package(where, tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and wherever the package is not beside it."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    elif torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would start")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
