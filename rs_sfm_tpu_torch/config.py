"""Pipeline configuration (port of rs_sfm_tpu/config.py, no JAX).

`PipelineConfig` keeps every field of the JAX dataclass with the same name
and default (as `flow.config.DenseFlowConfig` does for the JAX NamedTuple),
so a configuration moves across unchanged (`from_jax`).  The
engine names keep their JAX values: "pallas" selects the fused kernel path
(the hand-written CUDA kernels of `ops/kernels`), "xla" the plain tensor
path.  The dense-flow engines have one path for both values (see
`flow.config`).

Dtype policy: dense per-pixel tensors are float32 (`DENSE_DTYPE`); the
minimal solver's tiny matrices run in `CORE_DTYPE` (float64).
"""

from __future__ import annotations

import dataclasses

import torch

from rs_sfm_tpu_torch.flow.config import DenseFlowConfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.models import get_flow_preset

DENSE_DTYPE = torch.float32
CORE_DTYPE = torch.float64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration; field docs in rs_sfm_tpu/config.py."""

    ransac_trials: int = 256
    ransac_tol: float = 0.05
    flow_threshold: float = 1e-10
    use_acceleration: bool = False
    use_global_shutter: bool = False
    use_refinement: bool = True
    refine_iterations: int = 50
    refine_rel_tol: float = 1e-8
    refine_engine: str = "xla"
    ransac_engine: str = "xla"
    refine_starts: int = 1
    refine_start_diversity: float = 0.3
    refine_winnow_iters: int = 0
    refine_winnow2_iters: int = 0
    k_scan_points: int = 17
    k_scan_min: float = -0.5
    k_scan_max: float = 2.0
    k_scan_iters: int = 3
    ransac_sample_pool: int = 1024
    ransac_prescore_subsample: int = 0
    ransac_prescore_keep: int = 16
    ransac_chunk: int = 64
    refine_loss_delta_px: float = 0.0
    depth_residual_px: float = 0.0
    feedback_passes: int = 0
    feedback_residual_tol_px: float = 2.0
    feedback_mode: str = "refine"
    feedback_revote: bool = False
    feedback_refine_iterations: int = 0
    feedback_fast_inpaint: bool = False
    use_fy_in_projection: bool = True
    relocate_skip_first_row: bool = False


# The two configurations of the solver slice (flow field -> RANSAC ->
# fused LM -> rectification), as the repository's bench.py runs them.
# GT-flow solver path (bench.py:86-110): one refinement start.
GT_FLOW_CONFIG = PipelineConfig(
    ransac_trials=256, ransac_chunk=32, refine_iterations=20,
    refine_rel_tol=0.0, refine_engine="pallas", ransac_engine="pallas")
# Production estimation (bench.py:185-194) without the feedback passes:
# 4 diversity starts winnowed after 8 iterations, Huber LM, tight depth
# export.
ESTIMATION_CONFIG = PipelineConfig(
    ransac_trials=256, ransac_chunk=32, ransac_tol=0.02,
    refine_iterations=20, refine_rel_tol=0.0, refine_starts=4,
    refine_winnow_iters=8, depth_residual_px=2.0, refine_loss_delta_px=3.0,
    feedback_passes=0, feedback_mode="refine", feedback_refine_iterations=0,
    refine_engine="pallas", ransac_engine="pallas")
SLICE_CONFIGS = {"gt_flow": GT_FLOW_CONFIG, "estimation": ESTIMATION_CONFIG}

# The end-to-end main path (bench.py:170-212): dense flow with the
# variational preset on the kernel engines and a half-resolution backward
# pass, then the production estimation with 2 warm-start feedback passes of
# 8 iterations each (bench.py:185-194).
E2E_FLOW_PRESET = get_flow_preset("variational", warp_engine="pallas",
                                  sor_engine="pallas", backward_scale=2)
E2E_CONFIG = dataclasses.replace(ESTIMATION_CONFIG, feedback_passes=2,
                                 feedback_refine_iterations=8)


def from_jax(obj):
    """The port's counterpart of a JAX `PipelineConfig`, `Intrinsics` or
    `DenseFlowConfig`.

    Reads the fields through `dataclasses.asdict` (or a NamedTuple's
    `_asdict`), so nothing here imports JAX; the class is recognised by its
    field names.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = dataclasses.asdict(obj)
        classes = (PipelineConfig, Intrinsics)
    elif hasattr(obj, "_asdict"):
        fields = dict(obj._asdict())
        classes = (DenseFlowConfig,)
    else:
        raise TypeError(f"no port counterpart for {type(obj).__name__}")
    for cls in classes:
        names = (cls._fields if cls is DenseFlowConfig
                 else [f.name for f in dataclasses.fields(cls)])
        if set(fields) == set(names):
            return cls(**fields)
    raise TypeError(f"no port counterpart for {type(obj).__name__}")
