"""Dense-flow configuration (port of rs_sfm_tpu/flow/dense.py:33-197).

Kept apart from the algorithm so that `config` and `models` can name it
without loading the flow code and its kernel wrappers.
"""

from __future__ import annotations

from typing import NamedTuple


class DenseFlowConfig(NamedTuple):
    """Dense-flow configuration; every field, name and default of the JAX
    NamedTuple (field docs in rs_sfm_tpu/flow/dense.py:33-197).

    `warp_engine` and `sor_engine` keep their JAX values ("xla" or
    "pallas") so a configuration moves across unchanged; the port has one
    path for both, the kernels of ops/kernels on a CUDA tensor and their
    plain twins on a CPU tensor.
    """

    levels: int = 6
    warps: int = 3
    iters: int = 20
    warps_coarse: int = 0
    iters_coarse: int = 0
    omega: float = 1.85
    smoothness: float = 0.08
    gamma_grad: float = 0.7
    eps: float = 1e-3
    median: bool = True
    struct_texture: float = 0.0
    lcn: float = 0.0
    gain_correct: bool = False
    init_search_radius: int = 8
    refine_search_radius: int = 4
    refine_max_size: int = 192
    refine_fine_radius: int = 0
    match_ratio: float = 0.0
    census_weight: float = 0.0
    census_sigma: float = 0.04
    sor_engine: str = "xla"
    brightness_weight: float = 1.0
    warp_engine: str = "xla"
    warp_radius: int = 24
    occ_rel: float = 0.01
    occ_abs: float = 0.5
    occ_photo: float = 0.0
    backward_scale: int = 1
    refine_shifted: bool = False
    anchor_ambiguous: bool = False
