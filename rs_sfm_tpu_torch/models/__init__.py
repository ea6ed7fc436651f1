"""Dense optical-flow model presets (port of rs_sfm_tpu/models/__init__.py).

The registry of named DenseFlowConfig presets, with the JAX package's
names and values:

  variational  pyramidal warping flow, 6 warps at the coarse levels
  fast         low-iteration variational preset for previews and video
  robust       local-contrast-normalised data term for real imagery
  census       census data term (its data term is not ported: the preset
               is listed, and dense flow raises NotImplementedError on it)

"auto" (the per-pair probe of rs_sfm_tpu/flow/auto.py) is not ported.
"""

from __future__ import annotations

from typing import Dict

from rs_sfm_tpu_torch.flow.config import DenseFlowConfig

FLOW_PRESETS: Dict[str, DenseFlowConfig] = {
    "variational": DenseFlowConfig(warps_coarse=6),
    "fast": DenseFlowConfig(levels=4, warps=2, iters=24),
    "robust": DenseFlowConfig(lcn=0.05, warps_coarse=6),
    "census": DenseFlowConfig(census_weight=1.0, struct_texture=0.9),
}


def get_flow_preset(name: str, **overrides) -> DenseFlowConfig:
    """Look up a flow preset by name, optionally overriding fields
    (e.g. ``get_flow_preset("variational", warp_engine="pallas")``)."""
    if name == "auto":
        raise NotImplementedError("the 'auto' flow preset is not ported")
    try:
        preset = FLOW_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown flow model {name!r}; known: "
                       f"{sorted(FLOW_PRESETS)}") from None
    return preset._replace(**overrides) if overrides else preset
