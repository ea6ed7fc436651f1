"""Dense optical-flow model presets (port of rs_sfm_tpu/models/__init__.py).

The registry of named DenseFlowConfig presets, with the JAX package's
names and values:

  variational  pyramidal warping flow, 6 warps at the coarse levels
  fast         low-iteration variational preset for previews and video
  robust       local-contrast-normalised data term for real imagery
  census       census data term and structure-texture (the census
               planes go to the SOR kernel, csrc/sor.cu)

and "auto", the per-pair probe (flow/auto.py), which needs the frame pair:
`resolve_flow_preset`.
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
    (e.g. ``get_flow_preset("variational", warp_engine="pallas")``).

    "auto" needs the frame pair: use resolve_flow_preset."""
    try:
        preset = FLOW_PRESETS[name]
    except KeyError:
        hint = ("; 'auto' needs the frame pair: use resolve_flow_preset"
                if name == "auto" else "")
        raise KeyError(f"unknown flow model {name!r}; known: "
                       f"{sorted(FLOW_PRESETS) + ['auto']}{hint}") from None
    return preset._replace(**overrides) if overrides else preset


def resolve_flow_preset(name: str, image1=None, image2=None, **overrides):
    """Resolve a preset name, "auto" included, to a DenseFlowConfig.

    "auto" runs the coarse-scale probe (flow/auto.py::probe_flow_preset) on
    the pair (on the images' device; arrays go to the card) and picks
    "variational" or "robust".

    Returns (config, resolved name).
    """
    if name == "auto":
        if image1 is None or image2 is None:
            raise ValueError("flow preset 'auto' needs the frame pair")
        from rs_sfm_tpu_torch.flow.auto import probe_flow_preset

        name = probe_flow_preset(image1, image2)
    return get_flow_preset(name, **overrides), name
