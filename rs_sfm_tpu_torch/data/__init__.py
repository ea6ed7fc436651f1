"""Inputs: the solver slice's synthetic flow (`make_flow`), the synthetic
rolling-shutter renderer (`synthetic`), the reference's dataset layout and
ground-truth depth (`dataset`, with the PNG codec `png`), the PLY writer
(`ply`) and the named-camera registry (`intrinsics`)."""

from __future__ import annotations

import numpy as np
import torch


def scene_from_numpy(scene, dtype=torch.float64, device=None):
    """The port's `synthetic.Scene` from any object with a Scene's fields
    (origins, edge1, edge2, base_color, velocity, periodic) as arrays that
    numpy reads, or None, such as the JAX package's Scene: both packages
    then render the same world.  `device` None means the CUDA device
    (raises without one)."""
    from rs_sfm_tpu_torch.data.synthetic import Scene
    from rs_sfm_tpu_torch.flow.dense import as_device_tensor

    return Scene(**{name: None if getattr(scene, name, None) is None
                    else as_device_tensor(np.array(getattr(scene, name)),
                                          device, dtype)
                    for name in Scene._fields})
