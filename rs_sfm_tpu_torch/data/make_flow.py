"""Synthetic rolling-shutter-free flow field for the solver slice (numpy copy
of `_make_flow` in the repository's `__graft_entry__.py`).

A smooth random depth surface seen under the fixed motion
v = (0.12, -0.05, 0.08), w = (0.003, -0.002, 0.004), with f = W and the
principal point at the image center; cheap, no renderer needed.
"""

from __future__ import annotations

import numpy as np

TRUE_V = (0.12, -0.05, 0.08)
TRUE_W = (0.003, -0.002, 0.004)


def make_flow(h: int, w: int, seed: int = 0) -> np.ndarray:
    """(h, w, 2) float32 pixel flow."""
    rng = np.random.default_rng(seed)
    f = float(w)
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    x = (xs - cx) / f
    y = (ys - cy) / f
    depth = (4.0 + 2.0 * np.sin(3 * x) * np.cos(2 * y)
             + 0.5 * rng.standard_normal((h, w)).astype(np.float32))
    v = np.array(TRUE_V, np.float32)
    w_rot = np.array(TRUE_W, np.float32)
    ax = (v[0] - x * v[2]) / depth
    ay = (v[1] - y * v[2]) / depth
    bx = -x * y * w_rot[0] + (1 + x * x) * w_rot[1] - y * w_rot[2]
    by = -(1 + y * y) * w_rot[0] + x * y * w_rot[1] + x * w_rot[2]
    flow = np.stack([(ax + bx) * f, (ay + by) * f], axis=-1)
    return flow.astype(np.float32)
