"""Edge-clamped shifts and padding over the last two axes (the stencil
primitives of rs_sfm_tpu/flow/dense.py::_shift).

Edge replication, not wrap-around: a torus boundary would drag the top and
bottom rows of a rolling-shutter flow field toward each other.
"""

from __future__ import annotations

import torch


def shift(x, s: int, axis: int):
    """out[i] = x[clip(i - s, 0, n-1)] along `axis` (jnp.roll's sign
    convention, replicating the edge instead of wrapping)."""
    if s == 0:
        return x
    n = x.shape[axis]
    if s > 0:
        edge = x.narrow(axis, 0, 1)
        parts = [edge] * s + [x.narrow(axis, 0, n - s)]
    else:
        edge = x.narrow(axis, n - 1, 1)
        parts = [x.narrow(axis, -s, n + s)] + [edge] * (-s)
    return torch.cat(parts, dim=axis)


def pad_edge(x, r: int):
    """Pad the last two axes by r on every side, replicating the edge
    (jnp.pad(mode="edge") on a plane)."""
    if r == 0:
        return x
    h, w = x.shape[-2:]
    iy = torch.arange(-r, h + r, device=x.device).clamp_(0, h - 1)
    ix = torch.arange(-r, w + r, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, iy).index_select(-1, ix)
