"""Pyramid resampling: the 5-tap binomial blur, the 2x blur-decimation and
the exact 2x bilinear upsample (port of rs_sfm_tpu/ops/resample.py, and
of the blur of rs_sfm_tpu/flow/dense.py).

The JAX package writes the decimation and the upsample as strided and
input-dilated XLA convolutions, which its TPU compiler lowers without the
relayouts that a stride-2 slice or a column interleave of the lane axis
cost there; no Pallas kernel is involved.  The port keeps the flow
pyramid's elementwise formulations (rs_sfm_tpu/flow/dense.py::
_gauss_blur, ::_downsample, ::_up2), with their taps summed in the same
order, and uses no convolution: a float32 convolution on the card may run
in TF32, cuDNN's default.  They agree with the JAX convolutions to float
reassociation (1e-6 relative).

  * gauss_blur(x): the blur (1, 4, 6, 4, 1) / 16 over the last two axes,
    rows first, edges replicated;
  * down2_blur(x): gauss_blur(x) at every second row and column;
  * up2(x): out[2i] = 0.75 x[i] + 0.25 x[i-1], out[2i+1] = 0.75 x[i] +
    0.25 x[i+1], edge-clamped (half-pixel centres).
"""

from __future__ import annotations

import torch

from rs_sfm_tpu_torch.ops import stencil

# 5-tap binomial kernel (exact in float32).
BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def gauss_blur(x):
    """5-tap binomial blur over the last two axes, rows first, edges
    replicated (summed in the JAX function's order)."""
    def conv1d(v, axis):
        out = BINOMIAL[0] * stencil.shift(v, -2, axis)
        for i in range(1, 5):
            out = out + BINOMIAL[i] * stencil.shift(v, i - 2, axis)
        return out

    return conv1d(conv1d(x, -2), -1)


def down2_blur(x):
    """Binomial blur and 2x decimation of the last two axes:
    (..., H, W) -> (..., ceil(H / 2), ceil(W / 2))."""
    return gauss_blur(x)[..., ::2, ::2]


def up2(x):
    """Exact 2x bilinear upsample (half-pixel centres) of the last two
    axes: (..., H, W) -> (..., 2H, 2W)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    shift = stencil.shift
    rows = torch.stack([0.75 * x + 0.25 * shift(x, 1, -2),
                        0.75 * x + 0.25 * shift(x, -1, -2)], dim=-2)
    rows = rows.reshape(*lead, 2 * h, w)
    cols = torch.stack([0.75 * rows + 0.25 * shift(rows, 1, -1),
                        0.75 * rows + 0.25 * shift(rows, -1, -1)], dim=-1)
    return cols.reshape(*lead, 2 * h, 2 * w)
