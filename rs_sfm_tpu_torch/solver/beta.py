"""Rolling-shutter correction factors α, α̃ and β (port of
rs_sfm_tpu/solver/beta.py; report eq. 10-12).

  α   = 1 + γ·flow_y/H
  α̃   = ½[(1 + γ·(y + flow_y)/H)² − (γ·y/H)²]
  β(k) = (α + k·α̃)·2/(2+k)

On pixel-unit flow and pixel y coordinates with H = image rows
(src/minimal.cc:179-197).  All inputs broadcast elementwise.
"""

from __future__ import annotations


def get_alpha(flow_y_px, rows, gamma):
    """α = 1 + γ·flow_y/H (src/minimal.cc:179-186)."""
    return 1.0 + gamma * flow_y_px / rows


def get_alpha_k(y_px, flow_y_px, rows, gamma):
    """α̃ = ½[(1 + γ(y+dy)/H)² − (γy/H)²] (src/minimal.cc:188-197)."""
    part1 = gamma * y_px / rows
    part2 = 1.0 + gamma * (y_px + flow_y_px) / rows
    return 0.5 * (part2 * part2 - part1 * part1)


def beta_factor(alpha, alpha_k, k):
    """β(k) = (α + k·α̃)·2/(2+k) (src/minimal.cc:82,265)."""
    return (alpha + k * alpha_k) * (2.0 / (2.0 + k))


def beta_factor_dk(alpha, alpha_k, k):
    """dβ/dk = 2(2α̃ − α)/(2+k)²."""
    return 2.0 * (2.0 * alpha_k - alpha) / ((2.0 + k) * (2.0 + k))
