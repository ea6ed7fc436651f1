"""Artifact writers of the reference's output contract (port of
rs_sfm_tpu/eval/artifacts.py).

evaluateSingleRun writes optical_flow.png, optical_flow_arrow.png,
MinimalDepth.png, backprojection.png, point_cloud.ply and (synthetic only)
error and overlay images (reference src/main.cc:386-556); the sweep
harness writes per-run depth maps (src/errorMeasure.cpp:199-226).  Host-side
numpy on copies of the tensors; every image goes through `data/png.py`.
"""

from __future__ import annotations

import os

import numpy as np

from rs_sfm_tpu_torch.data import png
from rs_sfm_tpu_torch.data.dataset import to_numpy, to_uint8

imwrite = png.write


def depth_image(depth_map) -> np.ndarray:
    """8-bit depth visualization: 10 + 244·(z−z_min)/(z_max−z_min) on the
    nonzero pixels, 0 elsewhere (reference src/main.cc:481-509)."""
    d = to_numpy(depth_map).astype(np.float64)
    m = d != 0
    out = np.zeros(d.shape, dtype=np.uint8)
    if m.any():
        z = d[m]
        z_min, z_max = z.min(), z.max()
        span = (z_max - z_min) or 1.0
        out[m] = np.clip(np.round(10.0 + 244.0 * (z - z_min) / span), 0,
                         255).astype(np.uint8)
    return out


def error_image(est_3d, true_3d, valid, max_norm: float = 3.0) -> np.ndarray:
    """8-bit heatmap of the per-pixel 3D error, scaled by max_norm
    (reference Camera::createErrorImage, src/camera.cc:503-590)."""
    dist = np.linalg.norm(to_numpy(est_3d) - to_numpy(true_3d), axis=-1)
    dist = np.where(to_numpy(valid) & np.isfinite(dist), dist, 0.0)
    return np.clip(np.round(255.0 * dist / max_norm), 0, 255).astype(np.uint8)


def shift_channels(img, *, r: float = 1.0, g: float = 1.0,
                   b: float = 1.0) -> np.ndarray:
    """Per-channel gain with [0, 255] clipping (reference
    Camera::shiftChannelBGR, src/camera.cc:777-815; arguments named by
    colour)."""
    out = to_numpy(img).astype(np.float64) * np.array([r, g, b], np.float64)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def overlay_image(base, shift, black_threshold: float = 15.0) -> np.ndarray:
    """Norm-weighted blend of a deviation image onto a base image where the
    deviation's norm exceeds the black threshold, the base elsewhere
    (reference Camera::createOverlayImage, src/camera.cc:817-839)."""
    base = to_numpy(base).astype(np.float64)
    shift = to_numpy(shift).astype(np.float64)
    n_b = np.linalg.norm(base, axis=-1, keepdims=True)
    n_s = np.linalg.norm(shift, axis=-1, keepdims=True)
    mult = n_b / np.maximum(n_b + n_s, 1e-12)
    blended = mult * base + (1.0 - mult) * shift
    out = np.where(n_s > black_threshold, blended, base)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def abs_difference(a, b) -> np.ndarray:
    """Saturating |a − b| on uint8 images (reference main.cc:543-546)."""
    a = to_numpy(a).astype(np.int16)
    b = to_numpy(b).astype(np.int16)
    return np.clip(np.abs(a - b), 0, 255).astype(np.uint8)


def synthetic_eval_images(rs_image, gs_image, backprojection) -> dict:
    """The synthetic-only artifact set of evaluateSingleRun (reference
    src/main.cc:533-556): difference, remainder and blue-deviation overlays
    of GS-vs-RS and GS-vs-backprojection; {filename: uint8 image}."""
    rs = to_uint8(rs_image)
    gs = to_uint8(gs_image)
    bp = to_uint8(backprojection)
    difference = abs_difference(bp, gs)
    remainder = abs_difference(gs, difference)
    warp_shift = abs_difference(rs, gs)
    # The deviation in blue: gain 2 on blue, 0.5 on the others
    # (src/main.cc:548-553).
    overlay_gs_rs = overlay_image(
        gs, shift_channels(warp_shift, r=0.5, g=0.5, b=2.0))
    overlay_gs_bp = overlay_image(
        gs, shift_channels(difference, r=0.5, g=0.5, b=2.0))
    return {"gs_image.png": gs, "difference.png": difference,
            "remainder.png": remainder, "overlay_gs_rs.png": overlay_gs_rs,
            "overlay_gs_bp.png": overlay_gs_bp}


def save_single_run_artifacts(out_dir, *, flow_px, rs_image, depth_map,
                              gs_image, coords_3d, valid):
    """Write the evaluateSingleRun artifact set."""
    from rs_sfm_tpu_torch.data.ply import write_ply
    from rs_sfm_tpu_torch.flow.viz import flow_arrows, flow_to_color

    os.makedirs(out_dir, exist_ok=True)
    flow = to_numpy(flow_px)
    imwrite(os.path.join(out_dir, "optical_flow.png"), flow_to_color(flow))
    imwrite(os.path.join(out_dir, "optical_flow_arrow.png"),
            flow_arrows(to_uint8(rs_image), flow))
    imwrite(os.path.join(out_dir, "MinimalDepth.png"), depth_image(depth_map))
    imwrite(os.path.join(out_dir, "backprojection.png"), to_uint8(gs_image))
    write_ply(os.path.join(out_dir, "point_cloud.ply"), coords_3d,
              to_uint8(rs_image), mask=valid)
