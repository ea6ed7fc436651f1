"""Flow visualization: HSV colorization and arrow overlays (port of
rs_sfm_tpu/flow/viz.py; reference Camera::getImageOpticalFlow,
src/camera.cc:280-309, and Camera::flowArrows, src/camera.cc:312-332).
Host-side numpy, for the artifacts; a flow tensor on any device is copied
to the host first."""

from __future__ import annotations

import numpy as np

from rs_sfm_tpu_torch.data.dataset import to_numpy, to_uint8


def flow_to_color(flow_px) -> np.ndarray:
    """HSV flow colorization: hue = direction, value = magnitude,
    saturation 1 (src/camera.cc:286-303).  Returns (H, W, 3) uint8."""
    flow = to_numpy(flow_px).astype(np.float64)
    dx, dy = flow[..., 0], flow[..., 1]
    mag = np.hypot(dx, dy)
    ang = np.arctan2(dy, dx)  # [-pi, pi]
    hue = (ang + np.pi) / (2 * np.pi)  # [0, 1]
    max_mag = mag.max()
    val = mag / max_mag if max_mag > 0 else np.zeros_like(mag)
    sat = np.ones_like(val)
    # HSV -> RGB.
    h6 = hue * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    r = np.choose(i, [val, q, p, p, t, val])
    g = np.choose(i, [t, val, val, q, p, p])
    b = np.choose(i, [p, p, t, val, val, q])
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def flow_arrows(image, flow_px, step_x: int = 50, step_y: int = 50,
                color=(0, 255, 0)) -> np.ndarray:
    """Sparse flow arrows drawn on a copy of the image
    (src/camera.cc:312-332): rounded lines and a small cross at each tip."""
    img = to_uint8(image).copy()
    flow = to_numpy(flow_px)
    h, w = flow.shape[:2]

    def line(y0, x0, y1, x1):
        n = int(max(abs(y1 - y0), abs(x1 - x0), 1))
        ys = np.linspace(y0, y1, n + 1).round().astype(int)
        xs = np.linspace(x0, x1, n + 1).round().astype(int)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = color

    for y in range(step_y // 2, h, step_y):
        for x in range(step_x // 2, w, step_x):
            dx, dy = flow[y, x]
            line(y, x, y + dy, x + dx)
            ty, tx = int(round(y + dy)), int(round(x + dx))
            if 1 <= ty < h - 1 and 1 <= tx < w - 1:
                img[ty - 1:ty + 2, tx] = color
                img[ty, tx - 1:tx + 2] = color
    return img
