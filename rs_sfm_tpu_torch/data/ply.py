"""ASCII PLY point-cloud export (port of rs_sfm_tpu/data/ply.py; reference
Camera::createPointCloud, src/camera.cc:423-491): world coordinates and the
RS pixels' colours, in the JAX package's exact text (its native writer and
its numpy fallback write the same bytes)."""

from __future__ import annotations

import numpy as np

from rs_sfm_tpu_torch.data.dataset import to_numpy, to_uint8


def write_ply(path: str, points, colors, mask=None) -> int:
    """Write an ASCII PLY of the masked points.

    Args:
      path: output file.
      points: (..., 3) float world coordinates (tensor or array).
      colors: (..., 3) uint8 or unit-float RGB.
      mask: optional (...,) bool; default: points with nonzero norm.

    Returns the number of vertices written.
    """
    pts = to_numpy(points).astype(np.float64).reshape(-1, 3)
    cols = to_uint8(to_numpy(colors).reshape(-1, 3))
    m = (np.linalg.norm(pts, axis=-1) > 0 if mask is None
         else to_numpy(mask).reshape(-1))
    m = m & np.isfinite(pts).all(axis=-1)
    pts, cols = pts[m], cols[m]
    n = pts.shape[0]
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    body = np.concatenate([pts, cols.astype(np.float64)], axis=1)
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, body, fmt="%.6f %.6f %.6f %d %d %d")
    return n
