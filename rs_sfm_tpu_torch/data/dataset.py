"""The reference's dataset layout on disk, and the ground truth of a
synthetic frame (port of rs_sfm_tpu/data/dataset.py).

Reads and writes the exact layout the reference consumes
(setupCameraSynthetic, src/main.cc:613-672; setupCameraReal,
src/main.cc:675-690; sweep GT files, src/main.cc:210-257), byte for byte
the JAX package's:

  images/{1,2}_rs.png                      RS frames
  images/{1,2}_initial_gs.png              GS reference at scanline-0 pose
  images/{1,2}_initial_depth.png           normalized depth visualization
  images/{1,2}_rs_depth.png                normalized RS depth visualization
  images/{1,2}_rs_t.csv                    H x 3 per-scanline translations
  images/{1,2}_rs_r.csv                    H x 9 per-scanline rotations
                                           (row-major, take_sequence.m:28-33)
  images/{1,2}_rs_unproject_{x,y,z}.csv    H x W world-coordinate maps
  images/{1,2}_initial_gs_unproject_{x,y,z}.csv
  images/A.csv                             3 x 3 intrinsics
  v.csv w.csv gamma.csv k.csv              sweep ground truth (task dir)

w.csv holds radians (the MATLAB generator writes degrees; the JAX
package's documented divergence).  CSVs are written with "%.10g" and read
through numpy; PNGs through `data/png.py`.  Loaded pairs are host numpy
arrays: the harness moves what it needs to the device.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from rs_sfm_tpu_torch.data import png
from rs_sfm_tpu_torch.geom.camera import Intrinsics


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _read_csv_matrix(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _write_csv_matrix(path, mat) -> None:
    np.savetxt(path, to_numpy(mat), delimiter=",", fmt="%.10g")


class FrameData(NamedTuple):
    rs_image: np.ndarray                # (H, W, 3) uint8 (or float in [0, 1])
    gs_image: Optional[np.ndarray]
    depth_image: Optional[np.ndarray]   # (H, W) uint8 normalized viz
    poses_r: Optional[np.ndarray]       # (H, 3, 3)
    poses_t: Optional[np.ndarray]       # (H, 3)
    rs_unproject: Optional[np.ndarray]  # (H, W, 3)
    gs_unproject: Optional[np.ndarray]


class PairData(NamedTuple):
    frame1: FrameData
    frame2: FrameData
    intrinsics: Intrinsics
    gamma: Optional[float] = None
    k: Optional[float] = None
    v: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None


def to_uint8(img) -> np.ndarray:
    """A uint8 image of a uint8 or unit-float image."""
    img = to_numpy(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def _depth_png(depth) -> np.ndarray:
    """MATLAB-style normalized depth image (take_sequence.m:42-46)."""
    d = to_numpy(depth).astype(np.float64)
    lo, hi = d.min(), d.max()
    norm = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    return np.clip(np.round(norm * 255.0), 0, 255).astype(np.uint8)


def save_synthetic_pair(pair, task_dir: str) -> str:
    """Write a rendered SyntheticPair (tensors on any device) in the
    reference's sweep-task layout: `<task_dir>/images/...` plus the GT CSVs
    in `<task_dir>/`.  Returns the images/ prefix."""
    img_dir = os.path.join(task_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    prefix = os.path.join(img_dir, "")
    for num, fr in (("1", pair.frame1), ("2", pair.frame2)):
        png.write(prefix + f"{num}_rs.png", to_uint8(fr.rs_image))
        png.write(prefix + f"{num}_initial_gs.png", to_uint8(fr.gs_image))
        png.write(prefix + f"{num}_initial_depth.png",
                  _depth_png(fr.gs_depth))
        png.write(prefix + f"{num}_rs_depth.png", _depth_png(fr.rs_depth))
        _write_csv_matrix(prefix + f"{num}_rs_t.csv", fr.poses_t)
        _write_csv_matrix(prefix + f"{num}_rs_r.csv",
                          to_numpy(fr.poses_r).reshape(-1, 9))
        rs_un, gs_un = to_numpy(fr.rs_unproject), to_numpy(fr.gs_unproject)
        for axis, name in enumerate("xyz"):
            _write_csv_matrix(prefix + f"{num}_rs_unproject_{name}.csv",
                              rs_un[..., axis])
            _write_csv_matrix(
                prefix + f"{num}_initial_gs_unproject_{name}.csv",
                gs_un[..., axis])
    _write_csv_matrix(prefix + "A.csv", np.array(pair.intrinsics.matrix()))
    _write_csv_matrix(os.path.join(task_dir, "gamma.csv"),
                      np.array([[pair.gamma]]))
    _write_csv_matrix(os.path.join(task_dir, "k.csv"), np.array([[pair.k]]))
    _write_csv_matrix(os.path.join(task_dir, "v.csv"),
                      to_numpy(pair.v)[None, :])
    _write_csv_matrix(os.path.join(task_dir, "w.csv"),
                      to_numpy(pair.w)[None, :])
    return prefix


def load_synthetic_pair(task_dir: str) -> PairData:
    """Load a synthetic pair and its GT from the sweep-task layout."""
    prefix = os.path.join(task_dir, "images", "")

    def load_frame(num: str) -> FrameData:
        rs = png.read(prefix + f"{num}_rs.png")[..., :3]
        gs_path = prefix + f"{num}_initial_gs.png"
        gs = png.read(gs_path)[..., :3] if os.path.exists(gs_path) else None
        dep_path = prefix + f"{num}_initial_depth.png"
        dep = png.read(dep_path) if os.path.exists(dep_path) else None
        t = _read_csv_matrix(prefix + f"{num}_rs_t.csv")
        r = _read_csv_matrix(prefix + f"{num}_rs_r.csv").reshape(-1, 3, 3)
        h, w = rs.shape[:2]
        if r.shape[0] != h or t.shape[0] != h:
            raise ValueError(
                f"pose CSV rows ({r.shape[0]}/{t.shape[0]}) do not match "
                f"scanline count {h}")
        un = np.stack([_read_csv_matrix(prefix + f"{num}_rs_unproject_{n}.csv")
                       for n in "xyz"], axis=-1)
        gs_un = None
        if os.path.exists(prefix + f"{num}_initial_gs_unproject_x.csv"):
            gs_un = np.stack(
                [_read_csv_matrix(
                    prefix + f"{num}_initial_gs_unproject_{n}.csv")
                 for n in "xyz"], axis=-1)
        if un.shape[:2] != (h, w):
            raise ValueError(
                f"unprojection map {un.shape[:2]} does not match image "
                f"size {(h, w)}")
        return FrameData(rs_image=rs, gs_image=gs, depth_image=dep,
                         poses_r=r, poses_t=t, rs_unproject=un,
                         gs_unproject=gs_un)

    intr = Intrinsics.from_matrix(_read_csv_matrix(prefix + "A.csv"))

    def maybe(name):
        p = os.path.join(task_dir, name)
        return _read_csv_matrix(p) if os.path.exists(p) else None

    gamma, k, v, w = (maybe(n) for n in ("gamma.csv", "k.csv", "v.csv",
                                         "w.csv"))
    return PairData(
        frame1=load_frame("1"), frame2=load_frame("2"), intrinsics=intr,
        gamma=None if gamma is None else float(gamma[0, 0]),
        k=None if k is None else float(k[0, 0]),
        v=None if v is None else v.reshape(-1),
        w=None if w is None else w.reshape(-1))


def load_real_pair(data_prefix: str, intrinsics: Intrinsics) -> PairData:
    """A real pair: frame{1,2}.png and named intrinsics (setupCameraReal,
    src/main.cc:675-690)."""
    def frame(name):
        img = png.read(os.path.join(data_prefix, name))[..., :3]
        return FrameData(rs_image=img, gs_image=None, depth_image=None,
                         poses_r=None, poses_t=None, rs_unproject=None,
                         gs_unproject=None)

    return PairData(frame1=frame("frame1.png"), frame2=frame("frame2.png"),
                    intrinsics=intrinsics)


def true_depth_from_unprojection(unproj, poses_r, poses_t):
    """GT depth map: camera z of each unprojection point under its scanline
    pose (RsFrame::setSyntheticDepthMapRs, src/rsframe.cc:565-615).

    unproj (H, W, 3) world points (0 = void), poses_r (H, 3, 3), poses_t
    (H, 3) world->camera per scanline, as tensors; returns (H, W), 0 on void
    pixels.
    """
    r2 = poses_r[:, None, 2, :]  # (H, 1, 3): the z row of each scanline
    cam_z = (r2[..., 0] * unproj[..., 0] + r2[..., 1] * unproj[..., 1]
             + r2[..., 2] * unproj[..., 2]) + poses_t[:, None, 2]
    hit = torch.linalg.vector_norm(unproj, dim=-1) > 0
    return torch.where(hit, cam_z, torch.zeros_like(cam_z))
