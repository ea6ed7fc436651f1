"""Procedural synthetic rolling-shutter renderer (port of
rs_sfm_tpu/data/synthetic.py: the castle, mesh-grade castle, stress and
repetitive-texture scenes, the ray-cast render of a two-frame RS pair with
its ground truth, and the photometric and camera-pipeline nuisances).

The scene is a set of textured rectangles with closed-form ray
intersection, so every pixel of every scanline renders under its own pose
in one batched pass.  Conventions, as the JAX module's:

  * Poses are world->camera: X_cam = R X_world + t (src/rsframe.cc:687-708).
  * Scanline i of frame 1 is at normalized time τ = γ·i/H, of frame 2 at
    τ = 1 + γ·i/H, with pose R = R₀(I + β(τ)·ŵ), t = t₀ + β(τ)·v and
    β(τ) = (2/(2+k))(τ + ½kτ²) (calculate_camera_trajectory.m:17-26).
  * Void (sky) pixels get colour RGB(1,1,1)/255 (the mask value of the
    reference's backProject, src/rsframe.cc:815), zero depth and zero
    unprojection coordinates.

Device: the scene's tensors decide where a render runs.  A scene made with
no device, or given as numpy arrays, goes to the CUDA device, and without
one this raises; only tensors on the CPU render on the CPU (the tests).

Colour carries a hash texture (`_hash_noise`): `sin` of arguments up to a
few thousand times 43758.5, so in float32 one ulp of `sin` moves the
texture by about 1e-2.  Geometry (depth, unprojection, poses, hit mask)
does not depend on it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from rs_sfm_tpu_torch.flow.dense import as_device_tensor
from rs_sfm_tpu_torch.geom import so3
from rs_sfm_tpu_torch.geom.camera import Intrinsics, true_div
from rs_sfm_tpu_torch.geom.rspose import beta1, beta2
from rs_sfm_tpu_torch.ops import linalg, stencil


class Scene(NamedTuple):
    """Textured rectangles: X(a, b) = origin + a·edge1 + b·edge2, a,b ∈ [0,1].

    velocity (optional): per-rectangle world velocity (units per frame
    interval) of independently moving objects; None = static scene.
    periodic (optional): per-rectangle period of a strictly periodic
    texture (texture-coordinate units; 0 = the noise texture).
    """

    origins: torch.Tensor     # (P, 3)
    edge1: torch.Tensor       # (P, 3)
    edge2: torch.Tensor       # (P, 3)
    base_color: torch.Tensor  # (P, 3) in [0, 1]
    velocity: Optional[torch.Tensor] = None  # (P, 3) or None (static)
    periodic: Optional[torch.Tensor] = None  # (P,) or None


class SyntheticFrame(NamedTuple):
    rs_image: torch.Tensor      # (H, W, 3) in [0, 1]
    gs_image: torch.Tensor      # (H, W, 3) at this frame's scanline-0 pose
    rs_depth: torch.Tensor      # (H, W) camera z of each RS pixel (0 = void)
    gs_depth: torch.Tensor      # (H, W)
    rs_unproject: torch.Tensor  # (H, W, 3) world coords (0 = void)
    gs_unproject: torch.Tensor  # (H, W, 3)
    poses_r: torch.Tensor       # (H, 3, 3) world->camera per scanline (GT)
    poses_t: torch.Tensor       # (H, 3)
    mover_mask: Optional[torch.Tensor] = None  # (H, W) bool: hit a mover


class SyntheticPair(NamedTuple):
    frame1: SyntheticFrame
    frame2: SyntheticFrame
    intrinsics: Intrinsics
    gamma: float
    k: float
    v: torch.Tensor  # (3,) world units per frame interval
    w: torch.Tensor  # (3,) radians per frame interval


# The castle: ground, back wall, two building faces, a central tower and a
# slanted roof piece (origin, edge1, edge2, base colour).
_CASTLE = [
    ([-8.0, 2.0, 0.5], [16.0, 0.0, 0.0], [0.0, 0.0, 14.0],
     [0.45, 0.40, 0.30]),
    ([-8.0, -5.0, 11.0], [16.0, 0.0, 0.0], [0.0, 7.0, 0.0],
     [0.55, 0.50, 0.45]),
    ([-4.5, -3.0, 6.0], [3.2, 0.0, 0.0], [0.0, 5.0, 0.0],
     [0.60, 0.45, 0.35]),
    ([0.8, -2.0, 7.5], [3.5, 0.0, 0.0], [0.0, 4.0, 0.0],
     [0.40, 0.50, 0.60]),
    ([-0.7, -2.5, 4.5], [1.1, 0.0, 0.0], [0.0, 4.5, 0.0],
     [0.55, 0.55, 0.40]),
    ([0.4, -2.2, 4.8], [1.6, -0.4, 1.6], [0.0, 1.2, 0.4],
     [0.62, 0.38, 0.30]),
]


def castle_scene(dtype=torch.float32, device=None) -> Scene:
    """Default scene: a castle-like arrangement of facades, ground and
    tower (synthetic.py:85).  World frame = frame-1 scanline-0 camera frame
    (x right, y down, z forward); mean depth about 6."""
    return _scene(_CASTLE, dtype, device)


def _scene(rects, dtype, device, velocity=None) -> Scene:
    """A Scene from (origin, edge1, edge2, colour) rows of numbers."""
    cols = [as_device_tensor(np.array([r[i] for r in rects], np.float64),
                             device, dtype) for i in range(4)]
    vel = (None if velocity is None
           else as_device_tensor(np.array(velocity, np.float64),
                                 cols[0].device, dtype))
    return Scene(origins=cols[0], edge1=cols[1], edge2=cols[2],
                 base_color=cols[3], velocity=vel)


def repetitive_scene(dtype=torch.float32, device=None, *,
                     period: float = 0.045) -> Scene:
    """The castle with strictly periodic texture on its four wall
    rectangles (synthetic.py:123): every period-shifted displacement is a
    perfect photometric match (the aperture failure family of the relock
    pass, flow/relock.py); the ground and the roof keep the noise
    texture."""
    base = castle_scene(dtype, device)
    periodic = torch.tensor([0.0, period, period, period, period, 0.0],
                            dtype=dtype, device=base.origins.device)
    return base._replace(periodic=periodic)


def castle_mesh_scene(dtype=torch.float32, device=None, *,
                      seed: int = 0) -> Scene:
    """Mesh-grade castle (synthetic.py:139): ~120 faces with real depth
    discontinuities, the same geometry and colours as the JAX scene for a
    given seed (its rubble boxes come from numpy's default_rng(seed)).

    A keep and two towers of boxes with crenellated parapets (sliver
    occluders), a staircase, thin flag poles with flags, an overhanging
    balcony and scattered rubble boxes, over the ground and back wall.
    """
    rng = np.random.default_rng(seed)
    rects = []

    def rect(p0, e1, e2, color):
        rects.append((p0, e1, e2, color))

    def box_front_top(x0, y_top, z0, wx, hy, dz, color):
        """Front, top and left faces of an axis-aligned box (y down)."""
        rect([x0, y_top, z0], [wx, 0.0, 0.0], [0.0, hy, 0.0], color)
        rect([x0, y_top, z0], [wx, 0.0, 0.0], [0.0, 0.0, dz], color)
        rect([x0, y_top, z0], [0.0, 0.0, dz], [0.0, hy, 0.0], color)

    # Ground + back wall (the stage).
    rect([-8.0, 2.0, 0.5], [16.0, 0.0, 0.0], [0.0, 0.0, 14.0],
         [0.45, 0.40, 0.30])
    rect([-8.0, -5.0, 11.5], [16.0, 0.0, 0.0], [0.0, 7.0, 0.0],
         [0.50, 0.47, 0.44])
    # Central keep (front at z = 7) with a crenellated parapet.
    rect([-2.0, -2.6, 7.0], [4.0, 0.0, 0.0], [0.0, 4.6, 0.0],
         [0.58, 0.52, 0.42])
    rect([-2.0, -2.6, 7.0], [4.0, 0.0, 0.0], [0.0, 0.0, 1.6],
         [0.52, 0.47, 0.38])
    for i in range(7):
        box_front_top(-2.0 + 0.1 + i * 0.56, -3.05, 6.95, 0.28, 0.45, 0.35,
                      [0.56, 0.50, 0.40])
    # Balcony overhang on the keep (underside + front lip).
    rect([-1.2, -1.1, 6.45], [2.4, 0.0, 0.0], [0.0, 0.0, 0.55],
         [0.48, 0.42, 0.34])
    rect([-1.2, -1.1, 6.45], [2.4, 0.0, 0.0], [0.0, 0.35, 0.0],
         [0.50, 0.44, 0.36])
    # Two towers with parapets.
    for tx, tz, tw in ((-4.6, 5.6, 1.5), (3.1, 6.2, 1.4)):
        rect([tx, -3.4, tz], [tw, 0.0, 0.0], [0.0, 5.4, 0.0],
             [0.60, 0.46, 0.36])
        rect([tx, -3.4, tz], [tw, 0.0, 0.0], [0.0, 0.0, 1.2],
             [0.55, 0.42, 0.33])
        rect([tx + tw, -3.4, tz], [0.0, 0.0, 1.2], [0.0, 5.4, 0.0],
             [0.57, 0.44, 0.34])
        for i in range(4):
            box_front_top(tx + 0.05 + i * (tw - 0.3) / 3.0, -3.82, tz - 0.05,
                          0.22, 0.42, 0.3, [0.58, 0.44, 0.35])
    # Staircase up to the keep (8 steps: tread, riser).
    for i in range(8):
        sx, sw = 0.1, 1.3
        z = 5.8 - i * 0.28
        y = 2.0 - (i + 1) * 0.22
        rect([sx, y, z], [sw, 0.0, 0.0], [0.0, 0.0, 0.28],
             [0.47, 0.43, 0.36])
        rect([sx, y, z], [sw, 0.0, 0.0], [0.0, 0.22, 0.0],
             [0.44, 0.40, 0.34])
    # Flag poles (slivers) with flags on the keep and the towers.
    for px, pz in ((-0.1, 6.9), (-4.2, 5.55), (3.6, 6.15)):
        rect([px, -4.9, pz], [0.05, 0.0, 0.0], [0.0, 1.6, 0.0],
             [0.30, 0.28, 0.26])
        rect([px + 0.05, -4.85, pz], [0.45, 0.0, 0.0], [0.0, 0.3, 0.0],
             [0.70, 0.25, 0.20])
    # Rubble boxes on the ground (random sizes and depths).
    for _ in range(12):
        bx = rng.uniform(-5.5, 5.5)
        bz = rng.uniform(2.2, 9.5)
        bw = rng.uniform(0.25, 0.8)
        bh = rng.uniform(0.2, 0.6)
        bd = rng.uniform(0.25, 0.7)
        shade = rng.uniform(0.35, 0.65)
        box_front_top(bx, 2.0 - bh, bz, bw, bh, bd,
                      [shade, shade * 0.95, shade * 0.85])
    return _scene(rects, dtype, device)


def stress_scene(dtype=torch.float32, device=None, *, mover_speed=0.8,
                 foreground=True) -> Scene:
    """The castle plus rigidity breakers (synthetic.py:467): a near
    foreground slab (depth ~1.8) and two independently moving cards (world
    velocity `mover_speed` units per frame interval: one lateral, one
    diagonal towards the camera).  Pixels on movers are flagged in
    SyntheticFrame.mover_mask."""
    extra = [
        # foreground slab, bottom-left quadrant, very close
        ([-1.6, 0.45, 1.8], [0.9, 0.0, 0.0], [0.0, 0.75, 0.0],
         [0.85, 0.55, 0.35], [0.0, 0.0, 0.0]),
        # lateral mover: small card sweeping left to right mid-frame
        ([-0.55, -0.35, 3.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0],
         [0.25, 0.75, 0.9], [mover_speed, 0.0, 0.0]),
        # diagonal mover: drifting down-right and toward the camera
        ([0.35, -1.05, 4.2], [0.65, 0.0, 0.0], [0.0, 0.65, 0.0],
         [0.9, 0.35, 0.4], [-0.5 * mover_speed, 0.35 * mover_speed,
                            -0.4 * mover_speed]),
    ]
    if not foreground:
        extra = extra[1:]
    velocity = [[0.0] * 3] * len(_CASTLE) + [e[4] for e in extra]
    return _scene(_CASTLE + [e[:4] for e in extra], dtype, device, velocity)


def _hash_noise(u, v, seed):
    """Value noise on a texel grid: bilinear interpolation (smoothstep
    weights) of a sin-fract hash."""

    def hash2(i, j):
        s = torch.sin(i * 12.9898 + j * 78.233 + seed) * 43758.5453
        return s - torch.floor(s)

    iu = torch.floor(u)
    iv = torch.floor(v)
    fu = u - iu
    fv = v - iv
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    h00 = hash2(iu, iv)
    h10 = hash2(iu + 1.0, iv)
    h01 = hash2(iu, iv + 1.0)
    h11 = hash2(iu + 1.0, iv + 1.0)
    return ((1 - fu) * (1 - fv) * h00 + fu * (1 - fv) * h10
            + (1 - fu) * fv * h01 + fu * fv * h11)


def _texture(prim_id: int, a, b, base_color):
    """Procedural texture: multi-scale value noise + soft stripes, bounded
    away from black and from the void sentinel."""
    phase = torch.tensor(float(prim_id), dtype=a.dtype, device=a.device)
    n1 = _hash_noise(a * 9.0, b * 9.0, phase * 17.0) - 0.5
    n2 = _hash_noise(a * 27.0, b * 27.0, phase * 31.0 + 5.0) - 0.5
    f1 = torch.sin(2.0 * math.pi * (7.0 + 2.0 * phase) * a + phase * 1.7)
    checker = (torch.sin(2.0 * math.pi * 3.0 * a)
               * torch.sin(2.0 * math.pi * 3.0 * b))
    mod = 0.34 * n1 + 0.22 * n2 + 0.10 * f1 + 0.10 * checker
    tint = torch.tensor([1.0, 0.85, 0.7], dtype=a.dtype, device=a.device)
    col = base_color * (0.75 + mod[..., None] * tint)
    return torch.clamp(col, 0.02, 0.98)


def _texture_periodic(a, b, base_color, period: float):
    """Strictly periodic brick-like pattern of `period` (texture units): a
    soft-edged checker plus a grating, with no aperiodic part
    (synthetic.py:288)."""
    per = torch.tensor(period, dtype=a.dtype, device=a.device)
    pa = a / per
    pb = b / per
    sq = (torch.tanh(8.0 * torch.sin(2.0 * math.pi * pa))
          * torch.tanh(8.0 * torch.sin(2.0 * math.pi * pb)))
    grat = 0.3 * torch.sin(2.0 * math.pi * 2.0 * pa)
    mod = 0.30 * sq + grat
    tint = torch.tensor([1.0, 0.9, 0.8], dtype=a.dtype, device=a.device)
    col = base_color * (0.75 + mod[..., None] * tint)
    return torch.clamp(col, 0.02, 0.98)


def _dot(x, n):
    """x · n over the last axis, summed in index order."""
    return x[..., 0] * n[0] + x[..., 1] * n[1] + x[..., 2] * n[2]


def _intersect(scene: Scene, origin, direction, time=None):
    """Nearest-hit ray casting against all rectangles (synthetic.py:303).

    origin, direction: (..., 3) world rays, the direction scaled so that
    the camera z equals the ray parameter; time: (...,) per-ray capture
    time (frame intervals) for moving primitives.

    Returns (depth (...,), world point (..., 3), colour (..., 3), hit
    (...,), mover (...,) bool: the nearest hit was a moving primitive).
    """
    dtype = origin.dtype
    shape = origin.shape[:-1]
    best_t = torch.full(shape, torch.inf, dtype=dtype, device=origin.device)
    best_color = torch.ones(shape + (3,), dtype=dtype,
                            device=origin.device) / 255.0
    best_mover = torch.zeros(shape, dtype=torch.bool, device=origin.device)
    num_prims = scene.origins.shape[0]
    if scene.velocity is None or time is None:
        moving_flags = [False] * num_prims
    else:
        moving_flags = (scene.velocity != 0.0).any(dim=1).tolist()
    periods = ([0.0] * num_prims if scene.periodic is None
               else scene.periodic.tolist())
    for p in range(num_prims):
        p0 = scene.origins[p]
        if moving_flags[p]:
            p0 = p0 + time[..., None] * scene.velocity[p]
        e1 = scene.edge1[p]
        e2 = scene.edge2[p]
        n = torch.linalg.cross(e1, e2)
        denom = _dot(direction, n)
        safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                           denom)
        t = _dot(p0 - origin, n) / safe
        hit_pt = origin + t[..., None] * direction
        rel = hit_pt - p0
        a = _dot(rel, e1) / _dot(e1, e1)
        b = _dot(rel, e2) / _dot(e2, e2)
        ok = ((torch.abs(denom) >= 1e-12) & (t > 1e-3)
              & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0))
        closer = ok & (t < best_t)
        color = _texture(p, a, b, scene.base_color[p])
        if periods[p] > 0.0:
            color = _texture_periodic(a, b, scene.base_color[p], periods[p])
        best_color = torch.where(closer[..., None], color, best_color)
        best_t = torch.where(closer, t, best_t)
        best_mover = best_mover | closer if moving_flags[p] else (
            best_mover & ~closer)
    hit = torch.isfinite(best_t)
    depth = torch.where(hit, best_t, torch.zeros_like(best_t))
    world = torch.where(hit[..., None], origin + best_t[..., None] * direction,
                        torch.zeros_like(origin))
    return depth, world, best_color, hit, best_mover


def _row_poses(r0, t0, v, w, betas):
    """Poses R = R₀(I + β·ŵ), t = t₀ + β·v for a vector of β values."""
    n = betas.shape[0]
    r = torch.einsum("ij,njk->nik", r0,
                     so3.exp_first_order(w.expand(n, 3), scale=betas))
    t = t0[None, :] + betas[:, None] * v[None, :]
    return r, t


def _render(scene, intr: Intrinsics, rows, cols, r_rows, t_rows, dtype,
            times=None):
    """Render an image where row y uses pose (r_rows[y], t_rows[y]);
    broadcast single poses render a global-shutter image.  times: optional
    (H,) per-scanline capture times for moving primitives.

    Returns (colour, depth, world point, mover)."""
    dev = r_rows.device
    ys, xs = torch.meshgrid(torch.arange(rows, dtype=dtype, device=dev),
                            torch.arange(cols, dtype=dtype, device=dev),
                            indexing="ij")
    d_cam = torch.stack([true_div(xs - intr.cx, intr.fx),
                         true_div(ys - intr.cy, intr.fy),
                         torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    # Invert X_cam = R X + t exactly (R = I + βŵ is only orthonormal to
    # first order): camera centre o = −R⁻¹t, world direction d = R⁻¹ d_cam
    # (d_cam.z = 1, so the ray parameter is the camera depth).
    r_inv = linalg.gauss_inv(r_rows)  # (H, 3, 3)
    o = -torch.einsum("hij,hj->hi", r_inv, t_rows)  # (H, 3)
    d_world = torch.einsum("hij,hwj->hwi", r_inv, d_cam)  # (H, W, 3)
    origin = o[:, None, :].expand(d_world.shape)
    tgrid = None
    if times is not None:
        tgrid = times[:, None].expand(d_world.shape[:2])
    depth, world, color, _, mover = _intersect(scene, origin, d_world,
                                               time=tgrid)
    return color, depth, world, mover


def render_pair(scene: Scene, intr: Intrinsics, rows: int, cols: int, *,
                gamma: float, k: float, v, w, r0=None, t0=None,
                dtype=torch.float32) -> SyntheticPair:
    """Render a two-frame RS pair with complete ground truth
    (synthetic.py:406).

    Args:
      scene: the world geometry; its tensors' device is where the render
        runs (numpy arrays go to the CUDA device).
      intr: pinhole intrinsics; rows, cols: image size.
      gamma: readout ratio; k: acceleration factor of the motion model.
      v: (3,) linear velocity, w: (3,) angular velocity (radians), per
        frame interval.
      r0, t0: optional initial world->camera pose (default identity, zero).

    Returns a SyntheticPair with RS/GS images, depths, unprojection maps
    and per-scanline poses of both frames.
    """
    scene = Scene(*(None if f is None else as_device_tensor(f, dtype=dtype)
                    for f in scene))
    dev = scene.origins.device
    v = torch.as_tensor(v, dtype=dtype, device=dev)
    w = torch.as_tensor(w, dtype=dtype, device=dev)
    r0 = (torch.eye(3, dtype=dtype, device=dev) if r0 is None
          else torch.as_tensor(r0, dtype=dtype, device=dev))
    t0 = (torch.zeros(3, dtype=dtype, device=dev) if t0 is None
          else torch.as_tensor(t0, dtype=dtype, device=dev))
    idx = torch.arange(rows, dtype=dtype, device=dev)
    frames = []
    for beta_fn in (beta1, beta2):
        betas = beta_fn(idx, rows, gamma, k)
        r_rows, t_rows = _row_poses(r0, t0, v, w, betas)
        rs_img, rs_depth, rs_unproj, rs_mover = _render(
            scene, intr, rows, cols, r_rows, t_rows, dtype, times=betas)
        # The GS image at this frame's scanline-0 pose and instant.
        gs_img, gs_depth, gs_unproj, _ = _render(
            scene, intr, rows, cols, r_rows[0].expand(rows, 3, 3),
            t_rows[0].expand(rows, 3), dtype, times=betas[0].expand(rows))
        frames.append(SyntheticFrame(
            rs_image=rs_img, gs_image=gs_img, rs_depth=rs_depth,
            gs_depth=gs_depth, rs_unproject=rs_unproj,
            gs_unproject=gs_unproj, poses_r=r_rows, poses_t=t_rows,
            mover_mask=rs_mover))
    return SyntheticPair(frame1=frames[0], frame2=frames[1], intrinsics=intr,
                         gamma=gamma, k=k, v=v, w=w)


def apply_photometric(image, generator: Optional[torch.Generator] = None, *,
                      exposure=1.0, gamma_curve=1.0, vignette=0.0,
                      noise_sigma=0.0, noise=None, blur=False,
                      motion_blur_px=0.0, motion_blur_dir=(1.0, 0.35),
                      jpeg_quality=0, demosaic=False):
    """Photometric and camera-pipeline nuisances (synthetic.py:511), in
    the JAX package's order: a global exposure gain, a tone curve, radial
    vignetting, a motion-blur streak, a 3x3 defocus blur, Bayer RGGB
    sampling with a bilinear demosaic, Gaussian sensor noise, a clip, 8x8
    DCT quantization at a JPEG quality, and a clip.

    Args:
      image: (H, W, 3) in [0, 1]; a tensor stays on its device, anything
        else goes to the CUDA device.
      generator: torch.Generator on the image's device for the noise.
      noise: optional (H, W, 3) standard-normal draws that replace the
        generator's (the tests hand over the JAX package's).
      motion_blur_px: length (px) of a box streak along motion_blur_dir:
        the mean of max(ceil(px) + 1, 2) rolled copies, each shifted by
        the nearest integer of its point on the streak.
      blur: a separable [0.25, 0.5, 0.25] blur (rolled, so it wraps).
      demosaic: each channel sampled on its RGGB sites and refilled by a
        normalised bilinear convolution (edge-clamped).
      jpeg_quality: 1..100 (0 = off): per-channel 8x8 orthonormal DCT,
        quantized by the Annex-K table at libjpeg's quality scale.
    """
    img = as_device_tensor(image)
    dtype = img.dtype
    h, w = img.shape[:2]
    out = img * torch.tensor(exposure, dtype=dtype, device=img.device)
    if gamma_curve != 1.0:
        out = torch.clamp(out, 1e-6, 1.0) ** torch.tensor(
            gamma_curve, dtype=dtype, device=img.device)
    if vignette:
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=dtype, device=img.device),
            torch.arange(w, dtype=dtype, device=img.device), indexing="ij")
        r2 = (true_div(xs - w / 2, w / 2) ** 2
              + true_div(ys - h / 2, h / 2) ** 2) / 2.0
        out = out * (1.0 - torch.tensor(vignette, dtype=dtype,
                                        device=img.device) * r2)[..., None]
    if motion_blur_px > 0.0:
        d = np.asarray(motion_blur_dir, np.float64)
        d = d / max(np.linalg.norm(d), 1e-9)
        s_count = max(int(np.ceil(motion_blur_px)) + 1, 2)
        acc = None
        for s_i in range(s_count):
            frac = s_i / (s_count - 1) - 0.5
            dx = int(round(frac * motion_blur_px * d[0]))
            dy = int(round(frac * motion_blur_px * d[1]))
            tap = torch.roll(out, (dy, dx), (0, 1))
            acc = tap if acc is None else acc + tap
        out = true_div(acc, float(s_count))
    if blur:
        for axis in (0, 1):
            out = (0.25 * torch.roll(out, -1, axis) + 0.5 * out
                   + 0.25 * torch.roll(out, 1, axis))
    if demosaic:
        out = _bayer_demosaic(out)
    if noise_sigma:
        if noise is None:
            noise = torch.randn(out.shape, generator=generator, dtype=dtype,
                                device=img.device)
        out = out + noise_sigma * noise.to(dtype)
    out = torch.clamp(out, 0.0, 1.0)
    if jpeg_quality:
        out = _jpeg_quantize(out, int(jpeg_quality))
    return torch.clamp(out, 0.0, 1.0)


def _bayer_demosaic(img):
    """RGGB Bayer sampling + bilinear demosaic (synthetic.py:578): each
    channel keeps its sites and is refilled by a normalised convolution
    with [0.5, 1, 0.5] along both axes over edge-clamped shifts."""
    dtype = img.dtype
    h, w = img.shape[:2]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    even_y = (ys % 2) == 0
    even_x = (xs % 2) == 0
    r_site = even_y & even_x
    b_site = ~even_y & ~even_x
    g_site = ~(r_site | b_site)

    def blur1(x, axis):
        return (0.5 * stencil.shift(x, -1, axis) + 1.0 * x
                + 0.5 * stencil.shift(x, 1, axis))

    def fill(chan, site):
        m = site.to(dtype)
        num = blur1(blur1(chan * m, -2), -1)
        den = blur1(blur1(m, -2), -1)
        return num / torch.clamp(den, min=1e-6)

    return torch.stack([fill(img[..., 0], r_site), fill(img[..., 1], g_site),
                        fill(img[..., 2], b_site)], dim=-1)


# Standard JPEG luminance quantization table (Annex K).
_JPEG_Q = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)


def _dct_rows(c, x):
    """out[..., i, l] = sum_j c[i, j] x[..., j, l], the 8 products added in
    j order as elementwise operations: no matmul, so no TF32 on the card
    (whatever torch.backends.cuda.matmul allows) and the same rounding on
    the card as on the CPU."""
    out = c[:, 0, None] * x[..., 0, None, :]
    for j in range(1, 8):
        out = out + c[:, j, None] * x[..., j, None, :]
    return out


def jpeg_levels(img, quality: int):
    """(levels, table, basis): the quantized DCT levels round(C X C^T / q)
    of every 8x8 block and channel of an (H, W, 3) image in [0, 1], as
    (BH, BW, 3, 8, 8) floats, with the quality's table q (8, 8) and the
    DCT basis C (8, 8), in the image's dtype and device (synthetic.py:624).

    libjpeg's scale (q < 50: 5000 / q, else 200 - 2q) of the Annex-K
    table, floored and clipped to >= 1; the frame edge-padded to whole
    blocks; coefficients rounded half to even.  The two-sided product
    C X C^T runs as `_dct_rows` twice (rows, then columns)."""
    h, w = img.shape[:2]
    dtype = img.dtype
    dev = img.device
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    q = np.maximum(np.floor((_JPEG_Q * scale + 50.0) / 100.0), 1.0)
    hh, ww = h + (-h) % 8, w + (-w) % 8
    iy = torch.arange(hh, device=dev).clamp_(max=h - 1)
    ix = torch.arange(ww, device=dev).clamp_(max=w - 1)
    x = img.index_select(0, iy).index_select(1, ix)
    # Type-II orthonormal DCT basis.
    n_idx = np.arange(8)
    c = np.sqrt(2.0 / 8.0) * np.cos(
        np.pi * (2 * n_idx[None, :] + 1) * n_idx[:, None] / 16.0)
    c[0, :] = np.sqrt(1.0 / 8.0)
    cb = torch.tensor(c, dtype=dtype, device=dev)
    qb = torch.tensor(q, dtype=dtype, device=dev)

    blocks = (x * 255.0 - 128.0).reshape(hh // 8, 8, ww // 8, 8, 3)
    blocks = blocks.permute(0, 2, 4, 1, 3)  # (BH, BW, 3, 8, 8)
    # The transposes move the column index into the contracted place.
    coef = _dct_rows(cb, _dct_rows(cb, blocks).transpose(-1, -2))
    return torch.round(coef.transpose(-1, -2) / qb), qb, cb


def _jpeg_quantize(img, quality: int):
    """Per-channel 8x8 DCT quantization at a JPEG quality: the image of
    `jpeg_levels`' levels times the table, C^T Y C (synthetic.py:624)."""
    h, w = img.shape[:2]
    hh, ww = h + (-h) % 8, w + (-w) % 8
    levels, qb, cb = jpeg_levels(img, quality)
    coef = levels * qb
    ct = cb.transpose(0, 1)
    rec = _dct_rows(ct, _dct_rows(ct, coef).transpose(-1, -2))
    rec = rec.transpose(-1, -2)
    rec = rec.permute(0, 3, 1, 4, 2).reshape(hh, ww, 3)
    return torch.clamp(true_div(rec + 128.0, 255.0), 0.0, 1.0)[:h, :w]


def default_intrinsics(rows: int, cols: int) -> Intrinsics:
    """Square-pixel intrinsics with ~53° horizontal FoV, centred."""
    f = float(cols)
    return Intrinsics(fx=f, fy=f, cx=cols / 2.0 - 0.5, cy=rows / 2.0 - 0.5)
