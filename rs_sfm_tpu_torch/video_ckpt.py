"""Long sequences in windows, with a checkpoint a window and resume
(port of rs_sfm_tpu/video_ckpt.py).

The P pairs of a sequence run in windows of `window` pairs through
video.estimate_video; each window's result is saved to `ckpt_dir` before
the next starts.  A run that stops (a crash, a preemption) resumes at the
first window with no checkpoint: saved windows are restored, not
recomputed.

Checkpoints are numpy archives of host arrays (`window_000000.npz`, ...),
in place of the JAX package's orbax manager (the card's machine has no
orbax).  Each is written to a temporary file in the directory and moved
into place with os.replace, so a crash leaves only whole windows.  With
save_depth=False a checkpoint holds the motions only (KB a pair instead of
MB), and a restored window's depth maps are recomputed from its flow and
motion (`recompute_depth_maps`, bit-identical to the estimation's).

The last window is padded with zero flows to `window` pairs (as the JAX
package pads it for its fixed-shape jit) and the padding dropped, so pair
j of window wi draws from the same generator however the sequence ends:
fold_generator(fold_generator(generator, wi), j).

The JAX package overlaps window wi + 1's upload and compute with window
wi's checkpoint write through asynchronous dispatch.  The port does not:
its estimation synchronises the host inside every pair (RANSAC copies its
diversity scan to the host), so no queue of device work is there to
overlap, and a window's flows are a few MB against seconds of estimation.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.flow.dense import as_device_tensor
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver import pipeline
from rs_sfm_tpu_torch.solver.ransac import _score_hypotheses
from rs_sfm_tpu_torch.video import VideoResult, estimate_video


def recompute_depth_maps(flows, video: VideoResult, intr: Intrinsics, gamma,
                         cfg: PipelineConfig) -> torch.Tensor:
    """The per-pair depth maps from the flows and the stored motions.

    Depth is closed-form given (flow, v, w, k): the estimation exports
    1/ρ of the closed-form ρ at its final model on the inliers of that
    model (pipeline.depth_export_mask).  This runs the same operations on
    the stored model; the stored v
    carries the estimation's sign flip, which negates ρ exactly, so the
    maps are bit-identical to the estimation's.  Pairs that are not ok get
    zeros (as the estimation's are zeroed).

    Returns (P, H, W) on the flows' device (an array goes to the CUDA
    device)."""
    flows = as_device_tensor(flows, dtype=torch.float32)
    dev = flows.device
    out = []
    for i in range(flows.shape[0]):
        flow = flows[i]
        h, w_cols = flow.shape[:2]
        prepared = pipeline.prepare_flow_inputs(flow, intr, gamma, cfg)
        v, w, k = (torch.as_tensor(getattr(video, f)[i], device=dev).to(
            flow.dtype) for f in ("v", "w", "k"))
        _, _, rho, inl = _score_hypotheses(*prepared, v[None], w[None],
                                           k.reshape(1), cfg.ransac_tol)
        rho = rho[0]
        safe = torch.where(rho == 0.0, torch.ones_like(rho), rho)
        z = torch.where(rho == 0.0, torch.zeros_like(rho), 1.0 / safe)
        sel = pipeline.depth_export_mask(prepared, rho, v, w, k, inl[0], intr,
                                         cfg)
        ok = torch.as_tensor(video.ok[i], device=dev)
        out.append(torch.where(sel & ok, z, torch.zeros_like(z)).reshape(
            h, w_cols))
    return torch.stack(out)


def _path(ckpt_dir: str, wi: int) -> str:
    return os.path.join(ckpt_dir, f"window_{wi:06d}.npz")


def _save(ckpt_dir: str, wi: int, res: VideoResult, save_depth: bool):
    """Window wi's result to its archive, atomically (temporary file, then
    os.replace)."""
    arrays = {f: getattr(res, f).cpu().numpy() for f in VideoResult._fields
              if save_depth or f != "depth_maps"}
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=ckpt_dir)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, _path(ckpt_dir, wi))
    except BaseException:
        os.unlink(tmp)
        raise


def _restore(ckpt_dir: str, wi: int):
    """Window wi's saved arrays, as CPU tensors ({field: tensor})."""
    with np.load(_path(ckpt_dir, wi)) as z:
        return {f: torch.from_numpy(z[f]) for f in z.files}


def process_video_checkpointed(
        flows, intr: Intrinsics, gamma, cfg: PipelineConfig,
        generator: Optional[torch.Generator] = None, *, ckpt_dir: str,
        window: int = 8, min_inliers: int = 32, save_depth: bool = True,
        on_window: Optional[Callable[[int, VideoResult], None]] = None,
) -> VideoResult:
    """Estimate every pair of a long sequence with a checkpoint a window.

    Args:
      flows: (P, H, W, 2) per-pair flows: a tensor (windows are sliced on
        its device) or an array (each window goes to the CUDA device).
      intr, gamma, cfg: as in video.estimate_video; window wi draws from
        fold_generator(generator, wi).
      ckpt_dir: checkpoint directory; windows saved there are restored
        instead of recomputed.
      window: pairs a window (the last one padded and masked).
      min_inliers: the fault-isolation threshold a pair.
      save_depth: keep the depth maps in the checkpoints; without them a
        restored window's maps are recomputed (recompute_depth_maps).
      on_window: optional callback(window_index, window_result), after the
        window is saved or restored.

    Returns:
      VideoResult over all P pairs, as CPU tensors.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    if not torch.is_tensor(flows):
        flows = np.asarray(flows, np.float32)
    p = flows.shape[0]
    chunks = []
    for wi in range(-(-p // window)):
        lo, hi = wi * window, min((wi + 1) * window, p)
        if os.path.exists(_path(ckpt_dir, wi)):
            tree = _restore(ckpt_dir, wi)
            if "depth_maps" not in tree:
                tree["depth_maps"] = recompute_depth_maps(
                    flows[lo:hi], VideoResult(depth_maps=None, **tree), intr,
                    gamma, cfg).cpu()
            res = VideoResult(**tree)
        else:
            fw = as_device_tensor(flows[lo:hi], dtype=torch.float32)
            if hi - lo < window:
                fw = torch.cat([fw, fw.new_zeros(
                    (window - (hi - lo),) + tuple(fw.shape[1:]))])
            out = estimate_video(fw, intr, gamma, cfg,
                                 pipeline.fold_generator(generator, wi),
                                 min_inliers=min_inliers)
            res = VideoResult(*(t[:hi - lo].cpu() for t in out))
            _save(ckpt_dir, wi, res, save_depth)
        if on_window is not None:
            on_window(wi, res)
        chunks.append(res)
    return VideoResult(*(torch.cat([getattr(c, f) for c in chunks])
                         for f in VideoResult._fields))
