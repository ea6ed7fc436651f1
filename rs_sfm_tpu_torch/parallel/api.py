"""Sharded estimation entry points (port of rs_sfm_tpu/parallel/api.py).

  estimate_sharded -- the scanline blocks of one frame pair over the ranks
      of a process group.  Every rank holds the whole flow field and runs
      solver.pipeline.estimate_from_flow on its block of rows with the
      group: RANSAC draws from a pool shared by all ranks and sums its votes
      in one all-reduce per stage (the prescore's too), the k-scan
      all-reduces each fit's Gram and each cost, each LM iteration
      all-reduces its sums once (the fused engine's (J, 71) sums, the
      "xla" engine's two Gram products) and its cost, and the re-votes and
      the sign flip sum over the group.  Every PipelineConfig option runs.
      Scalar outputs are the same on every rank; per-pixel outputs are the
      rank's rows.

  estimate_pairs_batched -- frame pairs split over the `pairs` axis of a
      mesh, each pair sharded over the mesh's `pixels` axis; the results are
      gathered on every rank by all-reduce of zero-padded slots (gloo has no
      all-gather of CUDA tensors).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from rs_sfm_tpu_torch.config import PipelineConfig
from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.parallel.distributed import axis_index, axis_size, psum
from rs_sfm_tpu_torch.parallel.mesh import Mesh
from rs_sfm_tpu_torch.solver.pipeline import (EstimationResult,
                                              estimate_from_flow)

_PER_PIXEL = ("depth_map", "inlier_mask", "valid_mask")


def block_rows(h: int, n_shards: int, index: int):
    """(first row, rows) of scanline block `index` of an image of h rows
    padded to a multiple of n_shards; rows counts only real rows (the last
    blocks may hold padding alone)."""
    rows = -(-h // n_shards)
    row0 = index * rows
    return row0, max(0, min(rows, h - row0))


def pool_pixels(h: int, w: int, n_shards: int, pool_per_shard: int):
    """Flat pixel index, in the unpadded (h, w) image, of each slot of the
    sample pool that `estimate_sharded` shares over n_shards ranks (numpy
    int64; h*w or more for a slot in the padding rows).  Draws into the
    pool name the same pixels as these indices into the whole image."""
    rows = -(-h // n_shards)
    n_loc = rows * w
    size = min(pool_per_shard, n_loc)
    local = (np.arange(size) * max(n_loc // size, 1)) % n_loc
    return np.concatenate([s * rows * w + local for s in range(n_shards)])


def estimate_sharded(group_or_mesh, intr: Intrinsics, gamma,
                     cfg: PipelineConfig, *, pool_per_shard: int = 1024,
                     total_rows: int = None):
    """Build the scanline-block sharded estimator of one pair.

    Args:
      group_or_mesh: a process group, or a Mesh (its pixels axis is used).
      intr, gamma, cfg: as estimate_from_flow.
      pool_per_shard: RANSAC sample-pool pixels per rank.
      total_rows: the image's row count for α/α̃ (default: the flow's).

    Returns run(flow (H, W, 2), generator=None, *, sample_indices=None) ->
    EstimationResult, to be called on every rank of the group with the same
    flow.  H need not divide the group size: the rows are padded with zero
    flow, which is invalid under cfg.flow_threshold and so adds to no sum,
    and the per-pixel outputs are cropped to the rank's real rows.  The
    draws of `generator` on the group's first rank are used by all;
    `sample_indices` index the shared pool.
    """
    group = (group_or_mesh.pixels_group if isinstance(group_or_mesh, Mesh)
             else group_or_mesh)
    if group is None:
        raise ValueError("estimate_sharded needs a process group")
    if pool_per_shard != cfg.ransac_sample_pool:
        cfg = dataclasses.replace(cfg, ransac_sample_pool=pool_per_shard)

    def run(flow, generator=None, *, sample_indices=None) -> EstimationResult:
        n_shards = axis_size(group)
        h = flow.shape[0]
        hp = -(-h // n_shards) * n_shards
        if hp != h:
            pad = flow.new_zeros((hp - h,) + flow.shape[1:])
            flow = torch.cat([flow, pad])
        row0, keep = block_rows(h, n_shards, axis_index(group))
        rows = hp // n_shards
        res = estimate_from_flow(
            flow[row0:row0 + rows], intr, gamma, cfg, generator,
            sample_indices=sample_indices, group=group, row_offset=row0,
            total_rows=total_rows if total_rows is not None else h)
        if keep != rows:
            res = res._replace(**{f: getattr(res, f)[:keep]
                                  for f in _PER_PIXEL})
        return res

    return run


def estimate_pairs_batched(mesh: Mesh, intr: Intrinsics, gamma,
                           cfg: PipelineConfig, *,
                           pool_per_shard: int = 1024):
    """Build the pair-batched estimator over a (pairs, pixels) mesh.

    Returns run(flow_batch (B, H, W, 2), generators=None, *,
    sample_indices=None) -> EstimationResult with a leading batch axis B
    and full (H, W) maps, the same on every rank.  B must divide by the
    pairs axis: pair slot p takes pairs p·B/P .. (p+1)·B/P - 1, each one
    sharded over the pixels axis.  `generators` (B torch.Generators) or
    `sample_indices` (B, trials, 9; indices into each pair's shared pool)
    give each pair its draws.
    """
    sharded = estimate_sharded(mesh, intr, gamma, cfg,
                               pool_per_shard=pool_per_shard)

    def run(flow_batch, generators=None, *,
            sample_indices=None) -> EstimationResult:
        b, h = flow_batch.shape[:2]
        if b % mesh.pairs:
            raise ValueError(f"batch {b} not divisible by pairs={mesh.pairs}")
        per = b // mesh.pairs
        row0, keep = block_rows(h, mesh.pixels, mesh.pixel_index)
        slots = None
        for i in range(per):
            pair = mesh.pair_index * per + i
            res = sharded(
                flow_batch[pair],
                None if generators is None else generators[pair],
                sample_indices=(None if sample_indices is None
                                else sample_indices[pair]))
            if slots is None:
                slots = {f: torch.zeros(
                    (b, h) + getattr(res, f).shape[1:] if f in _PER_PIXEL
                    else (b,) + getattr(res, f).shape,
                    dtype=_wire_dtype(getattr(res, f)),
                    device=flow_batch.device) for f in res._fields}
            for f in res._fields:
                value = getattr(res, f).to(slots[f].dtype)
                if f in _PER_PIXEL:
                    slots[f][pair, row0:row0 + keep] = value
                elif mesh.pixel_index == 0:
                    # Scalars are replicated over the pixels axis: one
                    # rank of each pair writes them.
                    slots[f][pair] = value
        # Sum the slots over every rank of the mesh (both axes).
        out = {f: psum(t, dist.group.WORLD) for f, t in slots.items()}
        for f in ("inlier_mask", "valid_mask"):
            out[f] = out[f] > 0
        out["num_inliers"] = out["num_inliers"].to(torch.int32)
        return EstimationResult(**out)

    return run


def _wire_dtype(t):
    """Bool masks travel as int32 (the collectives sum numbers)."""
    return torch.int32 if t.dtype == torch.bool else t.dtype
