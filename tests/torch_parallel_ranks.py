"""Rank bodies of the multi-process tests of rs_sfm_tpu_torch.parallel
(tests/test_torch_parallel.py).

`rs_sfm_tpu_torch.parallel.launch.spawn` pickles a rank body by its module
path, and each rank imports that module afresh; this one imports torch,
numpy and the port only, so no rank loads JAX.  Each body runs on the CPU
over gloo and returns numpy arrays.
"""

import numpy as np
import torch
import torch.distributed as dist

from rs_sfm_tpu_torch.geom.camera import Intrinsics
from rs_sfm_tpu_torch.solver.beta import get_alpha, get_alpha_k
from rs_sfm_tpu_torch.solver.flow_model import predict_flow

# Each rank shares the CPU with the other ranks and the test workers.
torch.set_num_threads(2)

F, GAMMA = 70.0, 0.9


def intrinsics(h, w):
    return Intrinsics(fx=F, fy=F, cx=w / 2.0, cy=h / 2.0)


def rs_flow(h, w, seed=17):
    """(h, w, 2) float32 pixel flow of a random-depth scene under a rolling
    shutter (the fixed point of tests/test_torch_pipeline.py::_rs_flow)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    coords = torch.from_numpy(
        np.stack([(xs - w / 2.0) / F, (ys - h / 2.0) / F], -1).reshape(-1, 2))
    rho = torch.from_numpy(1.0 / rng.uniform(4.0, 9.0, size=h * w))
    v = torch.tensor([0.02, -0.01, 0.015], dtype=torch.float64)
    wr = torch.tensor([0.003, -0.002, 0.004], dtype=torch.float64)
    ys = torch.from_numpy(ys.reshape(-1))
    fl = torch.zeros((h * w, 2), dtype=torch.float64)
    for _ in range(6):
        a = get_alpha(fl[:, 1] * F, h, GAMMA)
        ak = get_alpha_k(ys, fl[:, 1] * F, h, GAMMA)
        fl = predict_flow(coords, rho, v, wr, 0.0, a, ak)
    return (fl * F).reshape(h, w, 2).numpy().astype(np.float32)


def _result(res):
    return {f: getattr(res, f).numpy() for f in res._fields}


def refine(rank, world, args, kwargs):
    """refine_pallas_multi_sharded on this rank's contiguous block of the
    pixels in `args` (coords, flow, alpha, alpha_k, masks, v0, w0, k0,
    rho0; the pixel count divisible by the world size)."""
    from rs_sfm_tpu_torch.solver.refine_fused import (
        refine_pallas_multi_sharded)

    coords, flow, alpha, alpha_k, masks, v0, w0, k0, rho0 = (
        torch.from_numpy(a) for a in args)
    n = coords.shape[0] // world
    blk = slice(rank * n, (rank + 1) * n)
    res = refine_pallas_multi_sharded(
        coords[blk], flow[blk], alpha[blk], alpha_k[blk], masks[:, blk], v0,
        w0, k0, rho0[:, blk], group=dist.group.WORLD, **kwargs)
    return _result(res)


def pool(rank, world, n, size):
    """shared_sample_pool of a block whose values encode (rank, pixel)."""
    from rs_sfm_tpu_torch.solver.ransac import shared_sample_pool

    pix = torch.arange(n, dtype=torch.float32) + 1000.0 * rank
    coords = torch.stack([pix, -pix], dim=1)
    flow = torch.stack([pix + 0.5, pix - 0.5], dim=1)
    valid = (torch.arange(n) + rank) % 3 != 0
    out = shared_sample_pool(coords, flow, pix * 2.0, pix * 3.0, valid, size,
                             dist.group.WORLD)
    return [t.numpy() for t in out]


def estimate(rank, world, flow, cfg, sample_indices, pool_per_shard,
             warm_cfg, warm_start):
    """estimate_sharded over the world group, then, given a warm start (H
    divisible by the world size), a warm-started estimation under the
    group on the rank's block; this rank's two results."""
    from rs_sfm_tpu_torch.parallel.api import block_rows, estimate_sharded
    from rs_sfm_tpu_torch.solver.pipeline import estimate_from_flow

    h, w = flow.shape[:2]
    intr = intrinsics(h, w)
    run = estimate_sharded(dist.group.WORLD, intr, GAMMA, cfg,
                           pool_per_shard=pool_per_shard)
    gen = torch.Generator().manual_seed(5)
    res = run(torch.from_numpy(flow), gen, sample_indices=sample_indices)
    if warm_start is None:
        return _result(res), None
    row0, rows = block_rows(h, world, rank)
    warm = estimate_from_flow(
        torch.from_numpy(flow[row0:row0 + rows]), intr, GAMMA, warm_cfg,
        group=dist.group.WORLD, row_offset=row0, total_rows=h,
        warm_start=tuple(torch.as_tensor(a) for a in warm_start))
    return _result(res), _result(warm)


def pairs(rank, world, flows, cfg, sample_indices, pool_per_shard):
    """estimate_pairs_batched on a (world, 1) mesh; also checks that
    make_mesh refuses a layout of the wrong size."""
    from rs_sfm_tpu_torch.parallel.api import estimate_pairs_batched
    from rs_sfm_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(pairs=world + 1)
    except ValueError:
        refused = True
    else:
        refused = False
    mesh = make_mesh(pairs=world)
    h, w = flows.shape[1:3]
    run = estimate_pairs_batched(mesh, intrinsics(h, w), GAMMA, cfg,
                                 pool_per_shard=pool_per_shard)
    res = run(torch.from_numpy(flows), sample_indices=sample_indices)
    return refused, mesh.shape, _result(res)
