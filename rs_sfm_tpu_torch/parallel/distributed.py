"""Process-group runtime and the collectives the sharded pipeline calls
(port of rs_sfm_tpu/parallel/distributed.py and of the `lax.psum` /
`axis_index` uses of the JAX pipeline).

Ranks are processes, one per shard, joined by `torch.distributed`.  The
pipeline uses only `all_reduce` and `broadcast`, the two collectives that
the gloo backend runs on CUDA tensors as well as CPU ones, so the same code
runs over gloo (CPU tests; two ranks sharing one card) and NCCL (one card
per rank).  A `group` of None means "not sharded": every collective is then
the identity and no process group is needed.

Launched by torchrun (one command per host), a rank calls `initialize()`
with no arguments and `global_mesh()` for the JAX package's multi-host
layout: frame pairs across hosts, scanline blocks within one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch.distributed as dist

# What torchrun sets in each rank's environment (the env:// rendezvous).
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               *, backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Join the default process group.

    Args:
      init_method: rendezvous address, e.g. "tcp://127.0.0.1:29500"; with
        world_size and rank all None, torchrun's environment is read
        (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; "env://").
      world_size, rank: this run's process count and this process's rank.
      backend: "gloo" (CPU and CUDA tensors) or "nccl" (one card per rank).
      timeout_s: collective timeout.

    Raises whatever the rendezvous raises, RuntimeError when a group is
    already initialised or, with no arguments, when torchrun's variables
    are absent: a process that cannot join its group stops here rather
    than running on alone.
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    if init_method is None and world_size is None and rank is None:
        missing = [v for v in _TORCHRUN_ENV if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize() without arguments reads torchrun's "
                f"environment, and {', '.join(missing)} is not set; give "
                f"init_method, world_size and rank")
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    elif init_method is None or world_size is None or rank is None:
        raise ValueError("give init_method, world_size and rank together, "
                         "or none of them")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world size {world_size}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def axis_size(group) -> int:
    """Number of ranks in `group` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank within `group` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def psum(x, group):
    """Sum of `x` over the ranks of `group` (`x` itself for None).  Every
    rank receives the same bits.  `x` is not modified."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast(x, group):
    """The value of `x` on `group`'s first rank, on every rank of `group`
    (`x` itself for None).  `x` is not modified."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


def global_mesh(pairs: Optional[int] = None):
    """The (pairs, pixels) mesh over every rank of the default group (the
    JAX package's `global_mesh`).

    `pairs` defaults to the number of hosts, world size / LOCAL_WORLD_SIZE
    (torchrun's ranks per host; `launch.spawn` sets it too), so frame pairs
    split across hosts and the per-iteration all-reduces of one pair's
    scanline blocks stay within a host.  Raises RuntimeError when `pairs`
    is None and LOCAL_WORLD_SIZE is not set, and ValueError when it does
    not divide the world.
    """
    from rs_sfm_tpu_torch.parallel.mesh import make_mesh

    if pairs is None:
        if "LOCAL_WORLD_SIZE" not in os.environ:
            raise RuntimeError("global_mesh() needs LOCAL_WORLD_SIZE (the "
                               "ranks of one host) or an explicit pairs")
        local = int(os.environ["LOCAL_WORLD_SIZE"])
        world = dist.get_world_size()
        if local <= 0 or world % local:
            raise ValueError(f"{world} ranks are not whole hosts of {local}")
        pairs = world // local
    return make_mesh(pairs=pairs)
