"""Process-group runtime and the collectives the sharded pipeline calls
(port of rs_sfm_tpu/parallel/distributed.py and of the `lax.psum` /
`axis_index` uses of the JAX pipeline).

Ranks are processes, one per shard, joined by `torch.distributed`.  The
pipeline uses only `all_reduce` and `broadcast`, the two collectives that
the gloo backend runs on CUDA tensors as well as CPU ones, so the same code
runs over gloo (CPU tests; two ranks sharing one card) and NCCL (one card
per rank).  A `group` of None means "not sharded": every collective is then
the identity and no process group is needed.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Join the default process group.

    Args:
      init_method: rendezvous address, e.g. "tcp://127.0.0.1:29500".
      world_size, rank: this run's process count and this process's rank.
      backend: "gloo" (CPU and CUDA tensors) or "nccl" (one card per rank).
      timeout_s: collective timeout.

    Raises whatever the rendezvous raises, and RuntimeError when a group is
    already initialised: a process that cannot join its group stops here
    rather than running on alone.
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
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
