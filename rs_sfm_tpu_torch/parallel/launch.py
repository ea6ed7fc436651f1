"""Run a function on S ranks of one host, one process each.

    results = spawn(fn, world_size, *args)

starts `world_size` processes with the "spawn" start method (a process
that has initialised CUDA cannot be forked), joins them in one gloo or NCCL
process group over a free localhost port, calls fn(rank, world_size, *args)
in each (its environment carries LOCAL_RANK and LOCAL_WORLD_SIZE, as
torchrun's ranks do), and returns the values in rank order.  `fn` and
`args` are pickled, so `fn` must be a module-level function; return CPU
tensors or numpy arrays.  A rank that raises makes `spawn` raise with its traceback; every
process is joined (or killed at the timeout) before `spawn` returns.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp

from rs_sfm_tpu_torch.parallel import distributed


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world_size, port, backend, fn, args, results):
    # One host thread per rank: the ranks share the host's cores.
    torch.set_num_threads(1)
    # The rank's place on the host, as torchrun gives it (global_mesh).
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        distributed.initialize(f"tcp://127.0.0.1:{port}", world_size, rank,
                               backend=backend)
        try:
            value = fn(rank, world_size, *args)
        finally:
            torch.distributed.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout_s: float = 600.0):
    """fn(rank, world_size, *args) on `world_size` new processes; returns
    [value of rank 0, value of rank 1, ...]."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, world_size, port, backend, fn, args,
                               results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    values, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        # Drain the queue before joining: a child blocks on exit until
        # what it put has been read.
        while len(values) < world_size and not errors:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that died before reporting (e.g. it could not
                # unpickle its function) never will.
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if dead:
                    errors.append(f"rank(s) {dead} exited without a result "
                                  f"(exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: no result within {timeout_s} s from "
                        f"{world_size - len(values)} rank(s)")
                continue
            if ok:
                values[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
    return [values[r] for r in range(world_size)]
