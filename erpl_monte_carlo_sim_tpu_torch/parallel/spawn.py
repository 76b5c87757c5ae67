"""Ranks started from one process: ``run_ranks(fn, world_size, ...)``.

The port's multi-process runs are launched by ``torchrun`` (one process per
card: ``torchrun --nproc-per-node G -m
erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale N``) or, from a program
that holds the work in Python, by ``run_ranks``: it starts ``world_size``
processes with ``torch.multiprocessing``'s ``spawn`` method (the parent may
have touched CUDA), joins them into one ``torch.distributed`` group over a
TCP store on a free localhost port (``init_distributed``), calls
``fn(mesh, *args)`` in each, and returns each rank's result in rank order.
A rank that raises or dies ends every rank, and ``run_ranks`` raises with
its traceback; so does a run that outlives ``timeout_s``. Nothing is
retried on fewer ranks or on another device.

``fn`` is pickled by its import path, so it is a module-level function of a
module the children can import (a child imports nothing of the parent's
``__main__`` guard); a child imports only what ``fn``'s module imports.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from typing import Optional

__all__ = ["free_port", "run_ranks"]


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, args, world: int, port: int, backend, device, tmp: str) -> None:
    """A child: join the group, run ``fn``, pickle its result to
    ``tmp/rank{rank}.pkl``. An exception reaches the parent through
    ``torch.multiprocessing``."""
    import torch.distributed as dist

    from .mesh import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend, device=device)
    result = fn(make_mesh(), *args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn, world_size: int, *args, backend: Optional[str] = None, device=None,
              timeout_s: float = 600.0) -> list:
    """``fn(mesh, *args)`` on ``world_size`` spawned ranks; their results in
    rank order. ``device``: every rank's device (``"cuda:0"`` puts every
    rank on one card), default the card of index rank modulo the cards;
    ``backend``: default NCCL on a card, Gloo on the CPU."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = mp.start_processes(_rank_main, nprocs=world_size, join=False, daemon=True,
                                 args=(fn, args, world_size, free_port(), backend, device, tmp))
        deadline = time.monotonic() + timeout_s
        try:
            # join returns when one rank ends; it raises when one failed,
            # after ending the others
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} of {world_size} failed: {e}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
