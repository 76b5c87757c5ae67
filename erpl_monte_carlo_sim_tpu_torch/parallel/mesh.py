"""Lane meshes over ``torch.distributed`` (``erpl_monte_carlo_sim_tpu/parallel/mesh.py``).

The one parallelism of a Monte Carlo run is over its lanes. The JAX package
puts the lane axis on a 1-D ``jax.sharding.Mesh`` and lets XLA insert the
collectives; the port runs one process per device (a rank), and each rank
holds one contiguous block of lanes, in rank order, so that the ranks'
blocks concatenated are the global batch in lane order. A ``LaneMesh`` is
the process group, this rank, the group's size and this rank's device; the
collectives of ``parallel.sharded`` run ``torch.distributed`` calls over it
(NCCL between cards, Gloo on the CPU or where a caller asks for it).
``shard_batch`` takes a rank's block of a global batch, ``make_global_batch``
and ``replicate`` give every rank the same global value.

``init_distributed`` joins a job, from a coordinator's address or from the
environment ``torchrun`` sets; it binds this process to its device and
never moves a run the caller meant for a card onto the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import is_static

__all__ = ["BATCH_AXIS", "LaneMesh", "init_distributed", "make_mesh", "pad_to_devices",
           "shard_batch", "replicate", "make_global_batch", "lane_block", "broadcast_object"]

BATCH_AXIS = "batch"

# the device init_distributed bound this process to: make_mesh's default, as
# the default process group is torch.distributed's
_bound_device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """The lanes' mesh: ``group`` (a ``torch.distributed`` process group, or
    None for a single rank without one), this process's ``rank`` in it, its
    ``size`` and this rank's ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.size}


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index; a card that is asked
    for and missing raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for and no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device}: the machine has "
                               f"{torch.cuda.device_count()} CUDA devices")
    return device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None) -> int:
    """Join a ``torch.distributed`` job and return this process's rank (JAX
    ``init_distributed``). With no coordinator and no ``torchrun``
    environment (``RANK``/``WORLD_SIZE``) it does nothing and returns 0.

    ``coordinator_address`` (``host:port``, rank 0's TCP store) needs
    ``num_processes`` and ``process_id``; under ``torchrun`` the rank, the
    world size and ``MASTER_ADDR``/``MASTER_PORT`` come from the
    environment. ``device`` defaults to the card of index ``LOCAL_RANK``
    (else the rank modulo the cards); ``backend`` to NCCL on a card and Gloo
    on the CPU. Gloo over CUDA tensors (staged through the host) is used
    only where a caller names it. A failed initialisation raises: nothing
    falls back to the CPU or to a single rank."""
    global _bound_device

    env_rank = os.environ.get("RANK")
    env_world = os.environ.get("WORLD_SIZE")
    if coordinator_address is None and num_processes is None and env_rank is None:
        return 0
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        if env_rank is None or env_world is None:
            raise ValueError("num_processes without a coordinator address needs the "
                             "torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        init_method = "env://"
        world, rank = int(env_world), int(env_rank)
        if num_processes is not None and int(num_processes) != world:
            raise ValueError(f"num_processes={num_processes}, but WORLD_SIZE={world}")
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a world of {world}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = _resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError("a different process group is already initialised")
    else:
        # NCCL binds its communicator to the rank's card up front
        bind = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                **bind)
    _bound_device = device
    return rank


def make_mesh(device=None) -> LaneMesh:
    """The lane mesh of the process group of ``init_distributed``, or of
    this process alone when no group is up. ``device`` defaults to the one
    ``init_distributed`` bound, else the current card (the port's entry
    points run on the card unless asked for the CPU)."""
    if device is None:
        device = _bound_device if _bound_device is not None else "cuda"
    device = _resolve_device(device)
    if not dist.is_initialized():
        return LaneMesh(None, 0, 1, device)
    return LaneMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device)


def pad_to_devices(n: int, mesh: LaneMesh) -> int:
    """Smallest multiple of the mesh's size >= n (lane padding)."""
    return ((n + mesh.size - 1) // mesh.size) * mesh.size


def lane_block(n: int, mesh: LaneMesh) -> slice:
    """This rank's contiguous block of ``n`` global lanes. A batch that does
    not split evenly over the ranks raises, as the JAX package's
    ``device_put`` onto ``P("batch")`` refuses an uneven dimension: pad it
    (``pad_to_devices``) or choose a multiple of the mesh's size."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} lanes does not split evenly over {mesh.size} ranks; "
                         f"use a multiple of {mesh.size} (pad_to_devices)")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


# ------------------------------------------------------------- tree walking
def _map(fn, tree, base=None, has_base=False):
    """``fn(leaf, base_leaf)`` over every tensor or array leaf of dataclasses,
    dicts, tuples and lists; other leaves (static fields, None) pass.
    ``base`` is the unbatched twin of ``tree`` (``has_base``), walked
    alongside."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, base)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kw = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            kw[f.name] = _map(fn, v, getattr(base, f.name) if has_base else None, has_base) \
                if not is_static(f) else v
        return type(tree)(**kw)
    if isinstance(tree, dict):
        return {k: _map(fn, v, base[k] if has_base else None, has_base) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, base[i] if has_base else None, has_base)
                          for i, v in enumerate(tree))
    return tree


def _is_batched(x, base, batch: int, has_base: bool) -> bool:
    """A leaf is batched when it gained a dimension over its base leaf (the
    rule of the JAX package's ``mc.scene_in_axes``), or, without a base tree, when its leading
    dimension is the batch (the JAX package's shape rule, which takes a
    shared leaf of that length for a batched one)."""
    if has_base:
        return np.ndim(x) > np.ndim(base)
    return np.ndim(x) >= 1 and x.shape[0] == batch


def shard_batch(tree, mesh: LaneMesh, batch_size: int, base_tree=None):
    """This rank's block (``lane_block``) of every leaf with the batch axis
    of a global batch of ``batch_size`` lanes; every other leaf stays as it
    is. ``base_tree`` classifies by gained dimension (``make_global_batch``);
    without it a leaf is batched when its leading dimension is
    ``batch_size``."""
    block = lane_block(batch_size, mesh)
    has_base = base_tree is not None

    def put(x, base):
        return x[block] if _is_batched(x, base, batch_size, has_base) else x

    return _map(put, tree, base_tree, has_base)


def _to_device(x, mesh: LaneMesh) -> torch.Tensor:
    return torch.as_tensor(x).to(mesh.device)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: contiguous, bool as uint8."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_gather_lanes(t: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank; the list form of ``all_gather``, which NCCL and
    Gloo (also over CUDA tensors) both take."""
    if mesh.group is None:
        return t
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_reduce(t: torch.Tensor, mesh: LaneMesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks (a new tensor; ``t`` is left as it is,
    and returned without a group)."""
    if mesh.group is None:
        return t
    w = _wire(t).clone()
    dist.all_reduce(w, op=op, group=mesh.group)
    return w


def broadcast(t: torch.Tensor, mesh: LaneMesh) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (a new tensor)."""
    if mesh.group is None:
        return t
    w = _wire(t).clone()
    dist.broadcast(w, src=0, group=mesh.group)
    return w.to(torch.bool) if t.dtype == torch.bool else w


def broadcast_object(obj, mesh: LaneMesh):
    """Rank 0's picklable ``obj`` on every rank (``obj`` as it is without a
    group)."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    return box[0]


def replicate(tree, mesh: LaneMesh):
    """Every tensor or array leaf of ``tree`` as rank 0 holds it, on every
    rank's device."""
    return _map(lambda x, _: broadcast(_to_device(x, mesh), mesh), tree)


def make_global_batch(tree, mesh: LaneMesh, local_batch: int, base_tree=None):
    """The global batch from every rank's local lanes (JAX
    ``make_global_batch``): each rank passes its ``local_batch`` lanes;
    batched leaves gain a global leading axis of ``local_batch * size``, in
    rank order, on every rank. Shared leaves must be equal on every rank:
    one that is not raises on every rank.

    ``base_tree``: the unbatched twin of ``tree`` (the nominal scene of a
    dispersed scene batch). With it, a leaf is batched when it gained a
    dimension over its base leaf. Without it the shape rule applies, and a
    shared leaf whose leading dimension equals ``local_batch`` (a 100-knot
    grid with 100 local lanes) is taken for a batched one and concatenated,
    as in the JAX package: pass ``base_tree`` where there is one."""
    has_base = base_tree is not None
    mismatch = []

    def put(x, base):
        x = _to_device(x, mesh)
        if _is_batched(x, base, local_batch, has_base):
            return all_gather_lanes(x, mesh)
        same = broadcast(x, mesh).to(x.dtype)
        equal = (same == x) | (same != same) & (x != x)  # NaN meets NaN
        mismatch.append(not bool(equal.all()))
        return x

    out = _map(put, tree, base_tree, has_base)
    flags = torch.tensor([float(any(mismatch))], dtype=torch.float64, device=mesh.device)
    if float(all_reduce(flags, mesh, dist.ReduceOp.MAX)[0]) > 0:
        raise ValueError("a shared leaf (one without the batch axis) differs between ranks")
    return out
