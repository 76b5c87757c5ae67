"""Frozen parameter dataclasses: the port's stand-in for JAX pytrees.

Every parameter object of the port (``RocketParams``, ``MotorParams``,
``AtmosphereParams``, ``WindField``, ``Scene``, ...) is a frozen dataclass
whose fields are tensors, nested parameter dataclasses, or *static* fields
(plain Python values such as a name or an opt-in flag) marked with
``static_field``. These helpers walk that structure.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["static_field", "is_static", "tree_map", "materialize", "default_dtype",
           "floats_as"]


def default_dtype(device, dtype=None):
    """``dtype`` if given, else float32 on a CUDA device and float64
    elsewhere (the CPU path is the float64 oracle)."""
    if dtype is not None:
        return dtype
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def static_field(default):
    """A dataclass field holding a plain Python value that is never a
    tensor (the ``pytree_node=False`` fields of the JAX package)."""
    return dataclasses.field(default=default, metadata={"static": True})


def is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static", False))


def _is_params(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_map(fn, obj):
    """Apply ``fn`` to every non-static leaf of a parameter dataclass (or a
    bare leaf), rebuilding the same structure; a dict field (a trajectory's
    ``derived``) is mapped value by value. ``None`` leaves stay None."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if not _is_params(obj):
        return fn(obj)
    kwargs = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kwargs[f.name] = v if is_static(f) else tree_map(fn, v)
    return type(obj)(**kwargs)


def floats_as(obj, dtype):
    """``obj`` with every floating-point tensor leaf cast to ``dtype``;
    integer and bool leaves unchanged."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, obj)


def materialize(obj, device, dtype=None):
    """Turn every leaf into a tensor on ``device``: Python numbers and float
    tensors become ``dtype`` (``default_dtype``); integer and bool tensors
    keep their dtype."""
    dtype = default_dtype(device, dtype)

    def conv(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)
        return torch.as_tensor(x, dtype=dtype, device=device)

    return tree_map(conv, obj)
