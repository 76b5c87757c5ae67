"""JSON serialization helpers (``erpl_monte_carlo_sim_tpu/utils/serialize.py``).

``to_serializable`` turns tensors (on any device), NumPy values, parameter
dataclasses, dicts, lists and named tuples into JSON-safe Python values, so
that report files keep the JAX package's schema key for key. A parameter
dataclass's static fields (``utils.tree.static_field``: a name, an opt-in
flag) are plain values and pass as they are. NaN and infinities stay
floats, and ``json`` writes them as it does for the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["to_serializable", "object_to_serializable_dict"]


def to_serializable(obj: Any) -> Any:
    """Recursively convert tensors, NumPy values and dataclasses to
    JSON-safe types."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        if obj.ndim == 0:
            return obj.item()
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_serializable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):  # a NamedTuple too, as in the JAX package
        return [to_serializable(v) for v in obj]
    if hasattr(obj, "_asdict"):
        return {k: to_serializable(v) for k, v in obj._asdict().items()}
    return obj


def object_to_serializable_dict(obj: Any) -> dict:
    """Serialize an object's public state (dataclass fields or __dict__)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return to_serializable(obj)
    return {k: to_serializable(v) for k, v in vars(obj).items()}
