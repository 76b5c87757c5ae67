"""Carry parameter objects across from the JAX package, and results back.

``scene_from_numpy`` / ``ic_from_numpy`` read a JAX ``Scene`` /
``InitialConditions`` (or nested dicts with the same field names) through
``dataclasses.fields``-style attribute access and ``np.asarray``, so this
module never imports JAX. Shapes are kept: a per-lane leaf stays ``[B]``, a
shared one 0-d, a table ``[K]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.state import InitialConditions
from ..models.atmosphere import AtmosphereParams
from ..models.motor import MotorParams
from ..models.rocket import RocketParams
from ..models.scene import Scene
from ..models.wind import WindField, WindModelParams
from .tree import is_static, tree_map

__all__ = ["scene_from_numpy", "ic_from_numpy", "sample_from_numpy",
           "trajectory_from_numpy", "to_numpy", "summary_to_numpy"]

_SCENE_PARTS = {"rocket": RocketParams, "motor": MotorParams,
                "atmosphere": AtmosphereParams, "wind": WindField,
                "wind_model": WindModelParams}


def _get(obj, name):
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _leaf(x, device, dtype):
    t = torch.as_tensor(np.array(x), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _convert(cls, obj, device, dtype):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if is_static(f):
            if isinstance(obj, dict):
                if f.name in obj:
                    kwargs[f.name] = obj[f.name]
            elif hasattr(obj, f.name):
                kwargs[f.name] = getattr(obj, f.name)
            continue
        kwargs[f.name] = _leaf(_get(obj, f.name), device, dtype)
    return cls(**kwargs)


def scene_from_numpy(obj, device, dtype=None) -> Scene:
    """A port ``Scene`` from a JAX ``Scene`` (or nested dicts). ``dtype``
    casts float leaves; None keeps each leaf's dtype."""
    return Scene(**{name: _convert(cls, _get(obj, name), device, dtype)
                    for name, cls in _SCENE_PARTS.items()})


def ic_from_numpy(obj, device, dtype=None) -> InitialConditions:
    return _convert(InitialConditions, obj, device, dtype)


def sample_from_numpy(obj, device, dtype=None):
    """A port ``DispersionSample`` from a JAX one (or a dict): the drawn
    parameters of a batch, integer leaves (lane ids, members) kept as they
    are."""
    from ..mc.dispersions import DispersionSample

    return _convert(DispersionSample, obj, device, dtype)


def trajectory_from_numpy(obj, device, dtype=None):
    """A port ``Trajectory`` from a JAX one (or a dict): ``[B, T, ...]``
    leaves and the ``derived`` dict, leaf by leaf (``valid`` stays bool)."""
    from ..engine.simulate import Trajectory

    kwargs = {f.name: _leaf(_get(obj, f.name), device, dtype)
              for f in dataclasses.fields(Trajectory) if f.name != "derived"}
    derived = {k: _leaf(v, device, dtype) for k, v in dict(_get(obj, "derived")).items()}
    return Trajectory(**kwargs, derived=derived)


def to_numpy(obj):
    """Every tensor leaf of a port dataclass as a NumPy array."""
    return tree_map(lambda t: t.detach().cpu().numpy(), obj)


summary_to_numpy = to_numpy
