"""Scene configuration as JSON (``erpl_monte_carlo_sim_tpu/utils/scene_io.py``).

A ``Scene`` is a frozen parameter object, so configuration is data: this
module writes a scene to JSON and reads it back onto a device. The file
format is the JAX package's, so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..models.atmosphere import AtmosphereParams
from ..models.motor import MotorParams
from ..models.rocket import RocketParams
from ..models.scene import Scene
from ..models.wind import WindField, WindModelParams
from .serialize import to_serializable
from .tree import default_dtype, is_static

__all__ = ["scene_to_dict", "scene_from_dict", "save_scene", "load_scene"]

_PARTS = (("rocket", RocketParams), ("motor", MotorParams),
          ("atmosphere", AtmosphereParams), ("wind", WindField),
          ("wind_model", WindModelParams))


def scene_to_dict(scene: Scene) -> dict:
    return {name: to_serializable(getattr(scene, name)) for name, _ in _PARTS}


def _build(cls, data: dict, device, dtype):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, value in data.items():
        if name not in fields:
            continue
        if is_static(fields[name]):
            kwargs[name] = value  # static field: plain Python value
        else:
            kwargs[name] = torch.as_tensor(np.asarray(value, dtype=np.float64),
                                           dtype=dtype, device=device)
    return cls(**kwargs)


def scene_from_dict(data: dict, device, dtype=None) -> Scene:
    """A ``Scene`` on ``device``, every leaf a ``dtype`` tensor
    (``utils.tree.default_dtype``: float32 on a card, float64 on the CPU).

    ``device`` has no default, as the model constructors' has none: a scene
    read from a file flies where the caller puts it."""
    dtype = default_dtype(device, dtype)
    return Scene(**{name: _build(cls, data[name], device, dtype) for name, cls in _PARTS})


def save_scene(scene: Scene, path: str) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene), f, indent=1)


def load_scene(path: str, device, dtype=None) -> Scene:
    with open(path) as f:
        return scene_from_dict(json.load(f), device, dtype)
