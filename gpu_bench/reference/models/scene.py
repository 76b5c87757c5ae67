"""Scene: the whole simulation configuration as one parameter object
(``erpl_monte_carlo_sim_tpu/models/scene.py``). A Monte Carlo batch is a
Scene whose dispersed leaves carry a leading ``[B]`` axis."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .atmosphere import AtmosphereParams
from .motor import MotorParams
from .rocket import RocketParams
from .wind import WindField, WindModelParams

__all__ = ["Scene", "nominal_scene"]


@dataclasses.dataclass(frozen=True)
class Scene:
    rocket: RocketParams
    motor: MotorParams
    atmosphere: AtmosphereParams
    wind: Optional[WindField]
    wind_model: WindModelParams


def nominal_scene(motor: MotorParams, wind: Optional[WindField] = None) -> Scene:
    """The nominal vehicle around ``motor``, on the motor's device and dtype
    (no wind unless ``wind`` is given)."""
    device, dtype = motor.burn_time.device, motor.burn_time.dtype
    return Scene(
        rocket=RocketParams.create(device, dtype),
        motor=motor,
        atmosphere=AtmosphereParams.create(device, dtype),
        wind=wind if wind is not None else WindField.zero(device, torch.float32),
        wind_model=WindModelParams.create(device, dtype),
    )
