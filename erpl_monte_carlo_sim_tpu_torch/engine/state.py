"""Flight state and launch initial conditions
(``erpl_monte_carlo_sim_tpu/engine/state.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.quaternion import euler_to_quaternion
from ..utils.tree import default_dtype

__all__ = ["FlightState", "InitialConditions", "initial_state"]


@dataclasses.dataclass(frozen=True)
class FlightState:
    """The integrated state of the stacked-vector engine: ``[..., 3]``
    position (inertial, z up), velocity and body angular velocity, the
    ``[..., 4]`` ``[w, x, y, z]`` body->inertial quaternion and the
    propellant fraction ``[...]``. A leading lane axis batches it. Scaling
    and adding states leaf by leaf forms the RK4 stage sums."""

    position: torch.Tensor
    velocity: torch.Tensor
    quaternion: torch.Tensor
    angular_velocity: torch.Tensor
    propellant_fraction: torch.Tensor

    def __mul__(self, k):
        return FlightState(*(getattr(self, f.name) * k for f in dataclasses.fields(self)))

    __rmul__ = __mul__

    def __add__(self, other: "FlightState"):
        return FlightState(*(getattr(self, f.name) + getattr(other, f.name)
                             for f in dataclasses.fields(self)))

    def replace(self, **changes) -> "FlightState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InitialConditions:
    """``position``, ``velocity``, ``attitude`` (intrinsic-xyz Euler
    [roll, pitch, yaw]; a vertical launch is pitch ~ -pi/2) and
    ``angular_velocity``: ``[3]`` each, or ``[B, 3]`` for a batch."""

    position: torch.Tensor
    velocity: torch.Tensor
    attitude: torch.Tensor
    angular_velocity: torch.Tensor

    @classmethod
    def create(cls, device, dtype=None, position=(0.0, 0.0, 0.0),
               velocity=(0.0, 0.0, 0.0), attitude=(0.0, 0.0, 0.0),
               angular_velocity=(0.0, 0.0, 0.0)) -> "InitialConditions":
        dtype = default_dtype(device, dtype)

        def mk(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        return cls(mk(position), mk(velocity), mk(attitude), mk(angular_velocity))

    @classmethod
    def vertical_launch(cls, device, dtype=None, altitude=10.0,
                        pitch_offset=0.02) -> "InitialConditions":
        """The canonical example launch: 10 m up, pitched 0.02 rad off vertical."""
        return cls.create(device, dtype, position=(0.0, 0.0, altitude),
                          attitude=(0.0, -math.pi / 2 + pitch_offset, 0.0))


def initial_state(ic: InitialConditions) -> FlightState:
    """The state at t=0: full propellant, the quaternion of the Euler
    attitude."""
    quat = euler_to_quaternion(ic.attitude[..., 0], ic.attitude[..., 1], ic.attitude[..., 2])
    return FlightState(position=ic.position, velocity=ic.velocity, quaternion=quat,
                       angular_velocity=ic.angular_velocity,
                       propellant_fraction=torch.ones_like(ic.position[..., 0]))
