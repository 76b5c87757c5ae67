"""Launch initial conditions (``erpl_monte_carlo_sim_tpu/engine/state.py``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.tree import default_dtype

__all__ = ["InitialConditions"]


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
