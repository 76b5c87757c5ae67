"""Launch initial conditions (``erpl_monte_carlo_sim_tpu/engine/state.py``)."""

from __future__ import annotations

import dataclasses

import torch

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
