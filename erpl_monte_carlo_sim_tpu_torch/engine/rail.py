"""Rail-exit diagnostics type (``erpl_monte_carlo_sim_tpu/engine/rail.py``).

Only the type is ported: the rail phase itself runs inside the flight core
(``engine.component``) and the CUDA kernel."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["RailInfo"]


@dataclasses.dataclass(frozen=True)
class RailInfo:
    rail_exit_time: torch.Tensor
    rail_exit_position: torch.Tensor  # [..., 3]
    rail_exit_velocity: torch.Tensor  # [..., 3]
    rail_exit_speed: torch.Tensor
    rail_exit_euler: torch.Tensor  # [..., 3]
    rail_exit_angle_of_attack: torch.Tensor
    rail_exit_sideslip: torch.Tensor
    wind_at_exit: torch.Tensor  # [..., 3]
