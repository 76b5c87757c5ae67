"""Flight summary type (``erpl_monte_carlo_sim_tpu/engine/simulate.py``).

Only the type is ported; batched flights run through
``engine.batch.simulate_summary_batch``."""

from __future__ import annotations

import dataclasses

import torch

from .rail import RailInfo

__all__ = ["FlightSummary"]


@dataclasses.dataclass(frozen=True)
class FlightSummary:
    """Per-flight outputs: the headline metrics (times offset by the rail
    exit time), final state, event flags and rail diagnostics."""

    apogee_altitude: torch.Tensor
    apogee_time: torch.Tensor
    range: torch.Tensor
    flight_time: torch.Tensor
    landing_position: torch.Tensor  # [..., 3]
    final_velocity: torch.Tensor  # [..., 3]
    max_speed: torch.Tensor
    parachute_deployed: torch.Tensor  # bool
    diverged: torch.Tensor  # bool
    n_steps: torch.Tensor  # int32
    rail: RailInfo
