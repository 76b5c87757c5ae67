"""Flight summary and trajectory types
(``erpl_monte_carlo_sim_tpu/engine/simulate.py``).

Only the types are ported; batched flights run through
``engine.batch.simulate_summary_batch`` and, recorded,
``engine.batch.simulate_flight_batch``."""

from __future__ import annotations

import dataclasses

import torch

from .rail import RailInfo

__all__ = ["FlightSummary", "Trajectory"]


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


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """A recorded history, ``[B, T, ...]`` leaves. ``valid[:, k]`` is True
    for the frames the reference would have recorded (before the lane
    stopped); frame 0 is the rail-exit state, times are offset by the rail
    exit time. ``derived`` maps the recorded ``derived_c`` channels to
    ``[B, T]`` tensors, the Euler angles stacked as ``euler_angles [B, T,
    3]`` (empty without ``record_derived``)."""

    time: torch.Tensor  # [B, T]
    position: torch.Tensor  # [B, T, 3]
    velocity: torch.Tensor  # [B, T, 3]
    quaternion: torch.Tensor  # [B, T, 4]
    angular_velocity: torch.Tensor  # [B, T, 3]
    propellant_fraction: torch.Tensor  # [B, T]
    valid: torch.Tensor  # [B, T] bool
    derived: dict
