"""Unified solid/liquid motor (``erpl_monte_carlo_sim_tpu/models/motor.py``).

Both motors share one thrust law::

    thrust(t, p) = thrust_scale * (interp(t, curve_time, curve_thrust_sl)
                                   + nozzle_exit_area * (101325 - p)),  0 <= t <= burn

with the inclusive upper burn bound. The liquid motor's curve is flat at
its sea-level thrust. Mass flow is constant over the burn; propellant
remaining is the linear ramp.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.interp import interpolate_1d
from ..utils.tree import materialize, static_field

__all__ = ["MotorParams", "solid_motor", "liquid_motor", "thrust_at",
           "mass_flow_rate_at", "propellant_remaining", "P_SL", "LBF_TO_N"]

P_SL = 101325.0  # Pa
LBF_TO_N = 4.44822

_SOLID_CURVE_T = (0.0, 0.2, 0.5, 1.0, 2.0, 5.0, 8.0, 12.0, 14.0, 15.0)
_SOLID_CURVE_NORM = (0.0, 2.2, 2.0, 1.8, 1.5, 1.2, 1.0, 0.8, 0.3, 0.0)


@dataclasses.dataclass(frozen=True)
class MotorParams:
    curve_time: torch.Tensor
    curve_thrust_sl: torch.Tensor
    nozzle_exit_area: torch.Tensor
    burn_time: torch.Tensor
    mass_flow_rate: torch.Tensor
    propellant_mass: torch.Tensor
    thrust_scale: torch.Tensor = 1.0
    total_impulse: torch.Tensor = 0.0
    thrust_sea_level: torch.Tensor = 0.0
    thrust_vacuum: torch.Tensor = 0.0
    thrust_uncertainty: torch.Tensor = 0.05
    burn_time_uncertainty: torch.Tensor = 0.02
    total_impulse_uncertainty: torch.Tensor = 0.03
    mass_flow_uncertainty: torch.Tensor = 0.03
    # solid motors scale mass flow WITH the thrust multiplier; liquids draw
    # an independent flow multiplier
    mdot_follows_thrust: bool = static_field(False)
    name: str = static_field("Motor")


def solid_motor(device, dtype=None, total_impulse: float = 156297.0,
                burn_time: float = 15.0, propellant_mass: float = 63.5,
                mass_flow_rate: float = 4.26,
                thrust_sea_level: float = 2290 * LBF_TO_N,
                thrust_vacuum: float = 2590 * LBF_TO_N) -> MotorParams:
    """The solid motor's defaults: a 10-knot normalized curve x average thrust."""
    average_thrust = total_impulse / burn_time
    m = MotorParams(
        curve_time=torch.tensor(_SOLID_CURVE_T, dtype=torch.float64),
        curve_thrust_sl=torch.tensor(_SOLID_CURVE_NORM, dtype=torch.float64)
        * average_thrust,
        nozzle_exit_area=(thrust_vacuum - thrust_sea_level) / P_SL,
        burn_time=burn_time,
        mass_flow_rate=mass_flow_rate,
        propellant_mass=propellant_mass,
        total_impulse=total_impulse,
        thrust_sea_level=thrust_sea_level,
        thrust_vacuum=thrust_vacuum,
        mdot_follows_thrust=True,
        name="Solid Motor",
    )
    return materialize(m, device, dtype)


def liquid_motor(device, dtype=None,
                 thrust_vacuum: float = 2590 * LBF_TO_N,
                 thrust_sea_level: float = 2290 * LBF_TO_N,
                 mass_flow_rate: float = 4.26,
                 propellant_mass: float = 63.5) -> MotorParams:
    """The liquid motor's defaults: burn_time = propellant / mass flow, flat
    sea-level curve, so the thrust law gives ``thrust_vacuum - Ae * p``."""
    burn_time = propellant_mass / mass_flow_rate
    m = MotorParams(
        curve_time=(0.0, 1.0),
        curve_thrust_sl=(thrust_sea_level, thrust_sea_level),
        nozzle_exit_area=(thrust_vacuum - thrust_sea_level) / P_SL,
        burn_time=burn_time,
        mass_flow_rate=mass_flow_rate,
        propellant_mass=propellant_mass,
        total_impulse=thrust_vacuum * burn_time,
        thrust_sea_level=thrust_sea_level,
        thrust_vacuum=thrust_vacuum,
        name="Liquid Motor",
    )
    return materialize(m, device, dtype)


def thrust_at(m: MotorParams, time, ambient_pressure) -> torch.Tensor:
    """Thrust (N) at ``time`` since ignition, with altitude compensation;
    zero outside ``0 <= t <= burn_time``."""
    t = torch.as_tensor(time, dtype=m.burn_time.dtype, device=m.burn_time.device)
    base = interpolate_1d(t, m.curve_time, m.curve_thrust_sl)
    correction = m.nozzle_exit_area * (P_SL - ambient_pressure)
    in_burn = (t >= 0.0) & (t <= m.burn_time)
    return torch.where(in_burn, m.thrust_scale * (base + correction), 0.0)


def mass_flow_rate_at(m: MotorParams, time) -> torch.Tensor:
    t = torch.as_tensor(time, dtype=m.burn_time.dtype, device=m.burn_time.device)
    in_burn = (t >= 0.0) & (t <= m.burn_time)
    return torch.where(in_burn, m.mass_flow_rate, 0.0)


def propellant_remaining(m: MotorParams, time) -> torch.Tensor:
    t = torch.as_tensor(time, dtype=m.burn_time.dtype, device=m.burn_time.device)
    return torch.clamp(1.0 - t / m.burn_time, 0.0, 1.0)
