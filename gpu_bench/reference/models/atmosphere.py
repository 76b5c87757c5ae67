"""Layered standard atmosphere (``erpl_monte_carlo_sim_tpu/models/atmosphere.py``).

All five pressure regimes are evaluated branch-free and selected with
``torch.where``, with the JAX package's pinned quirks: the 25-32 km
gradient layer anchors its power law at the 216.65 K stratosphere
temperature (so pressure jumps at 25 km), the 228.65 K cap and 180 K floor
on temperature, and the hard-coded 868.02 Pa anchor at 32 km.
``density_scale`` is the working density dispersion.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.frames import GAMMA_AIR, R_AIR
from ..utils.tree import materialize

__all__ = ["AtmosphereParams", "AtmosProperties", "atmosphere_properties",
           "gravity_at", "EARTH_RADIUS"]

EARTH_RADIUS = 6.371e6  # m


@dataclasses.dataclass(frozen=True)
class AtmosphereParams:
    sea_level_pressure: torch.Tensor = 101325.0  # Pa
    sea_level_temperature: torch.Tensor = 288.15  # K
    temperature_lapse_rate: torch.Tensor = 0.0065  # K/m
    gas_constant: torch.Tensor = R_AIR  # J/(kg K)
    gravity: torch.Tensor = 9.80665  # m/s^2
    gamma: torch.Tensor = GAMMA_AIR
    troposphere_height: torch.Tensor = 11000.0  # m
    stratosphere_height: torch.Tensor = 20000.0  # m
    stratosphere_temp: torch.Tensor = 216.65  # K
    density_scale: torch.Tensor = 1.0

    @classmethod
    def create(cls, device, dtype=None,
               density_scale: float = 1.0) -> "AtmosphereParams":
        return materialize(cls(density_scale=density_scale), device, dtype)


class AtmosProperties(NamedTuple):
    temperature: torch.Tensor
    pressure: torch.Tensor
    density: torch.Tensor
    speed_of_sound: torch.Tensor


def atmosphere_properties(p: AtmosphereParams, altitude) -> AtmosProperties:
    """Temperature, pressure, density and speed of sound at ``altitude`` (m)."""
    h = torch.as_tensor(altitude, dtype=p.gravity.dtype, device=p.gravity.device)
    g = p.gravity
    R = p.gas_constant
    L = p.temperature_lapse_rate
    T0 = p.sea_level_temperature
    P0 = p.sea_level_pressure
    Ts = p.stratosphere_temp
    h_trop = p.troposphere_height
    h_strat = p.stratosphere_height

    pow_exp = g / (R * L)
    p11 = P0 * torch.pow(Ts / T0, pow_exp)
    p20 = p11 * torch.exp(-g * (h_strat - h_trop) / (R * Ts))
    p25 = p20 * torch.exp(-g * 5000.0 / (R * Ts))

    t_tropo = T0 - L * h
    t_iso = torch.broadcast_to(Ts, h.shape)
    t_upper = torch.clamp_max(Ts + 0.001 * (h - h_strat), 228.65)
    t_meso = torch.clamp_min(228.65 - 0.0028 * (h - 32000.0), 180.0)

    t_tropo_safe = torch.clamp_min(t_tropo, 1.0)
    p_tropo = P0 * torch.pow(t_tropo_safe / T0, pow_exp)
    p_iso = p11 * torch.exp(-g * (h - h_trop) / (R * Ts))
    p_2025 = p20 * torch.exp(-g * (h - h_strat) / (R * Ts))
    t_upper_safe = torch.clamp_min(t_upper, 1.0)
    p_2532 = p25 * torch.pow(t_upper_safe / Ts, g / (R * 0.0028))
    scale_height = R * t_meso / g
    p_meso = 868.02 * torch.exp(-(h - 32000.0) / scale_height)

    temperature = torch.where(
        h <= h_trop, t_tropo,
        torch.where(h <= h_strat, t_iso,
                    torch.where(h <= 32000.0, t_upper, t_meso)),
    )
    pressure = torch.where(
        h <= h_trop, p_tropo,
        torch.where(
            h <= h_strat, p_iso,
            torch.where(h <= 25000.0, p_2025,
                        torch.where(h <= 32000.0, p_2532, p_meso)),
        ),
    )
    density = pressure / (R * temperature) * p.density_scale
    speed_of_sound = torch.sqrt(p.gamma * R * temperature)
    return AtmosProperties(temperature, pressure, density, speed_of_sound)


def gravity_at(p: AtmosphereParams, altitude) -> torch.Tensor:
    """Inverse-square gravity."""
    r = EARTH_RADIUS / (EARTH_RADIUS + altitude)
    return p.gravity * (r * r)
