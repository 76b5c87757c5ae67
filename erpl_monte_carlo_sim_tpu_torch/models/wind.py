"""Wind tables and AR(1) turbulence (``erpl_monte_carlo_sim_tpu/models/wind.py``).

A wind field is ``(altitudes[N], wind[..., N, 3])``: a shared ``[N, 3]``
table or one ``[B, N, 3]`` table per Monte Carlo lane on a shared grid. The
profile generators take an optional ``[..., N, 3]`` standard-normal
``noise`` that drives the AR(1) recursion; without it they draw from a
``torch.Generator``. Any leading batch dimensions broadcast, so a whole
Monte Carlo batch of profiles is one call.

Constants: sigma = 2 m/s decaying exp(-h/2000), correlation exp(-dh/100)
clipped to [0.1, 0.95], innovation sigma*sqrt(max(1-rho^2, 0.01)),
vertical x0.3.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.tree import materialize

__all__ = ["WindField", "WindModelParams", "power_law_profile", "generate_stochastic_profile",
           "perturb_wind_profile"]


@dataclasses.dataclass(frozen=True)
class WindField:
    """``altitudes[N]`` ascending, ``wind[N, 3]`` shared or ``[B, N, 3]``."""

    altitudes: torch.Tensor
    wind: torch.Tensor

    @classmethod
    def zero(cls, device, dtype=torch.float32) -> "WindField":
        """No wind: a degenerate 2-point zero table."""
        return cls(altitudes=torch.tensor([0.0, 1.0], dtype=dtype, device=device),
                   wind=torch.zeros((2, 3), dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class WindModelParams:
    power_law_exponent: torch.Tensor = 0.14
    turbulence_intensity: torch.Tensor = 2.0  # m/s
    correlation_length: torch.Tensor = 100.0  # m

    @classmethod
    def create(cls, device, dtype=None) -> "WindModelParams":
        return materialize(cls(), device, dtype)


def power_law_profile(p: WindModelParams, altitude, reference_wind_speed,
                      reference_altitude=10.0) -> torch.Tensor:
    return reference_wind_speed * (altitude / reference_altitude) ** p.power_law_exponent


_VERTICAL = (1.0, 1.0, 0.3)


def _ar1_scan(p: WindModelParams, altitudes, mean_uv, mean_w=None, noise=None,
              generator=None):
    """AR(1) turbulence over the grid ``altitudes[N]`` added to the mean wind.

    ``mean_uv [..., N, 2]``, ``mean_w [..., N]`` (zero when None), ``noise``
    ``[..., N, 3]`` standard normals (drawn from ``generator`` when None).
    Returns ``[..., N, 3]``."""
    n = altitudes.shape[0]
    dtype, device = mean_uv.dtype, mean_uv.device
    if mean_w is None:
        mean_w = torch.zeros(mean_uv.shape[:-1], dtype=dtype, device=device)

    sigma = p.turbulence_intensity * torch.exp(-altitudes / 2000.0)
    dh = torch.clamp_min(torch.diff(altitudes, prepend=altitudes[:1]), 1e-6)
    rho = torch.clamp(torch.exp(-dh / p.correlation_length), 0.1, 0.95)
    innov_sigma = sigma * torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.01))

    if noise is None:
        noise = torch.randn(mean_uv.shape[:-1] + (3,), dtype=dtype, device=device,
                            generator=generator)
    else:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)

    vert = torch.tensor(_VERTICAL, dtype=dtype, device=device)
    turb = vert * sigma[0] * noise[..., 0, :]
    rows = [turb]
    for i in range(1, n):
        turb = rho[i] * turb + (innov_sigma[i] * vert) * noise[..., i, :]
        rows.append(turb)
    turb = torch.stack(rows, dim=-2)
    mean = torch.cat([mean_uv, mean_w[..., None]], dim=-1)
    return mean + turb


def generate_stochastic_profile(p: WindModelParams, altitudes, base_wind_speed,
                                base_wind_direction=None, noise=None,
                                generator=None) -> torch.Tensor:
    """Power-law shear along ``base_wind_direction`` (uniform [0, 2 pi) from
    ``generator`` when None) plus AR(1) turbulence. ``base_wind_speed`` and
    ``base_wind_direction`` may carry leading batch dims; returns
    ``[..., N, 3]``."""
    dtype, device = altitudes.dtype, altitudes.device
    speed_in = torch.as_tensor(base_wind_speed, dtype=dtype, device=device)
    if base_wind_direction is None:
        base_wind_direction = 2.0 * math.pi * torch.rand(
            speed_in.shape, dtype=dtype, device=device, generator=generator)
    direction = torch.as_tensor(base_wind_direction, dtype=dtype, device=device)
    speed = power_law_profile(p, altitudes, speed_in[..., None])
    mean_uv = torch.stack([speed * torch.cos(direction)[..., None],
                           speed * torch.sin(direction)[..., None]], dim=-1)
    return _ar1_scan(p, altitudes, mean_uv, noise=noise, generator=generator)


def perturb_wind_profile(p: WindModelParams, altitudes, base_profile, noise=None,
                         generator=None) -> torch.Tensor:
    """AR(1) turbulence around a forecast ``base_profile [..., N, 3]``; all
    three components keep their forecast mean."""
    base_profile = torch.as_tensor(base_profile, dtype=altitudes.dtype,
                                   device=altitudes.device)
    if noise is not None:
        base_profile = torch.broadcast_to(
            base_profile, torch.as_tensor(noise).shape)
    return _ar1_scan(p, altitudes, base_profile[..., :2],
                     mean_w=base_profile[..., 2], noise=noise,
                     generator=generator)
