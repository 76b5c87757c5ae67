"""Wind tables and AR(1) turbulence (``erpl_monte_carlo_sim_tpu/models/wind.py``).

A wind field is ``(altitudes[N], wind[..., N, 3])``: a shared ``[N, 3]``
table or one ``[B, N, 3]`` table per Monte Carlo lane on a shared grid. The
profile generators take a threefry key (``random``, ``[..., 2]``: one per
profile) and draw the AR(1) recursion's standard normals under it as the JAX
package does, or take those ``[..., N, 3]`` normals as ``noise`` (the key may
then be None). Any leading batch dimensions broadcast, so a whole Monte
Carlo batch of profiles is one call.

Constants: sigma = 2 m/s decaying exp(-h/2000), correlation exp(-dh/100)
clipped to [0.1, 0.95], innovation sigma*sqrt(max(1-rho^2, 0.01)),
vertical x0.3.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import random
from ..ops.prng import draw as _draw

__all__ = ["WindField", "WindModelParams", "power_law_profile"]


@dataclasses.dataclass(frozen=True)
class WindField:
    """``altitudes[N]`` ascending, ``wind[N, 3]`` shared or ``[B, N, 3]``."""

    altitudes: torch.Tensor
    wind: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WindModelParams:
    power_law_exponent: torch.Tensor = 0.14
    turbulence_intensity: torch.Tensor = 2.0  # m/s
    correlation_length: torch.Tensor = 100.0  # m


def power_law_profile(p: WindModelParams, altitude, reference_wind_speed,
                      reference_altitude=10.0) -> torch.Tensor:
    return reference_wind_speed * (altitude / reference_altitude) ** p.power_law_exponent


_VERTICAL = (1.0, 1.0, 0.3)


def _ar1_constants(p: WindModelParams, altitudes, dtype):
    """The recursion's constants on ``altitudes``' device: ``rho [N]``,
    ``vert * sigma_0 [3]`` and ``innov_sigma_i * vert [N, 3]``, each rounded
    as ``_ar1_recursion`` rounds it."""
    sigma = p.turbulence_intensity * torch.exp(-altitudes / 2000.0)
    dh = torch.clamp_min(torch.diff(altitudes, prepend=altitudes[:1]), 1e-6)
    rho = torch.clamp(torch.exp(-dh / p.correlation_length), 0.1, 0.95)
    innov_sigma = sigma * torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.01))
    vert = torch.ones(3, dtype=dtype, device=altitudes.device)
    vert[2:].fill_(_VERTICAL[2])  # filled on the device: no copy from the host
    return rho, vert * sigma[0], innov_sigma[:, None] * vert


def _ar1_scan(p: WindModelParams, key, altitudes, mean_uv, mean_w=None, noise=None,
              lanes=None, sub=None):
    """AR(1) turbulence over the grid ``altitudes[N]`` added to the mean wind.

    ``mean_uv [..., N, 2]``, ``mean_w [..., N]`` (zero when None), ``noise``
    ``[..., N, 3]`` standard normals (``normal(key, (N, 3))`` for each key of
    ``key [..., 2]`` when None). ``lanes`` and ``sub``: ``key`` is the
    parent of a lane chain, lane ``b`` driven by ``normal(split(key,
    lanes)[b], (N, 3))`` (after ``split(., 2)[sub]``), the sampler's
    ``jax.vmap`` over ``split(turb_key, n)``. Returns ``[..., N, 3]``, the
    turbulence from ``_ar1_recursion``'s eager loop."""
    dtype, device = mean_uv.dtype, mean_uv.device
    if mean_w is None:
        mean_w = torch.zeros(mean_uv.shape[:-1], dtype=dtype, device=device)
    rho, scale0, scale = _ar1_constants(p, altitudes, dtype)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
    elif key is not None:
        key = random.as_key(key, device)
    if noise is None:
        noise = _draw(key, "normal", (rho.shape[0], 3), dtype=rho.dtype, lanes=lanes, sub=sub)
    turb = _ar1_recursion(noise, rho, scale0, scale)
    mean = torch.cat([mean_uv, mean_w[..., None]], dim=-1)
    return mean + turb


def _ar1_recursion(noise: torch.Tensor, rho: torch.Tensor, scale0: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """The AR(1) recursion over the knots of ``noise [..., N, 3]``, eager:
    ``turb_0 = scale0 * z_0``, ``turb_i = rho_i * turb_{i-1} + scale_i *
    z_i``, each product and the sum rounded apart."""
    turb = scale0 * noise[..., 0, :]
    rows = [turb]
    for i in range(1, noise.shape[-2]):
        turb = rho[i] * turb + scale[i] * noise[..., i, :]
        rows.append(turb)
    return torch.stack(rows, dim=-2)


def generate_stochastic_profile(p: WindModelParams, key, altitudes, base_wind_speed,
                                base_wind_direction=None, noise=None) -> torch.Tensor:
    """Power-law shear along ``base_wind_direction`` plus AR(1) turbulence,
    under ``dir_key, turb_key = split(key)`` as the JAX package splits it:
    the direction uniform on [0, 2 pi) under ``dir_key`` when None (in
    float64, ``jax.random.uniform``'s default under x64, then the grid's
    dtype), the turbulence under ``turb_key`` unless ``noise`` is given.
    ``key [..., 2]``, ``base_wind_speed`` and ``base_wind_direction`` may
    carry leading batch dims; returns ``[..., N, 3]``."""
    device = altitudes.device
    if key is None:
        if base_wind_direction is None or noise is None:
            raise ValueError("generate_stochastic_profile draws: it needs a key")
        turb_key = None
    else:
        dir_key, turb_key = random.split(random.as_key(key, device)).unbind(-2)
    if base_wind_direction is None:
        base_wind_direction = random.uniform(dir_key, (), torch.float64, 0.0, 2.0 * math.pi)
    return _stochastic_profile(p, altitudes, base_wind_speed, base_wind_direction,
                               turb_key, noise=noise)


def _stochastic_profile(p: WindModelParams, altitudes, base_wind_speed, base_wind_direction,
                        turb_key=None, noise=None, lanes=None, sub=None) -> torch.Tensor:
    """``generate_stochastic_profile`` with its direction given and its
    turbulence under ``turb_key`` (or ``noise``); ``lanes`` and ``sub``
    make ``turb_key`` the parent of a lane chain (``_ar1_scan``): the
    sampler's route, which on a card never stores the normals."""
    dtype, device = altitudes.dtype, altitudes.device
    speed_in = torch.as_tensor(base_wind_speed, dtype=dtype, device=device)
    direction = torch.as_tensor(base_wind_direction, device=device).to(dtype)
    speed = power_law_profile(p, altitudes, speed_in[..., None])
    mean_uv = torch.stack([speed * torch.cos(direction)[..., None],
                           speed * torch.sin(direction)[..., None]], dim=-1)
    return _ar1_scan(p, turb_key, altitudes, mean_uv, noise=noise, lanes=lanes, sub=sub)


def perturb_wind_profile(p: WindModelParams, key, altitudes, base_profile,
                         noise=None) -> torch.Tensor:
    """AR(1) turbulence under ``key`` (unless ``noise`` is given) around a
    forecast ``base_profile [..., N, 3]``; all three components keep their
    forecast mean."""
    return _perturbed_profile(p, key, altitudes, base_profile, noise=noise)


def _perturbed_profile(p: WindModelParams, key, altitudes, base_profile, noise=None,
                       lanes=None, sub=None) -> torch.Tensor:
    """``perturb_wind_profile``; ``lanes`` and ``sub`` make ``key`` the
    parent of a lane chain (``_ar1_scan``), the sampler's route."""
    base_profile = torch.as_tensor(base_profile, dtype=altitudes.dtype,
                                   device=altitudes.device)
    if noise is not None:
        base_profile = torch.broadcast_to(
            base_profile, torch.as_tensor(noise).shape)
    return _ar1_scan(p, key, altitudes, base_profile[..., :2],
                     mean_w=base_profile[..., 2], noise=noise, lanes=lanes, sub=sub)
