"""The dispersed lanes of one analysis, drawn from a seed: a frozen plain
copy of the port's pseudo-random sampler (``mc/dispersions.py``, prng path,
as of commit 848e839), over the plain threefry draws of ``ops/prng.py``.

``draw_lanes(key, scene, ic, params, n, grid, base_profile)`` returns the
batched ``(Scene, InitialConditions, sample)`` of ``n`` lanes under the
threefry ``key``: the scalar channels under ``split(key, 12)[:11]``, each
lane's AR(1) turbulence under ``split(split(key, 12)[11], n)[b]`` (then
``split(., 2)[1]`` for a synthesized profile). ``compute`` is the dtype of
the sampler's arithmetic: the draws are made in the lanes' dtype (float32 or
float64) and, where ``compute`` is lower (the low-precision control), rounded
to it before every product, sum and recursion step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import random
from .models.scene import Scene
from .models.wind import WindField, WindModelParams, _ar1_constants, _ar1_recursion, \
    power_law_profile
from .ops import prng
from .engine.state import InitialConditions

__all__ = ["UncertaintyParams", "draw_lanes", "SAMPLE_FIELDS"]

# the per-lane leaves of an analysis's drawn sample, in the port's names
SAMPLE_FIELDS = ("initial_position_offset", "initial_velocity_offset", "initial_attitude_offset",
                 "initial_angular_velocity_offset", "mass_multiplier", "thrust_multiplier",
                 "motor_thrust_multiplier", "motor_flow_multiplier", "wind_speed",
                 "wind_direction", "density_multiplier", "random_seed")


@dataclasses.dataclass(frozen=True)
class UncertaintyParams:
    """Dispersion sigmas and ranges (the reference analyzer's defaults)."""

    initial_position: tuple = (0.0, 0.0, 0.0)
    initial_velocity: tuple = (0.1, 0.1, 0.1)
    initial_attitude: tuple = (0.005, 0.005, 0.005)
    initial_angular_velocity: tuple = (0.005, 0.005, 0.005)
    mass_uncertainty: float = 0.02
    thrust_uncertainty: float = 0.03
    wind_speed_range: tuple = (0.0, 5.0)
    wind_direction_range: tuple = (0.0, 2.0 * math.pi)
    atmospheric_density_uncertainty: float = 0.05


def _channels(keys: torch.Tensor, n: int, dtype, compute, motor, params: UncertaintyParams):
    """The 19 scalar channels: three draws (the four ``[n, 3]`` offsets,
    the five ``[n]`` normals, the two unit uniforms) scaled by their sigma
    or onto their range."""
    vec = random.normal(keys[0:4], (n, 3), dtype).to(compute)
    scal = random.normal(torch.cat([keys[4:8], keys[10:11]]), (n,), dtype).to(compute)
    uni = random.uniform(keys[8:10], (n,), dtype)

    def sig(x):
        return torch.as_tensor(x, dtype=compute, device=keys.device)

    def uniform(u, lo, hi):
        # jax.random.uniform's scale: one fused multiply-add of the bounds
        # rounded to the lanes' dtype
        npd = np.float32 if dtype == torch.float32 else np.float64
        lo_r = npd(lo)
        span = float(npd(npd(hi) - lo_r))
        if compute == dtype:
            return prng._fma(u, span, float(lo_r))
        return u.to(compute) * span + float(lo_r)

    return {
        "pos_off": vec[0] * sig(params.initial_position),
        "vel_off": vec[1] * sig(params.initial_velocity),
        "att_off": vec[2] * sig(params.initial_attitude),
        "omg_off": vec[3] * sig(params.initial_angular_velocity),
        "mass_mult": 1.0 + scal[0] * sig(params.mass_uncertainty),
        "thrust_mult_recorded": 1.0 + scal[1] * sig(params.thrust_uncertainty),
        "motor_thrust_mult": 1.0 + scal[2] * sig(motor.thrust_uncertainty.item()),
        "motor_flow_mult": 1.0 + scal[3] * sig(motor.mass_flow_uncertainty.item()),
        "wind_speed": uniform(uni[0], *params.wind_speed_range),
        "wind_dir": uniform(uni[1], *params.wind_direction_range),
        "density_mult": 1.0 + scal[4] * sig(params.atmospheric_density_uncertainty),
    }


def _turbulence(p: WindModelParams, key, grid, n: int, sub, dtype, compute):
    """Each lane's AR(1) turbulence ``[n, N, 3]``: the lane chain's normals
    drawn in ``dtype`` and the recursion run in ``compute``."""
    noise = prng.draw(key, "normal", (grid.shape[0], 3), dtype=dtype, lanes=n, sub=sub)
    rho, scale0, scale = _ar1_constants(p, grid.to(compute), compute)
    return _ar1_recursion(noise.to(compute), rho, scale0, scale)


def draw_lanes(key, scene: Scene, ic: InitialConditions, params: UncertaintyParams, n: int,
               grid: torch.Tensor, base_profile=None, compute=None):
    """``n`` dispersed lanes under the threefry ``key``: ``(Scene,
    InitialConditions, sample)``, the sample a dict of ``SAMPLE_FIELDS``.
    ``grid [N]`` is the wind grid in the lanes' dtype (the scene's); with a
    forecast ``base_profile [N, 3]`` each lane perturbs it, else each lane
    synthesizes a power-law profile along its drawn direction."""
    dtype = scene.rocket.dry_mass.dtype
    compute = compute or dtype
    device = scene.rocket.dry_mass.device
    keys = random.split(random.as_key(key, device), 12)
    ch = _channels(keys, n, dtype, compute, scene.motor, params)

    def c(x):
        return x.to(compute)

    mass_mult = ch["mass_mult"]
    rocket = dataclasses.replace(scene.rocket, dry_mass=c(scene.rocket.dry_mass) * mass_mult,
                                 propellant_mass=c(scene.rocket.propellant_mass) * mass_mult)
    mdot_mult = ch["motor_thrust_mult"] if scene.motor.mdot_follows_thrust \
        else ch["motor_flow_mult"]
    new_prop_mass = c(scene.rocket.propellant_mass) * mass_mult
    new_mdot = c(scene.motor.mass_flow_rate) * mdot_mult
    motor = dataclasses.replace(scene.motor,
                                thrust_scale=c(scene.motor.thrust_scale) * ch["motor_thrust_mult"],
                                mass_flow_rate=new_mdot, propellant_mass=new_prop_mass,
                                burn_time=new_prop_mass / new_mdot)
    atmosphere = dataclasses.replace(
        scene.atmosphere, density_scale=c(scene.atmosphere.density_scale) * ch["density_mult"])

    speed_in, direction = ch["wind_speed"], ch["wind_dir"]
    grid_c = grid.to(compute)
    if base_profile is not None:
        base = torch.as_tensor(base_profile, dtype=dtype, device=device).to(compute)
        turb = _turbulence(scene.wind_model, keys[11], grid, n, None, dtype, compute)
        offset = torch.stack([speed_in * torch.cos(direction), speed_in * torch.sin(direction),
                              torch.zeros_like(speed_in)], dim=-1)
        profiles = (base + turb) + offset[:, None, :]
    else:
        wm = dataclasses.replace(scene.wind_model,
                                 power_law_exponent=c(scene.wind_model.power_law_exponent))
        speed = power_law_profile(wm, grid_c, speed_in[..., None])
        mean_uv = torch.stack([speed * torch.cos(direction)[..., None],
                               speed * torch.sin(direction)[..., None]], dim=-1)
        turb = _turbulence(scene.wind_model, keys[11], grid, n, 1, dtype, compute)
        mean = torch.cat([mean_uv, torch.zeros_like(mean_uv[..., :1])], dim=-1)
        profiles = mean + turb

    batched = Scene(rocket=rocket, motor=motor, atmosphere=atmosphere,
                    wind=WindField(altitudes=grid_c, wind=profiles), wind_model=scene.wind_model)

    def base_ic(x):
        return torch.as_tensor(x, dtype=dtype, device=device).to(compute)

    ic_b = InitialConditions(position=base_ic(ic.position) + ch["pos_off"],
                             velocity=base_ic(ic.velocity) + ch["vel_off"],
                             attitude=base_ic(ic.attitude) + ch["att_off"],
                             angular_velocity=base_ic(ic.angular_velocity) + ch["omg_off"])
    sample = {
        "initial_position_offset": ch["pos_off"], "initial_velocity_offset": ch["vel_off"],
        "initial_attitude_offset": ch["att_off"],
        "initial_angular_velocity_offset": ch["omg_off"], "mass_multiplier": mass_mult,
        "thrust_multiplier": ch["thrust_mult_recorded"],
        "motor_thrust_multiplier": ch["motor_thrust_mult"],
        "motor_flow_multiplier": ch["motor_flow_mult"], "wind_speed": speed_in,
        "wind_direction": direction, "density_multiplier": ch["density_mult"],
        "random_seed": torch.arange(n, device=device),
    }
    return batched, ic_b, sample
