"""Monte Carlo dispersion sampling (``erpl_monte_carlo_sim_tpu/mc/dispersions.py``).

One ``torch.Generator`` in, one batched ``Scene`` out: 19 scalar dispersion
channels per lane (IC offsets; mass, motor-thrust, motor-flow and density
multipliers; wind speed and direction; the recorded-but-unused thrust
multiplier) plus one AR(1) wind table per lane on a shared altitude grid.
The perturbation semantics are the JAX package's ``_build_scene``: dry and
propellant mass scale together, the solid motor's mass flow follows its
thrust multiplier, burn time re-syncs to propellant / mass flow, and the
density multiplier scales density.

The generator does not reproduce ``jax.random``'s bits: the same seed gives
other lanes than the JAX package (ROADMAP P4). Tests feed both packages the
same NumPy draws through ``_build_scene``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..engine.state import InitialConditions
from ..models.scene import Scene
from ..models.wind import WindField, generate_stochastic_profile, perturb_wind_profile

__all__ = ["UncertaintyParams", "DispersionSample", "sample_dispersions",
           "inject_reference_lanes", "select_lane"]


@dataclasses.dataclass(frozen=True)
class UncertaintyParams:
    """Dispersion sigmas and ranges (the reference analyzer's defaults)."""

    initial_position: tuple = (0.0, 0.0, 0.0)  # m, sigma
    initial_velocity: tuple = (0.1, 0.1, 0.1)  # m/s, sigma
    initial_attitude: tuple = (0.005, 0.005, 0.005)  # rad, sigma
    initial_angular_velocity: tuple = (0.005, 0.005, 0.005)  # rad/s, sigma
    mass_uncertainty: float = 0.02
    thrust_uncertainty: float = 0.03  # recorded; the motor uses its own sigma
    wind_speed_range: tuple = (0.0, 5.0)  # m/s, uniform
    wind_direction_range: tuple = (0.0, 2.0 * math.pi)  # rad, uniform
    atmospheric_density_uncertainty: float = 0.05

    def as_dict(self) -> dict:
        return {
            "initial_position": list(self.initial_position),
            "initial_velocity": list(self.initial_velocity),
            "initial_attitude": list(self.initial_attitude),
            "initial_angular_velocity": list(self.initial_angular_velocity),
            "mass_uncertainty": self.mass_uncertainty,
            "thrust_uncertainty": self.thrust_uncertainty,
            "wind_speed_range": list(self.wind_speed_range),
            "wind_direction_range": list(self.wind_direction_range),
            "atmospheric_density_uncertainty": self.atmospheric_density_uncertainty,
        }


@dataclasses.dataclass(frozen=True)
class DispersionSample:
    """The drawn parameters per lane (``[n]`` or ``[n, 3]``)."""

    initial_position_offset: torch.Tensor
    initial_velocity_offset: torch.Tensor
    initial_attitude_offset: torch.Tensor
    initial_angular_velocity_offset: torch.Tensor
    mass_multiplier: torch.Tensor
    thrust_multiplier: torch.Tensor  # recorded, never acts (reference quirk)
    motor_thrust_multiplier: torch.Tensor
    motor_flow_multiplier: torch.Tensor
    wind_speed: torch.Tensor
    wind_direction: torch.Tensor
    density_multiplier: torch.Tensor
    random_seed: torch.Tensor  # lane index
    wind_member: torch.Tensor  # int32, all zeros without a forecast ensemble


def _sample_impl(generator: torch.Generator, scene: Scene, ic: InitialConditions,
                 params: UncertaintyParams, n: int, base_wind, wind_grid_points: int,
                 wind_grid_top: float, dtype):
    """The prng path: draw every channel, then ``_build_scene``."""
    device = scene.rocket.dry_mass.device

    def normal(shape, sigma):
        z = torch.randn(shape, dtype=dtype, device=device, generator=generator)
        return z * torch.as_tensor(sigma, dtype=dtype, device=device)

    def uniform(lo, hi):
        u = torch.rand((n,), dtype=dtype, device=device, generator=generator)
        return lo + (hi - lo) * u

    ch = {
        "pos_off": normal((n, 3), params.initial_position),
        "vel_off": normal((n, 3), params.initial_velocity),
        "att_off": normal((n, 3), params.initial_attitude),
        "omg_off": normal((n, 3), params.initial_angular_velocity),
        "mass_mult": 1.0 + normal((n,), params.mass_uncertainty),
        "thrust_mult_recorded": 1.0 + normal((n,), params.thrust_uncertainty),
        "motor_thrust_mult": 1.0 + normal((n,), scene.motor.thrust_uncertainty),
        "motor_flow_mult": 1.0 + normal((n,), scene.motor.mass_flow_uncertainty),
        "wind_speed": uniform(*params.wind_speed_range),
        "wind_dir": uniform(*params.wind_direction_range),
        "density_mult": 1.0 + normal((n,), params.atmospheric_density_uncertainty),
    }
    if base_wind is not None:
        grid = torch.as_tensor(base_wind[0], dtype=dtype, device=device)
    else:
        grid = torch.linspace(0.0, wind_grid_top, wind_grid_points, dtype=dtype,
                              device=device)
    return _build_scene(scene, ic, ch, base_wind, grid, generator)


def _build_scene(scene: Scene, ic: InitialConditions, ch: dict, base_wind, grid,
                 generator: Optional[torch.Generator] = None):
    """Batched ``(Scene, InitialConditions, DispersionSample)`` from channel
    draws. ``ch["noise"]``, when present, is the explicit ``[n, N, 3]``
    standard-normal noise of the AR(1) wind; otherwise it is drawn from
    ``generator``."""
    n = ch["mass_mult"].shape[0]
    dtype, device = ch["pos_off"].dtype, ch["pos_off"].device
    mass_mult = ch["mass_mult"]
    wind_speed, wind_dir = ch["wind_speed"], ch["wind_dir"]

    rocket = dataclasses.replace(
        scene.rocket,
        dry_mass=scene.rocket.dry_mass * mass_mult,
        propellant_mass=scene.rocket.propellant_mass * mass_mult,
    )
    mdot_mult = (ch["motor_thrust_mult"] if scene.motor.mdot_follows_thrust
                 else ch["motor_flow_mult"])
    new_prop_mass = scene.rocket.propellant_mass * mass_mult
    new_mdot = scene.motor.mass_flow_rate * mdot_mult
    motor = dataclasses.replace(
        scene.motor,
        thrust_scale=scene.motor.thrust_scale * ch["motor_thrust_mult"],
        mass_flow_rate=new_mdot,
        propellant_mass=new_prop_mass,
        burn_time=new_prop_mass / new_mdot,
    )
    atmosphere = dataclasses.replace(
        scene.atmosphere,
        density_scale=scene.atmosphere.density_scale * ch["density_mult"],
    )

    if "noise" in ch:
        noise = torch.as_tensor(ch["noise"], dtype=dtype, device=device)
    else:
        noise = torch.randn((n, grid.shape[0], 3), dtype=dtype, device=device,
                            generator=generator)
    if base_wind is not None:
        base_profile = torch.as_tensor(base_wind[1], dtype=dtype, device=device)
        if base_profile.ndim == 3:
            raise NotImplementedError(
                "forecast ensembles ([K,N,3] base wind) are not ported yet (ROADMAP P12)")
        profiles = perturb_wind_profile(scene.wind_model, grid, base_profile,
                                        noise=noise)
        offset = torch.stack([wind_speed * torch.cos(wind_dir),
                              wind_speed * torch.sin(wind_dir),
                              torch.zeros_like(wind_speed)], dim=-1)
        profiles = profiles + offset[:, None, :]
    else:
        profiles = generate_stochastic_profile(scene.wind_model, grid, wind_speed,
                                               wind_dir, noise=noise)

    batched_scene = Scene(rocket=rocket, motor=motor, atmosphere=atmosphere,
                          wind=WindField(altitudes=grid, wind=profiles),
                          wind_model=scene.wind_model)

    def base(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    batched_ic = InitialConditions(
        position=base(ic.position) + ch["pos_off"],
        velocity=base(ic.velocity) + ch["vel_off"],
        attitude=base(ic.attitude) + ch["att_off"],
        angular_velocity=base(ic.angular_velocity) + ch["omg_off"],
    )
    sample = DispersionSample(
        initial_position_offset=ch["pos_off"],
        initial_velocity_offset=ch["vel_off"],
        initial_attitude_offset=ch["att_off"],
        initial_angular_velocity_offset=ch["omg_off"],
        mass_multiplier=mass_mult,
        thrust_multiplier=ch["thrust_mult_recorded"],
        motor_thrust_multiplier=ch["motor_thrust_mult"],
        motor_flow_multiplier=ch["motor_flow_mult"],
        wind_speed=wind_speed,
        wind_direction=wind_dir,
        density_multiplier=ch["density_mult"],
        random_seed=torch.arange(n, device=device),
        wind_member=torch.zeros(n, dtype=torch.int32, device=device),
    )
    return batched_scene, batched_ic, sample


def sample_dispersions(generator: torch.Generator, scene: Scene, ic: InitialConditions,
                       params: UncertaintyParams = UncertaintyParams(), n: int = 1000,
                       base_wind: Optional[tuple] = None, wind_grid_points: int = 100,
                       wind_grid_top: float = 25000.0, dtype=None,
                       antithetic: bool = False, sampler: str = "prng",
                       sobol_scrambles: int = 1, sobol_wind_modes: int = 0,
                       importance_shift: tuple = ()):
    """Draw ``n`` dispersed lanes on the scene's device from ``generator``
    (which must live on that device). ``base_wind``: optional forecast
    ``(altitudes[N], wind[N,3])`` each lane perturbs; without it each lane
    synthesizes a profile on a ``wind_grid_points``-knot 0..``wind_grid_top``
    grid. Returns ``(batched_scene, batched_ic, sample)``.

    Only the prng sampler is ported: ``sampler="sobol"``, ``antithetic``
    and ``importance_shift`` raise (ROADMAP P12)."""
    if sampler != "prng" or antithetic or sobol_scrambles != 1 or sobol_wind_modes \
            or importance_shift:
        raise NotImplementedError(
            "only the prng sampler is ported; sobol, antithetic and "
            "importance_shift come with ROADMAP P12")
    if dtype is None:
        dtype = scene.rocket.dry_mass.dtype
    return _sample_impl(generator, scene, ic, params, n, base_wind, wind_grid_points,
                        wind_grid_top, dtype)


def inject_reference_lanes(scene: Scene, ic: InitialConditions, params: dict, wind_grid,
                           wind_profiles):
    """Batched ``(Scene, InitialConditions)`` from explicit per-lane
    dispersion values and wind tables, on the scene's device and in its
    dtype: the lane-matched path of the Monte Carlo certificates against the
    executed reference (tests/golden/mc_*.jsonl).

    ``params`` holds ``[n]`` arrays ``mass_mult``, ``motor_thrust_mult``,
    ``motor_mdot_mult``, ``density_mult`` and ``[n, 3]`` ``pos_off``,
    ``vel_off``, ``att_off``, ``omg_off``; ``wind_profiles`` is ``[n, N, 3]``
    on the shared ``wind_grid [N]``. The perturbations are ``_build_scene``'s
    (dry and propellant mass scale together, burn time re-syncs to
    propellant / mass flow, density scales), with every value given instead
    of drawn."""
    dtype, device = scene.rocket.dry_mass.dtype, scene.rocket.dry_mass.device

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    p = {k: as_t(v) for k, v in params.items()}
    mass_mult = p["mass_mult"]
    new_prop = scene.rocket.propellant_mass * mass_mult
    new_mdot = scene.motor.mass_flow_rate * p["motor_mdot_mult"]
    rocket = dataclasses.replace(scene.rocket, dry_mass=scene.rocket.dry_mass * mass_mult,
                                 propellant_mass=new_prop)
    motor = dataclasses.replace(
        scene.motor, thrust_scale=scene.motor.thrust_scale * p["motor_thrust_mult"],
        mass_flow_rate=new_mdot, propellant_mass=new_prop, burn_time=new_prop / new_mdot)
    atmosphere = dataclasses.replace(
        scene.atmosphere, density_scale=scene.atmosphere.density_scale * p["density_mult"])
    batched_scene = Scene(rocket=rocket, motor=motor, atmosphere=atmosphere,
                          wind=WindField(altitudes=as_t(wind_grid), wind=as_t(wind_profiles)),
                          wind_model=scene.wind_model)
    batched_ic = InitialConditions(
        position=as_t(ic.position) + p["pos_off"],
        velocity=as_t(ic.velocity) + p["vel_off"],
        attitude=as_t(ic.attitude) + p["att_off"],
        angular_velocity=as_t(ic.angular_velocity) + p["omg_off"],
    )
    return batched_scene, batched_ic


def select_lane(batched: Scene, base: Scene, lane: int) -> Scene:
    """One lane's unbatched Scene from a dispersed batch: leaves that gained
    a batch dimension against ``base`` are indexed, shared ones pass."""
    if dataclasses.is_dataclass(batched):
        kwargs = {}
        for f in dataclasses.fields(batched):
            b, v = getattr(base, f.name), getattr(batched, f.name)
            kwargs[f.name] = select_lane(v, b, lane) if isinstance(v, torch.Tensor) \
                or dataclasses.is_dataclass(v) else v
        return type(batched)(**kwargs)
    return batched[lane] if batched.ndim > base.ndim else batched
