"""Monte Carlo dispersion sampling (``erpl_monte_carlo_sim_tpu/mc/dispersions.py``).

One threefry key in, one batched ``Scene`` out: 19 scalar dispersion
channels per lane (IC offsets; mass, motor-thrust, motor-flow and density
multipliers; wind speed and direction; the recorded-but-unused thrust
multiplier) plus one AR(1) wind table per lane on a shared altitude grid.
The perturbation semantics are the JAX package's ``_build_scene``: dry and
propellant mass scale together, the solid motor's mass flow follows its
thrust multiplier, burn time re-syncs to propellant / mass flow, and the
density multiplier scales density.

The sampling variants are the JAX package's: scrambled Sobol points over
the scalar channels (``sampler="sobol"``), with independently scrambled
blocks for randomized-QMC error bars and optionally the turbulence's leading
modes (``ops.sobol``); antithetic pairs; importance tilts of the Gaussian
multipliers; and forecast ensembles, each lane perturbing a drawn member.

The key is ``jax.random``'s (``random``: a ``[2]`` tensor of uint32
words, ``random.prng_key(seed)`` for ``jax.random.PRNGKey(seed)``), split as
the JAX package splits it, so a key draws the JAX package's lanes, on the
CPU and on a card (where the threefry kernel draws them,
``kernels/threefry.py``): ``split(key, 12)``, the first eleven keys for the
scalar channels (the Sobol path seeds its scrambles from the first), the
twelfth the turbulence key, whose ``split(., n)[b]`` draws lane ``b``'s
AR(1) driver (after one more ``split(.)[1]`` for a synthesized profile),
``fold_in(., 1)`` the Sobol-mode tail and ``fold_in(., 2)`` the ensemble
members. The draws also pass through seams the tests can feed:
``_channels`` takes the standard draws, ``_sobol_channels`` the Sobol points
(``ops.sobol`` takes the scramble seeds), ``_build_scene`` the turbulence
driver, its Sobol-mode tail and the ensemble members.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import random
from ..engine.state import InitialConditions
from ..models.scene import Scene
from ..models.wind import (WindField, _perturbed_profile, _stochastic_profile,
                           ar1_transfer_matrix)
from ..ops import prng
from ..ops.sobol import max_dims, ndtri, sobol_uniform
from ..utils.convert import to_numpy
from .importance import TILTABLE

__all__ = ["UncertaintyParams", "DispersionSample", "sample_dispersions",
           "inject_reference_lanes", "select_lane", "normal_dims", "sample_from_normals"]


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


def _prng_draws(keys: torch.Tensor, n: int, dtype) -> dict:
    """The prng path's standard draws of the 19 scalar channels under the
    first eleven of ``split(key, 12)``'s ``keys``, as the JAX package draws
    them: ``jax.random.normal`` for the Gaussian channels and the unit
    uniform for the wind speed and direction (``_channels`` scales it as
    ``jax.random.uniform`` does). Three draws: the four ``[n, 3]`` channels,
    the five ``[n]`` ones, the two uniforms."""
    vec = random.normal(keys[0:4], (n, 3), dtype)
    scal = random.normal(torch.cat([keys[4:8], keys[10:11]]), (n,), dtype)
    uni = random.uniform(keys[8:10], (n,), dtype)
    return {"pos_off": vec[0], "vel_off": vec[1], "att_off": vec[2], "omg_off": vec[3],
            "mass_mult": scal[0], "thrust_mult_recorded": scal[1], "motor_thrust_mult": scal[2],
            "motor_flow_mult": scal[3], "wind_speed": uni[0], "wind_dir": uni[1],
            "density_mult": scal[4]}


def _sobol_draws(u: torch.Tensor) -> dict:
    """The Sobol path's standard draws of the 19 scalar channels from the
    ``[n, d]`` point matrix ``u``: its first 19 columns, taken in the JAX
    package's fixed order (the inverse normal CDF for the Gaussian
    channels)."""
    n, col = u.shape[0], [0]

    def take(width):
        i = col[0]
        col[0] += width
        return u[:, i:i + width]

    def z(shape):
        return ndtri(take(shape[1] if len(shape) > 1 else 1)).reshape(shape)

    return {"pos_off": z((n, 3)), "vel_off": z((n, 3)), "att_off": z((n, 3)),
            "omg_off": z((n, 3)), "mass_mult": z((n,)), "thrust_mult_recorded": z((n,)),
            "motor_thrust_mult": z((n,)), "motor_flow_mult": z((n,)),
            "wind_speed": take(1)[:, 0], "wind_dir": take(1)[:, 0], "density_mult": z((n,))}


def _channels(std: dict, scene: Scene, params: UncertaintyParams, antithetic: bool = False,
              importance_shift=()) -> dict:
    """The channel values of ``_build_scene`` from standard draws (``_prng_draws``'
    or ``_sobol_draws``): normals times their sigma, uniforms onto their
    range. ``antithetic``: the second half of every channel is ``2 * centre -
    first half`` (centre 0 for the offsets, 1 for the multipliers, the
    middle of a uniform's range). ``importance_shift``: ``(channel, theta)``
    pairs; the named multiplier's mean moves by ``theta`` of its sigma."""
    n = std["mass_mult"].shape[0]
    dtype, device = std["mass_mult"].dtype, std["mass_mult"].device
    shift = dict(importance_shift)

    def mirror(d, center):
        if not antithetic:
            return d
        half = d[: n // 2]
        return torch.cat([half, 2 * center - half])

    def normal(name, sigma):
        return mirror(std[name] * torch.as_tensor(sigma, dtype=dtype, device=device), 0.0)

    def multiplier(name, sigma, channel=None):
        s = torch.as_tensor(sigma, dtype=dtype, device=device)
        out = 1.0 + normal(name, s)
        theta = shift.get(channel, 0.0)
        return out + s * theta if theta else out

    def uniform(name, lo, hi):
        # jax.random.uniform's scale: one fused multiply-add of the bounds
        # rounded to the dtype, which the host rounds (no copy to the card)
        npd = np.float32 if dtype == torch.float32 else np.float64
        lo_r = npd(lo)
        span = float(npd(npd(hi) - lo_r))
        return mirror(prng._fma(std[name], span, float(lo_r)), 0.5 * (lo + hi))

    return {
        "pos_off": normal("pos_off", params.initial_position),
        "vel_off": normal("vel_off", params.initial_velocity),
        "att_off": normal("att_off", params.initial_attitude),
        "omg_off": normal("omg_off", params.initial_angular_velocity),
        "mass_mult": multiplier("mass_mult", params.mass_uncertainty, "mass"),
        "thrust_mult_recorded": multiplier("thrust_mult_recorded", params.thrust_uncertainty),
        "motor_thrust_mult": multiplier("motor_thrust_mult", scene.motor.thrust_uncertainty,
                                        "motor_thrust"),
        "motor_flow_mult": multiplier("motor_flow_mult", scene.motor.mass_flow_uncertainty,
                                      "motor_flow"),
        "wind_speed": uniform("wind_speed", *params.wind_speed_range),
        "wind_dir": uniform("wind_dir", *params.wind_direction_range),
        "density_mult": multiplier("density_mult", params.atmospheric_density_uncertainty,
                                   "density"),
    }


def _sample_impl(key: torch.Tensor, scene: Scene, ic: InitialConditions,
                 params: UncertaintyParams, n: int, base_wind, wind_grid_points: int,
                 wind_grid_top: float, dtype, antithetic: bool = False,
                 importance_shift=()):
    """The prng path: the scalar draws, then ``_build_scene``."""
    device = scene.rocket.dry_mass.device
    keys = random.split(key, 12)
    std = _prng_draws(keys, n, dtype)
    ch = _channels(std, scene, params, antithetic, importance_shift)
    if base_wind is not None:
        grid = torch.as_tensor(base_wind[0], dtype=dtype, device=device)
    else:
        grid = torch.linspace(0.0, wind_grid_top, wind_grid_points, dtype=dtype,
                              device=device)
    return _build_scene(scene, ic, ch, base_wind, grid, keys[11])


def _sobol_channels(u: torch.Tensor, scene: Scene, params: UncertaintyParams,
                    sobol_wind_modes: int, grid_np: np.ndarray) -> dict:
    """The Sobol path's channel values from the ``[n, 19 + 3 K]`` point
    matrix ``u``: the 19 scalar channels from its first columns and, with
    ``sobol_wind_modes = K``, each lane's leading ``min(K, N)`` turbulence
    modes (``b_lead``) from the next ``3 K`` columns, of which the first ``3
    min(K, N)`` are kept (the JAX package's column order), with the basis
    ``vt`` they are taken along: the rows of ``V^T`` from the host SVD of
    ``ar1_transfer_matrix``, the turbulence's directions in its
    standard-normal driver by falling variance."""
    ch = _channels(_sobol_draws(u), scene, params)
    if sobol_wind_modes > 0:
        n, k = u.shape[0], min(int(sobol_wind_modes), len(grid_np))
        ch["b_lead"] = ndtri(u[:, 19:19 + 3 * k]).reshape(n, k, 3)
        _, _, vt = np.linalg.svd(ar1_transfer_matrix(scene.wind_model, grid_np))
        ch["vt"] = torch.as_tensor(vt, dtype=u.dtype, device=u.device)
    return ch


def _sample_sobol(key: torch.Tensor, scene: Scene, ic: InitialConditions,
                  params: UncertaintyParams, n: int, base_wind, wind_grid_points: int,
                  wind_grid_top: float, dtype, sobol_scrambles: int, sobol_wind_modes: int):
    """The Sobol path: a ``[n, 19 + 3 sobol_wind_modes]`` scrambled Sobol
    matrix seeded by ``split(key, 12)[0]``, its channels
    (``_sobol_channels``), then ``_build_scene``, which draws the rest of the
    turbulence under ``split(key, 12)[11]``."""
    device = scene.rocket.dry_mass.device
    grid_np = (np.asarray(to_numpy(base_wind[0]), np.float64) if base_wind is not None
               else np.linspace(0.0, float(wind_grid_top), int(wind_grid_points)))
    d = 19 + 3 * int(sobol_wind_modes)
    keys = random.split(key, 12)
    u = sobol_uniform(keys[0], n, d, sobol_scrambles, dtype)
    ch = _sobol_channels(u, scene, params, sobol_wind_modes, grid_np)
    grid = torch.as_tensor(grid_np, dtype=dtype, device=device)
    return _build_scene(scene, ic, ch, base_wind, grid, keys[11])


def _build_scene(scene: Scene, ic: InitialConditions, ch: dict, base_wind, grid,
                 turb_key: Optional[torch.Tensor] = None):
    """Batched ``(Scene, InitialConditions, DispersionSample)`` from channel
    values. The turbulence's ``[n, N, 3]`` standard-normal driver is
    ``ch["noise"]`` when given; with Sobol wind modes it is ``vt^T [b_lead;
    b_tail]``, the tail ``ch["b_tail"]`` or drawn under ``fold_in(turb_key,
    1)``; otherwise lane ``b``'s is drawn under ``split(turb_key, n)[b]``
    (then ``split(.)[1]`` for a synthesized profile, whose first key would
    draw a direction the channels already give), inside the AR(1) recursion
    (``models.wind._ar1_scan``): on a card one launch draws each lane's
    normals and runs its recursion, and the driver is never stored. With a
    forecast ensemble (``base_wind[1]`` of ``[K, N, 3]``) each lane perturbs the member
    ``ch["member"]``, or one drawn by ``randint`` under ``fold_in(turb_key,
    2)``, a key no other draw uses, so that a one-member ensemble gives the
    single forecast's lanes bit for bit."""
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

    def key():
        if turb_key is None:
            raise ValueError("_build_scene draws the turbulence or the members: it needs "
                             "turb_key")
        return random.as_key(turb_key, device)

    n_knots = grid.shape[0]
    noise, chain = None, {}
    if "noise" in ch:
        noise = torch.as_tensor(ch["noise"], dtype=dtype, device=device)
    elif "b_lead" in ch:
        b_lead = torch.as_tensor(ch["b_lead"], dtype=dtype, device=device)
        b_tail = (torch.as_tensor(ch["b_tail"], dtype=dtype, device=device) if "b_tail" in ch
                  else random.normal(random.fold_in(key(), 1), (n, n_knots - b_lead.shape[1], 3),
                                   dtype))
        vt = torch.as_tensor(ch["vt"], dtype=dtype, device=device)
        noise = torch.einsum("ij,njc->nic", vt.T, torch.cat([b_lead, b_tail], dim=1))
    else:  # the lane chain, drawn inside the recursion (on a card, never stored)
        chain = {"lanes": n, "sub": 1 if base_wind is None else None}
    chain_key = key() if chain else None
    member = torch.zeros(n, dtype=torch.int32, device=device)
    if base_wind is not None:
        base_profile = torch.as_tensor(base_wind[1], dtype=dtype, device=device)
        if base_profile.ndim == 3:
            if "member" in ch:
                member = torch.as_tensor(ch["member"], device=device).to(torch.int32)
            else:
                member = random.randint(random.fold_in(key(), 2), (n,), 0, base_profile.shape[0])
            base_profile = base_profile[member.long()]  # one [n, N, 3] gather
        profiles = _perturbed_profile(scene.wind_model, chain_key, grid, base_profile,
                                      noise=noise, **chain)
        offset = torch.stack([wind_speed * torch.cos(wind_dir),
                              wind_speed * torch.sin(wind_dir),
                              torch.zeros_like(wind_speed)], dim=-1)
        profiles = profiles + offset[:, None, :]
    else:
        profiles = _stochastic_profile(scene.wind_model, grid, wind_speed, wind_dir, chain_key,
                                       noise=noise, **chain)

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
        wind_member=member,
    )
    return batched_scene, batched_ic, sample


def _validate_sampling(scene: Scene, params: UncertaintyParams, n: int, base_wind,
                       antithetic: bool, sampler: str, sobol_scrambles: int,
                       sobol_wind_modes: int, importance_shift) -> None:
    """The JAX package's checks of the sampling options, with its messages."""
    if antithetic and n % 2 != 0:
        raise ValueError("antithetic sampling needs an even n")
    if base_wind is not None:
        alts, prof = (tuple(np.shape(x)) for x in base_wind)  # no copy of a tensor
        if len(prof) not in (2, 3) or prof[-1] != 3 or prof[-2] != alts[0]:
            raise ValueError("base_wind must be (altitudes[N], wind[N,3]) or an ensemble "
                             f"(altitudes[N], wind[K,N,3]); got altitudes{alts}, wind{prof}")
        if len(prof) == 3 and prof[0] < 1:
            raise ValueError("base_wind ensemble needs at least one member")
    if sampler not in ("prng", "sobol"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler == "sobol" and antithetic:
        raise ValueError("sobol sampling is already balanced; drop antithetic")
    if sobol_scrambles < 1 or (sampler == "sobol" and n % sobol_scrambles):
        raise ValueError("n must be a positive multiple of sobol_scrambles")
    if sobol_wind_modes and sampler != "sobol":
        raise ValueError("sobol_wind_modes requires sampler='sobol'")
    if importance_shift:
        sigmas = {c: sigma(params, scene.motor) for c, (_, sigma) in TILTABLE.items()}
        bad = [c for c, _ in importance_shift if c not in sigmas]
        if bad:
            raise ValueError(f"unknown importance channels {bad}; tiltable Gaussian "
                             f"multiplier channels are {sorted(sigmas)}")
        if sampler != "prng" or antithetic:
            raise ValueError("importance_shift requires sampler='prng' without antithetic")
        for c, _ in importance_shift:
            # a zero-sigma channel cannot be tilted; the solid motor's flow
            # multiplier never acts, so tilting it only adds weight variance
            if sigmas[c] <= 0.0:
                raise ValueError(f"importance channel {c!r} has zero sigma; it cannot be "
                                 "tilted")
            if c == "motor_flow" and scene.motor.mdot_follows_thrust:
                raise ValueError("motor_flow is inert for this motor (mdot follows thrust); "
                                 "tilting it only adds weight variance")
    if sampler == "sobol" and 19 + 3 * sobol_wind_modes > max_dims():
        raise ValueError(f"sobol draw needs {19 + 3 * sobol_wind_modes} dimensions but the "
                         f"baked direction-number table has {max_dims()}; lower "
                         "sobol_wind_modes or regenerate with scripts/gen_sobol_directions.py")


def sample_dispersions(key, scene: Scene, ic: InitialConditions,
                       params: UncertaintyParams = UncertaintyParams(), n: int = 1000,
                       base_wind: Optional[tuple] = None, wind_grid_points: int = 100,
                       wind_grid_top: float = 25000.0, dtype=None,
                       antithetic: bool = False, sampler: str = "prng",
                       sobol_scrambles: int = 1, sobol_wind_modes: int = 0,
                       importance_shift=()):
    """Draw ``n`` dispersed lanes on the scene's device under the threefry
    ``key`` (``random``; a ``[2]`` tensor or pair of uint32 words, moved to
    that device): the JAX package's lanes for the same key. Returns
    ``(batched_scene, batched_ic, sample)``.

    ``base_wind``: an optional forecast ``(altitudes[N], wind[N,3])`` each
    lane perturbs, or an ensemble ``(altitudes[N], wind[K,N,3])`` of which
    each lane perturbs a uniformly drawn member (``sample.wind_member``);
    without it each lane synthesizes a profile on a ``wind_grid_points``-knot
    0..``wind_grid_top`` grid.

    ``sampler``: ``"prng"`` (pseudo-random, the reference's) or ``"sobol"``
    (scrambled Sobol quasi-Monte Carlo over the 19 scalar channels, the
    marginals unchanged). ``sobol_scrambles``: the batch as that many
    contiguous blocks, each under its own scramble (independent
    randomized-QMC replicates, whose spread is a valid error bar).
    ``sobol_wind_modes = K``: also the leading ``K`` principal directions of
    each lane's AR(1) turbulence from Sobol columns, the rest pseudo-random
    (the process's distribution stays exact). ``antithetic``: the second
    half of every scalar channel mirrors the first (``n`` even); the
    turbulence stays independent. ``importance_shift``: ``(channel, theta)``
    pairs (or a dict) that shift the named Gaussian multipliers (``mass``,
    ``motor_thrust``, ``motor_flow``, ``density``) by ``theta`` sigmas; the
    likelihood ratios are ``mc.importance.log_weights``. Prng only, without
    antithetic."""
    importance_shift = tuple(sorted(dict(importance_shift).items()))
    _validate_sampling(scene, params, n, base_wind, antithetic, sampler, sobol_scrambles,
                       sobol_wind_modes, importance_shift)
    if dtype is None:
        dtype = scene.rocket.dry_mass.dtype
    key = random.as_key(key, scene.rocket.dry_mass.device)
    if sampler == "sobol":
        return _sample_sobol(key, scene, ic, params, n, base_wind, wind_grid_points,
                             wind_grid_top, dtype, sobol_scrambles, sobol_wind_modes)
    return _sample_impl(key, scene, ic, params, n, base_wind, wind_grid_points,
                        wind_grid_top, dtype, antithetic, importance_shift)


def normal_dims(wind_grid_points: int = 100) -> int:
    """The width of ``sample_from_normals``' standard-normal input: the 19
    scalar channels and the ``3 N`` AR(1) turbulence drivers of an
    ``N``-knot wind grid."""
    return 19 + 3 * int(wind_grid_points)


def sample_from_normals(u, scene: Scene, ic: InitialConditions,
                        params: UncertaintyParams = UncertaintyParams(), base_wind=None,
                        wind_grid_points: int = 100, wind_grid_top: float = 25000.0,
                        dtype=None):
    """The dispersion distribution as a deterministic map of standard
    normals: ``u [n, d]`` (``d = normal_dims(N)``) to ``n`` dispersed
    ``(Scene, InitialConditions, DispersionSample)`` lanes on the scene's
    device, through ``_build_scene`` as the prng path. Columns, a fixed
    contract: pos[3], vel[3], att[3], omega[3], mass, thrust_recorded,
    motor_thrust, motor_flow, wind_speed, wind_direction, density, then the
    ``[N, 3]`` turbulence driver row-major. Gaussians are ``sigma * u``,
    uniforms ``lo + (hi - lo) * ndtr(u)``, so every marginal is the prng
    path's. Subset simulation's chains move in this space (``mc.subset``). A
    forecast ensemble is refused: its member index has no place in a
    continuous ``u``."""
    device = scene.rocket.dry_mass.device
    if dtype is None:
        dtype = scene.rocket.dry_mass.dtype
    u = torch.as_tensor(u, device=device)
    if u.ndim != 2:
        raise ValueError(f"u must be [n, d]; got shape {tuple(u.shape)}")
    u = u.to(dtype)
    if base_wind is not None:
        if np.ndim(base_wind[1]) == 3:
            raise ValueError("sample_from_normals does not support forecast ensembles "
                             "(discrete member index); condition on a single member")
        grid = torch.as_tensor(base_wind[0], dtype=dtype, device=device)
        base_wind = (grid, torch.as_tensor(base_wind[1], dtype=dtype, device=device))
    else:
        grid = torch.linspace(0.0, float(wind_grid_top), int(wind_grid_points), dtype=dtype,
                              device=device)
    n_knots = grid.shape[0]
    d = normal_dims(n_knots)
    if u.shape[1] != d:
        raise ValueError(f"u has {u.shape[1]} columns but this configuration needs "
                         f"d = normal_dims({n_knots}) = {d}")
    n = u.shape[0]
    std = {"pos_off": u[:, 0:3], "vel_off": u[:, 3:6], "att_off": u[:, 6:9],
           "omg_off": u[:, 9:12], "mass_mult": u[:, 12], "thrust_mult_recorded": u[:, 13],
           "motor_thrust_mult": u[:, 14], "motor_flow_mult": u[:, 15],
           "wind_speed": torch.special.ndtr(u[:, 16]), "wind_dir": torch.special.ndtr(u[:, 17]),
           "density_mult": u[:, 18]}
    ch = _channels(std, scene, params)
    ch["noise"] = u[:, 19:].reshape(n, n_knots, 3)
    return _build_scene(scene, ic, ch, base_wind, grid, random.prng_key(0, device))


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
