"""Guided launch-rail phase of the stacked-vector engine
(``erpl_monte_carlo_sim_tpu/engine/rail.py``): forward Euler along the
launch direction, the attitude frozen, only the axial relative velocity
making drag (the rail takes the crosswind), alpha 0, power-on drag.

The loop runs while any lane is on the rail; a lane that left keeps its
values. Per lane that is the JAX package's ``vmap`` of its rail loop, and
on a batch its masked loop. ``max_rail_steps`` bounds a lane whose thrust
never lifts it. ``RailInfo`` is also the rail diagnostics of the flight
core (``engine.component``) and the CUDA kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import propellant_remaining, thrust_at
from ..models.rocket import aero_coefficients, mass_properties
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle
from ..ops.quaternion import (quaternion_to_euler, quaternion_to_rotation_matrix,
                              rotate_by_matrix_t)
from .config import SimConfig
from .state import FlightState

__all__ = ["RailInfo", "simulate_rail", "simulate_rail_masked"]


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


def simulate_rail(scene, cfg: SimConfig, state0: FlightState):
    """The rail phase: ``(state_at_exit, rail_time, RailInfo)``. A lane
    leaves once ``distance >= rail_length`` or ``t >= burn_time``."""
    quat = state0.quaternion
    R = quaternion_to_rotation_matrix(quat)
    direction = R[..., :, 0]  # body +x in inertial
    dt = cfg.rail_dt
    pos = state0.position
    speed = torch.sum(state0.velocity * direction, dim=-1)
    dist = torch.zeros_like(speed)
    step = torch.zeros_like(speed, dtype=torch.int32)
    frac = state0.propellant_fraction

    def active():
        t = step.to(pos.dtype) * dt
        return (dist < cfg.rail_length) & (t < scene.motor.burn_time) & (
            step < cfg.max_rail_steps)

    on = active()
    while bool(on.any()):
        t = step.to(pos.dtype) * dt
        mp = mass_properties(scene.rocket, frac)
        atm = atmosphere_properties(scene.atmosphere, pos[..., 2])
        wind = wind_at_altitude(scene.wind, pos[..., 2])
        rel_vel = direction * speed[..., None] - wind
        rel_speed = torch.sum(rel_vel * direction, dim=-1)
        mach = mach_number(rel_vel, atm.temperature)
        coeffs = aero_coefficients(scene.rocket, mach, 0.0, 0.0,
                                   center_of_mass=mp.center_of_mass, power_on=True)
        drag = 0.5 * atm.density * rel_speed**2 * coeffs.cd * scene.rocket.reference_area
        thrust = thrust_at(scene.motor, t, atm.pressure)
        g = gravity_at(scene.atmosphere, pos[..., 2])
        accel = (thrust - mp.mass * g - drag) / mp.mass

        # the reference's order: speed first, then position and distance
        # with the new speed, then time, then propellant at the new time
        new_speed = speed + accel * dt
        new_pos = pos + direction * (new_speed * dt)[..., None]
        new_dist = dist + new_speed * dt
        new_step = step + 1
        new_frac = propellant_remaining(scene.motor, new_step.to(pos.dtype) * dt)
        pos = torch.where(on[..., None], new_pos, pos)
        speed = torch.where(on, new_speed, speed)
        dist = torch.where(on, new_dist, dist)
        step = torch.where(on, new_step, step)
        frac = torch.where(on, new_frac, frac)
        on = active()

    rail_time = step.to(pos.dtype) * dt
    velocity = direction * speed[..., None]
    state_exit = FlightState(position=pos, velocity=velocity, quaternion=quat,
                             angular_velocity=state0.angular_velocity,
                             propellant_fraction=frac)
    wind_exit = wind_at_altitude(scene.wind, pos[..., 2])
    vel_body = rotate_by_matrix_t(R, velocity - wind_exit)
    info = RailInfo(
        rail_exit_time=rail_time,
        rail_exit_position=pos,
        rail_exit_velocity=velocity,
        rail_exit_speed=torch.linalg.vector_norm(velocity, dim=-1),
        rail_exit_euler=quaternion_to_euler(quat),
        rail_exit_angle_of_attack=angle_of_attack(vel_body),
        rail_exit_sideslip=sideslip_angle(vel_body),
        wind_at_exit=wind_exit,
    )
    return state_exit, rail_time, info


def simulate_rail_masked(scene, cfg: SimConfig, state0: FlightState):
    """The rail phase on an already batched lane axis (the JAX package's
    form for its Pallas kernel body): ``simulate_rail``, which masks each
    lane in every case, so the two give the same numbers."""
    return simulate_rail(scene, cfg, state0)
