"""6DOF rigid-body right-hand side of the stacked-vector engine
(``erpl_monte_carlo_sim_tpu/engine/dynamics.py``).

Branch-free over ``FlightState`` tensors with an optional leading lane
axis: every ``if`` of the reference is a ``torch.where`` mask, and the
reference's stateful parachute latch is an explicit boolean passed in and
returned, so RK4 hands each stage the latch of the stage before it. Wind
is always read from a table (no wind is a zero table), and every guarded
denominator is kept finite on the side of the mask that is not taken.
"""

from __future__ import annotations

import torch

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import mass_flow_rate_at, thrust_at
from ..models.rocket import aero_coefficients, mass_properties
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle, wind_to_body_matrix
from ..ops.math import safe_norm
from ..ops.quaternion import (angular_velocity_to_quaternion_rate, normalize_quaternion,
                              quaternion_to_rotation_matrix, rotate_by_matrix,
                              rotate_by_matrix_t)
from .config import SimConfig
from .state import FlightState

__all__ = ["rocket_dynamics"]


def _where3(mask, a, b):
    """``torch.where`` of a lane mask ``[...]`` over ``[..., 3]`` vectors."""
    return torch.where(mask[..., None], a, b)


def rocket_dynamics(scene, cfg: SimConfig, t, s: FlightState, parachute_deployed,
                    wind_override=None):
    """The state derivative and the updated parachute latch:
    ``(s_dot: FlightState, parachute_deployed')``. ``wind_override`` is a
    wind vector computed once for the step (``SimConfig.wind_eval_per_step``)."""
    rocket = scene.rocket
    position, velocity = s.position, s.velocity
    prop_frac = torch.clamp_min(s.propellant_fraction, 0.0)
    quat = normalize_quaternion(s.quaternion)
    omega = s.angular_velocity

    mp = mass_properties(rocket, prop_frac)
    mass = mp.mass
    R = quaternion_to_rotation_matrix(quat)  # body -> inertial

    altitude = position[..., 2]
    atm = atmosphere_properties(scene.atmosphere, altitude)
    wind_velocity = (wind_at_altitude(scene.wind, altitude) if wind_override is None
                     else wind_override)
    velocity_relative = velocity - wind_velocity
    velocity_body = rotate_by_matrix_t(R, velocity_relative)

    mach = mach_number(velocity_relative, atm.temperature)
    alpha = angle_of_attack(velocity_body)
    beta = sideslip_angle(velocity_body)
    rel_speed = safe_norm(velocity_relative)
    q_dynamic = 0.5 * atm.density * rel_speed**2

    # thrust, gated on propellant and burn time
    burning = (prop_frac > 0.0) & (t <= scene.motor.burn_time)
    thrust = torch.where(burning, thrust_at(scene.motor, t, atm.pressure), 0.0)

    # the parachute latch: once set, it stays set
    deploy_now = (altitude <= rocket.parachute_deployment_altitude) & (velocity[..., 2] < 0.0)
    parachute = parachute_deployed | deploy_now

    # parachute drag opposes the body-frame relative velocity and replaces
    # every aerodynamic force and moment
    body_speed = safe_norm(velocity_body)
    safe_body_speed = torch.clamp_min(body_speed, 1e-12)
    chute_mag = (0.5 * atm.density * body_speed**2 * rocket.parachute_cd
                 * rocket.parachute_area)
    chute_force = -chute_mag[..., None] * velocity_body / safe_body_speed[..., None]
    chute_force = _where3(body_speed > 0.0, chute_force, torch.zeros_like(chute_force))

    coeffs = aero_coefficients(rocket, mach, alpha, beta, center_of_mass=mp.center_of_mass,
                               power_on=(prop_frac > 0.0))
    drag = q_dynamic * coeffs.cd * rocket.reference_area
    lift = q_dynamic * coeffs.cl * rocket.reference_area
    side = q_dynamic * coeffs.cy * rocket.reference_area
    R_wb = wind_to_body_matrix(alpha, beta)
    if cfg.energy_consistent_aero:
        # drag anti-parallel to the relative flow; lift and side force from
        # the reference's matrix, projected perpendicular to the flow
        v_hat = velocity_body / torch.clamp_min(safe_norm(velocity_body, keepdim=True), 1e-12)
        ls_force = rotate_by_matrix(R_wb, torch.stack([torch.zeros_like(drag), -side, -lift],
                                                      dim=-1))
        ls_along = torch.sum(ls_force * v_hat, dim=-1, keepdim=True)
        aero_force = -drag[..., None] * v_hat + (ls_force - ls_along * v_hat)
    else:
        aero_force = rotate_by_matrix(R_wb, torch.stack([-drag, -side, -lift], dim=-1))
    has_q = q_dynamic > 0.0
    aero_force = _where3(has_q, aero_force, torch.zeros_like(aero_force))

    moment_scale = q_dynamic * rocket.reference_area * rocket.reference_diameter
    aero_moments = torch.stack([moment_scale * coeffs.croll, moment_scale * coeffs.cpitch,
                                moment_scale * coeffs.cyaw], dim=-1)
    aero_moments = _where3(has_q, aero_moments, torch.zeros_like(aero_moments))

    forces_body = _where3(parachute, chute_force, aero_force)
    moments_body = _where3(parachute, torch.zeros_like(aero_moments), aero_moments)

    # thrust along body +x
    zero = torch.zeros_like(thrust)
    forces_body = forces_body + torch.stack([thrust, zero, zero], dim=-1)

    # pitch and yaw damping, under the chute too
    damping = torch.stack([torch.zeros_like(omega[..., 0]), -cfg.pitch_damping * omega[..., 1],
                           -cfg.yaw_damping * omega[..., 2]], dim=-1)
    moments_body = moments_body + damping

    # inertial forces and inverse-square gravity
    forces_inertial = rotate_by_matrix(R, forces_body)
    g = gravity_at(scene.atmosphere, altitude)
    zero_g = torch.zeros_like(g)
    forces_inertial = forces_inertial + torch.stack([zero_g, zero_g, -mass * g], dim=-1)
    acceleration = forces_inertial / mass[..., None]

    # Euler's rigid-body rotational equations
    wx, wy, wz = omega.unbind(-1)
    ang_accel = torch.stack([
        (moments_body[..., 0] - (mp.Izz - mp.Iyy) * wy * wz) / mp.Ixx,
        (moments_body[..., 1] - (mp.Ixx - mp.Izz) * wz * wx) / mp.Iyy,
        (moments_body[..., 2] - (mp.Iyy - mp.Ixx) * wx * wy) / mp.Izz,
    ], dim=-1)

    quaternion_rate = angular_velocity_to_quaternion_rate(omega, quat)

    # propellant at the nominal rate, ramped out over the last 10 ms
    mdot = mass_flow_rate_at(scene.motor, t)
    nominal_rate = -mdot / rocket.propellant_mass
    nonzero = nominal_rate != 0.0
    safe_rate = torch.where(nonzero, nominal_rate, -1.0)
    remaining_time = torch.where(nonzero, prop_frac / torch.abs(safe_rate), torch.inf)
    prop_rate = torch.where(remaining_time < 0.01, -prop_frac / 0.01, nominal_rate)
    prop_rate = torch.where(burning, prop_rate, 0.0)

    s_dot = FlightState(position=velocity, velocity=acceleration, quaternion=quaternion_rate,
                        angular_velocity=ang_accel, propellant_fraction=prop_rate)
    return s_dot, parachute
