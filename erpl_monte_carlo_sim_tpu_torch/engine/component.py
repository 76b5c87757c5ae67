"""Whole-flight core on flat ``[B]`` tensors
(``erpl_monte_carlo_sim_tpu/engine/component.py``).

Eager PyTorch: every state and event quantity is a ``[B]`` tensor, each
step runs on every lane and a per-lane mask keeps finished lanes frozen, so
a lane's result does not depend on the other lanes of the batch. The loop
runs while any lane is active. This is the plain version of the CUDA
kernel ``kernels/flight_summary.py``, which runs the same arithmetic with
one thread per lane; CPU tensors run here.

Wind access is a caller-provided ``wind_fn(alt) -> (u, v, w)``.
"""

from __future__ import annotations

import math

import torch

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import mass_flow_rate_at, propellant_remaining, thrust_at
from ..models.rocket import aero_coefficients, mass_properties
from ..ops.interp import interpolate_vec
from ..ops.math import arctan2, safe_sqrt
from ..ops.quaternion import euler_to_quaternion
from .config import require_parity_flags

__all__ = ["quat_normalize_c", "rotmat_c", "qdot_c", "table_wind_fn",
           "dynamics_c", "rk4_c", "flight_components", "SUMMARY_KEYS",
           "INT_KEYS"]

# The output of ``flight_components``, in the order the CUDA kernel writes it.
SUMMARY_KEYS = (
    "apogee_altitude", "apogee_time", "range", "flight_time",
    "final_px", "final_py", "final_pz", "final_vx", "final_vy", "final_vz",
    "max_speed",
    "rail_exit_time", "rail_exit_speed", "rail_exit_angle_of_attack",
    "rail_exit_sideslip",
    "rail_px", "rail_py", "rail_pz", "rail_vx", "rail_vy", "rail_vz",
    "rail_wu", "rail_wv", "rail_ww",
    "quat_w", "quat_x", "quat_y", "quat_z",
    "parachute_deployed", "diverged", "n_steps",
)
INT_KEYS = ("parachute_deployed", "diverged", "n_steps")


def table_wind_fn(grid: torch.Tensor, wind: torch.Tensor):
    """``wind_fn`` over a wind table on the shared ``grid [N]``: ``wind`` is
    ``[B, N, 3]`` per lane or ``[N, 3]`` shared. Tent weights over all N
    knots, as the JAX package evaluates them."""

    def wind_fn(alt):
        return interpolate_vec(alt, grid, wind).unbind(-1)

    return wind_fn


def quat_normalize_c(qw, qx, qy, qz):
    """Unit quaternion with the identity fallback below norm 1e-12."""
    n = torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    ok = n > 1e-12
    inv = 1.0 / torch.where(ok, n, 1.0)
    return (torch.where(ok, qw * inv, 1.0), torch.where(ok, qx * inv, 0.0),
            torch.where(ok, qy * inv, 0.0), torch.where(ok, qz * inv, 0.0))


def rotmat_c(qw, qx, qy, qz):
    """Body->inertial DCM components, row-major, after normalizing."""
    qw, qx, qy, qz = quat_normalize_c(qw, qx, qy, qz)
    return (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy),
    )


def qdot_c(qw, qx, qy, qz, ox, oy, oz):
    """Quaternion kinematics with Baumgarte norm correction (gain 0.5)."""
    dw = 0.5 * (-qx * ox - qy * oy - qz * oz)
    dx = 0.5 * (qw * ox + qy * oz - qz * oy)
    dy = 0.5 * (qw * oy - qx * oz + qz * ox)
    dz = 0.5 * (qw * oz + qx * oy - qy * ox)
    err = qw * qw + qx * qx + qy * qy + qz * qz - 1.0
    return (dw - 0.5 * err * qw, dx - 0.5 * err * qx,
            dy - 0.5 * err * qy, dz - 0.5 * err * qz)


def _aero_angles(ub, vb, wb):
    """Angle of attack and sideslip, 0 at the degenerate points."""
    degen = (torch.abs(ub) < 1e-6) & (torch.abs(wb) < 1e-6)
    alpha = torch.where(degen, 0.0, arctan2(torch.where(degen, 1.0, wb),
                                            torch.where(degen, 1.0, ub)))
    v_xz = safe_sqrt(ub * ub + wb * wb)
    bdeg = v_xz < 1e-6
    beta = torch.where(bdeg, 0.0, arctan2(torch.where(bdeg, 1.0, vb),
                                          torch.where(bdeg, 1.0, v_xz)))
    return alpha, beta


def dynamics_c(scene, cfg, wind_fn, t, st, para):
    """Right-hand side of the 14-component state. Returns the derivative
    tuple and the parachute latch (int32) updated at this state."""
    (px, py, pz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac) = st
    rocket = scene.rocket

    frac = torch.clamp_min(frac, 0.0)
    qw, qx, qy, qz = quat_normalize_c(qw, qx, qy, qz)
    (r00, r01, r02, r10, r11, r12, r20, r21, r22) = rotmat_c(qw, qx, qy, qz)

    mp = mass_properties(rocket, frac)
    atm = atmosphere_properties(scene.atmosphere, pz)

    wu, wv, ww = wind_fn(pz)
    rvx, rvy, rvz = vx - wu, vy - wv, vz - ww
    ub = r00 * rvx + r10 * rvy + r20 * rvz
    vb = r01 * rvx + r11 * rvy + r21 * rvz
    wb = r02 * rvx + r12 * rvy + r22 * rvz

    rel_sq = rvx * rvx + rvy * rvy + rvz * rvz
    mach = safe_sqrt(rel_sq) / atm.speed_of_sound
    alpha, beta = _aero_angles(ub, vb, wb)
    q_dyn = 0.5 * atm.density * rel_sq

    burning = (frac > 0.0) & (t <= scene.motor.burn_time)
    thrust = torch.where(burning, thrust_at(scene.motor, t, atm.pressure), 0.0)

    # parachute latch, updated at every stage's state
    deploy = (pz <= rocket.parachute_deployment_altitude) & (vz < 0.0)
    para = torch.maximum(para, deploy.to(torch.int32))
    is_chute = para > 0

    # chute drag opposes the body-frame relative velocity
    body_speed = safe_sqrt(ub * ub + vb * vb + wb * wb)
    chute_coef = torch.where(
        body_speed > 0.0,
        -0.5 * atm.density * body_speed * rocket.parachute_cd * rocket.parachute_area,
        0.0,
    )
    cfx, cfy, cfz = chute_coef * ub, chute_coef * vb, chute_coef * wb

    coeffs = aero_coefficients(rocket, mach, alpha, beta,
                               center_of_mass=mp.center_of_mass,
                               power_on=(frac > 0.0))
    drag = q_dyn * coeffs.cd * rocket.reference_area
    lift = q_dyn * coeffs.cl * rocket.reference_area
    side = q_dyn * coeffs.cy * rocket.reference_area
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    afx = ca * cb * (-drag) + (-sb) * (-side) + sa * cb * (-lift)
    afy = ca * sb * (-drag) + cb * (-side) + sa * sb * (-lift)
    afz = -sa * (-drag) + ca * (-lift)
    has_q = q_dyn > 0.0
    afx = torch.where(has_q, afx, 0.0)
    afy = torch.where(has_q, afy, 0.0)
    afz = torch.where(has_q, afz, 0.0)

    fx = torch.where(is_chute, cfx, afx) + thrust
    fy = torch.where(is_chute, cfy, afy)
    fz = torch.where(is_chute, cfz, afz)

    mscale = q_dyn * rocket.reference_area * rocket.reference_diameter
    no_moment = is_chute | ~has_q
    my = torch.where(no_moment, 0.0, mscale * coeffs.cpitch)
    mz = torch.where(no_moment, 0.0, mscale * coeffs.cyaw)
    mx = torch.zeros_like(my)
    my = my - cfg.pitch_damping * oy
    mz = mz - cfg.yaw_damping * oz

    fix = r00 * fx + r01 * fy + r02 * fz
    fiy = r10 * fx + r11 * fy + r12 * fz
    fiz = r20 * fx + r21 * fy + r22 * fz
    g = gravity_at(scene.atmosphere, pz)
    inv_m = 1.0 / mp.mass
    ax = fix * inv_m
    ay = fiy * inv_m
    az = (fiz - mp.mass * g) * inv_m

    dox = (mx - (mp.Izz - mp.Iyy) * oy * oz) / mp.Ixx
    doy = (my - (mp.Ixx - mp.Izz) * oz * ox) / mp.Iyy
    doz = (mz - (mp.Iyy - mp.Ixx) * ox * oy) / mp.Izz

    dqw, dqx, dqy, dqz = qdot_c(qw, qx, qy, qz, ox, oy, oz)

    # propellant with the 10 ms burnout ramp
    mdot = mass_flow_rate_at(scene.motor, t)
    nominal = -mdot / rocket.propellant_mass
    nz = nominal != 0.0
    safe = torch.where(nz, nominal, -1.0)
    remaining = torch.where(nz, frac / torch.abs(safe), math.inf)
    dfrac = torch.where(remaining < 0.01, -frac / 0.01, nominal)
    dfrac = torch.where(burning, dfrac, 0.0)

    deriv = (vx, vy, vz, ax, ay, az, dqw, dqx, dqy, dqz, dox, doy, doz, dfrac)
    return deriv, para


def rk4_c(scene, cfg, wind_fn, t, st, para):
    """Classical RK4 with the parachute latch threaded through the stages."""
    dt = cfg.dt

    def axpy(a, k):
        return tuple(s + a * d for s, d in zip(st, k))

    k1, para = dynamics_c(scene, cfg, wind_fn, t, st, para)
    k2, para = dynamics_c(scene, cfg, wind_fn, t + 0.5 * dt, axpy(0.5 * dt, k1), para)
    k3, para = dynamics_c(scene, cfg, wind_fn, t + 0.5 * dt, axpy(0.5 * dt, k2), para)
    k4, para = dynamics_c(scene, cfg, wind_fn, t + dt, axpy(dt, k3), para)
    new = tuple(s + (dt / 6.0) * (a + 2 * b + 2 * c + d)
                for s, a, b, c, d in zip(st, k1, k2, k3, k4))
    qw, qx, qy, qz = quat_normalize_c(new[6], new[7], new[8], new[9])
    return new[:6] + (qw, qx, qy, qz) + new[10:], para


def _rail_phase(scene, cfg, wind_fn, pos, direction, speed0):
    """Forward Euler along the launch direction until the lane leaves the
    rail, burns out or hits ``max_rail_steps``. Returns
    ``(rpx, rpy, rpz, speed, rail_steps, frac)``."""
    dx, dy, dz = direction
    dt_r = cfg.rail_dt
    rpx, rpy, rpz = pos
    spd = speed0
    dist = torch.zeros_like(spd)
    stp = torch.zeros_like(spd, dtype=torch.int32)
    frac = torch.ones_like(spd)
    rocket, motor = scene.rocket, scene.motor

    def active():
        t = stp.to(spd.dtype) * dt_r
        return (dist < cfg.rail_length) & (t < motor.burn_time) & (
            stp < cfg.max_rail_steps)

    on = active()
    while bool(on.any()):
        t = stp.to(spd.dtype) * dt_r
        mp = mass_properties(rocket, frac)
        atm = atmosphere_properties(scene.atmosphere, rpz)
        wu, wv, ww = wind_fn(rpz)
        rvx, rvy, rvz = dx * spd - wu, dy * spd - wv, dz * spd - ww
        rel_speed_axial = rvx * dx + rvy * dy + rvz * dz
        mach = safe_sqrt(rvx * rvx + rvy * rvy + rvz * rvz) / atm.speed_of_sound
        coeffs = aero_coefficients(rocket, mach, 0.0, 0.0,
                                   center_of_mass=mp.center_of_mass, power_on=True)
        drag = (0.5 * atm.density * (rel_speed_axial * rel_speed_axial) * coeffs.cd
                * rocket.reference_area)
        thrust = thrust_at(motor, t, atm.pressure)
        g = gravity_at(scene.atmosphere, rpz)
        accel = (thrust - mp.mass * g - drag) / mp.mass
        nspd = spd + accel * dt_r
        nstp = stp + 1
        rpx = torch.where(on, rpx + dx * nspd * dt_r, rpx)
        rpy = torch.where(on, rpy + dy * nspd * dt_r, rpy)
        rpz = torch.where(on, rpz + dz * nspd * dt_r, rpz)
        dist = torch.where(on, dist + nspd * dt_r, dist)
        frac = torch.where(on, propellant_remaining(motor, nstp.to(spd.dtype) * dt_r),
                           frac)
        spd = torch.where(on, nspd, spd)
        stp = torch.where(on, nstp, stp)
        on = active()
    return rpx, rpy, rpz, spd, stp, frac


def step_time(rail_time: torch.Tensor, step: torch.Tensor, dt: float) -> torch.Tensor:
    """``rail_time + step * dt``, from the step counter. In float32 it is
    rounded once, as a fused multiply-add (the JAX package's XLA program
    rounds it so; computing in float64 and rounding once is exact here, the
    sum needs < 53 bits); in float64 it is rounded per operation."""
    if rail_time.dtype == torch.float32:
        dt32 = float(torch.tensor(dt, dtype=torch.float32))
        return (rail_time.double() + step.double() * dt32).float()
    return rail_time + step.to(rail_time.dtype) * dt


def flight_components(scene, cfg, wind_fn, ics) -> dict:
    """Full flight: launch attitude, rail phase, RK4 main loop with masked
    events (apogee, coast timeouts, ground, 100 km cut, non-finite stop).

    ``ics``: 12 ``[B]`` tensors (px, py, pz, vx, vy, vz, roll, pitch, yaw,
    ox, oy, oz). Returns a dict of ``[B]`` tensors keyed by ``SUMMARY_KEYS``
    (int32 for ``INT_KEYS``). ``quat_*`` is the rail-exit (= launch)
    attitude."""
    require_parity_flags(cfg)
    (px, py, pz, vx, vy, vz, roll, pitch, yaw, ox, oy, oz) = ics

    qw, qx, qy, qz = euler_to_quaternion(roll, pitch, yaw).unbind(-1)
    r = rotmat_c(qw, qx, qy, qz)
    dx, dy, dz = r[0], r[3], r[6]
    speed0 = vx * dx + vy * dy + vz * dz
    rpx, rpy, rpz, spd, rstp, frac = _rail_phase(
        scene, cfg, wind_fn, (px, py, pz), (dx, dy, dz), speed0)
    dtype = spd.dtype
    rail_time = rstp.to(dtype) * cfg.rail_dt
    vx, vy, vz = dx * spd, dy * spd, dz * spd

    # rail-exit diagnostics
    wuh, wvh, wwh = wind_fn(rpz)
    rvx, rvy, rvz = vx - wuh, vy - wvh, vz - wwh
    ub = r[0] * rvx + r[3] * rvy + r[6] * rvz
    vb = r[1] * rvx + r[4] * rvy + r[7] * rvz
    wb = r[2] * rvx + r[5] * rvy + r[8] * rvz
    rail_aoa, rail_slip = _aero_angles(ub, vb, wb)
    rail_speed = safe_sqrt(vx * vx + vy * vy + vz * vz)

    # main loop
    st = (rpx, rpy, rpz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac)
    i0 = torch.zeros_like(spd, dtype=torch.int32)
    f0 = torch.zeros_like(spd)
    ev = dict(step=i0, para=i0, apod=i0, done=i0, div=i0, apo_t=f0, max_coast=f0,
              max_alt=rpz, t_max=rail_time, max_spd=rail_speed, end_t=rail_time)

    def lane_active(ev):
        t = step_time(rail_time, ev["step"], cfg.dt)
        return (ev["done"] == 0) & (t < cfg.max_time) & (ev["step"] < cfg.max_steps)

    run = lane_active(ev)
    while bool(run.any()):
        t = step_time(rail_time, ev["step"], cfg.dt)
        new_st, para = rk4_c(scene, cfg, wind_fn, t, st, ev["para"])
        step_new = ev["step"] + 1
        t_new = step_time(rail_time, step_new, cfg.dt)
        alt, vzn = new_st[2], new_st[5]
        speed = safe_sqrt(new_st[3] * new_st[3] + new_st[4] * new_st[4]
                          + new_st[5] * new_st[5])

        better = alt > ev["max_alt"]
        detect = (alt > cfg.apogee_min_altitude) & (vzn < 0.0) & (ev["apod"] == 0)
        coast_budget = torch.where(
            alt > cfg.coast_alt_hi, cfg.coast_time_hi,
            torch.where(alt > cfg.coast_alt_mid, cfg.coast_time_mid,
                        torch.full_like(alt, cfg.coast_time_lo)),
        )
        apod = torch.maximum(ev["apod"], detect.to(torch.int32))
        apo_t = torch.where(detect, t_new, ev["apo_t"])
        max_coast = torch.where(detect, coast_budget, ev["max_coast"])
        ground = (alt <= cfg.ground_altitude) & (vzn <= 0.0)
        excessive = alt > cfg.excessive_altitude
        coast_done = (apod > 0) & (alt > cfg.coast_alt_mid) & (
            (t_new - apo_t) > max_coast)
        finite = torch.isfinite(alt) & torch.isfinite(vzn) & torch.isfinite(speed)
        newly_div = (~finite).to(torch.int32)
        new_ev = dict(
            step=step_new, para=para, apod=apod,
            done=torch.maximum(ev["done"],
                               (ground | excessive | coast_done).to(torch.int32)
                               | newly_div),
            div=torch.maximum(ev["div"], newly_div),
            apo_t=apo_t,
            max_coast=max_coast,
            max_alt=torch.where(better, alt, ev["max_alt"]),
            t_max=torch.where(better, t_new, ev["t_max"]),
            max_spd=torch.maximum(ev["max_spd"], speed),
            end_t=torch.where(ev["done"] > 0, ev["end_t"], t_new),
        )
        st = tuple(torch.where(run, a, b) for a, b in zip(new_st, st))
        ev = {k: torch.where(run, new_ev[k], ev[k]) for k in ev}
        run = lane_active(ev)

    fpx, fpy, fpz, fvx, fvy, fvz = st[:6]
    return {
        "apogee_altitude": ev["max_alt"],
        "apogee_time": ev["t_max"] - rail_time,
        "range": safe_sqrt(fpx * fpx + fpy * fpy),
        "flight_time": ev["end_t"] - rail_time,
        "final_px": fpx, "final_py": fpy, "final_pz": fpz,
        "final_vx": fvx, "final_vy": fvy, "final_vz": fvz,
        "max_speed": ev["max_spd"],
        "rail_exit_time": rail_time,
        "rail_exit_speed": rail_speed,
        "rail_exit_angle_of_attack": rail_aoa,
        "rail_exit_sideslip": rail_slip,
        "rail_px": rpx, "rail_py": rpy, "rail_pz": rpz,
        "rail_vx": vx, "rail_vy": vy, "rail_vz": vz,
        "rail_wu": wuh, "rail_wv": wvh, "rail_ww": wwh,
        "quat_w": qw, "quat_x": qx, "quat_y": qy, "quat_z": qz,
        "parachute_deployed": ev["para"],
        "diverged": ev["div"],
        "n_steps": ev["step"],
    }
