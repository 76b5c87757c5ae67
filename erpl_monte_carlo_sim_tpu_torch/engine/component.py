"""Whole-flight core on flat ``[B]`` tensors
(``erpl_monte_carlo_sim_tpu/engine/component.py``).

Eager PyTorch: every state and event quantity is a ``[B]`` tensor, each
step runs on every lane and a per-lane mask keeps finished lanes frozen, so
a lane's result does not depend on the other lanes of the batch. The loop
runs while any lane is active; on a CUDA device it replays one captured
step as a CUDA graph (``_replay_steps``). This is the plain version of the CUDA
kernel ``kernels/flight_summary.py``, which runs the same arithmetic with
one thread per lane; CPU tensors run here.

Every ``SimConfig`` opt-in acts as in the JAX package: ``integrator="rk2"``,
``wind_eval_per_step``, ``energy_consistent_aero``, ``speed_guard``,
``terminate_nonfinite`` and the tiered timestep (``descent_dt_scale``,
``descent_settle_time``, ``ascent_q_threshold``). ``wind_table_bf16`` is a
property of the table ``wind_fn`` reads (``table_wind_fn``).

``flight_setup`` runs the rail phase and returns the main loop's carry and
closures (``FlightCore``); three drivers share them: ``flight_components``
(summaries), ``flight_components_trajectory`` (a frame every
``record_stride`` steps, with the ``derived_c`` channels) and
``flight_components_envelope`` (per-time-bin aggregates folded in at each
record step, no frames). On a CUDA device each replays a captured step, or
block of steps, as a CUDA graph.

Wind access is a caller-provided ``wind_fn(alt) -> (u, v, w)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..models.atmosphere import atmosphere_properties, gravity_at
from ..models.motor import mass_flow_rate_at, propellant_remaining, thrust_at
from ..models.rocket import aero_coefficients, dynamic_cp, mass_properties
from ..ops.interp import interpolate_vec
from ..ops.math import arcsin, arctan2, safe_sqrt
from ..ops.quaternion import euler_to_quaternion

__all__ = ["quat_normalize_c", "rotmat_c", "qdot_c", "table_wind_fn",
           "dynamics_c", "rk4_c", "FlightCore", "flight_setup", "flight_components",
           "derived_c", "record_names", "n_frames", "flight_components_trajectory",
           "flight_components_envelope", "SUMMARY_KEYS", "INT_KEYS", "STATE_KEYS",
           "FRAME_KEYS", "DERIVED_KEYS"]

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
N_STATE = 14


def table_wind_fn(grid: torch.Tensor, wind: torch.Tensor):
    """``wind_fn`` over a wind table on the shared ``grid [N]``: ``wind`` is
    ``[B, N, 3]`` per lane or ``[N, 3]`` shared. Tent weights over all N
    knots, as the JAX package evaluates them. A table stored in another
    dtype (bfloat16 under ``SimConfig.wind_table_bf16``) is upcast to the
    grid's first, which is exact."""
    wind = wind.to(grid.dtype)

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
    if cfg.energy_consistent_aero:
        # drag anti-parallel to the body-frame air velocity; lift and side
        # force projected onto the plane perpendicular to it
        inv_bs = 1.0 / torch.clamp_min(body_speed, 1e-12)
        vhx, vhy, vhz = ub * inv_bs, vb * inv_bs, wb * inv_bs
        lsx = torch.where(has_q, (-sb) * (-side) + sa * cb * (-lift), 0.0)
        lsy = torch.where(has_q, cb * (-side) + sa * sb * (-lift), 0.0)
        lsz = torch.where(has_q, ca * (-lift), 0.0)
        along = lsx * vhx + lsy * vhy + lsz * vhz
        afx = torch.where(has_q, -drag * vhx + (lsx - along * vhx), 0.0)
        afy = torch.where(has_q, -drag * vhy + (lsy - along * vhy), 0.0)
        afz = torch.where(has_q, -drag * vhz + (lsz - along * vhz), 0.0)

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


def rk4_c(scene, cfg, wind_fn, t, st, para, dt=None):
    """One step of RK4 (or the midpoint method under ``integrator="rk2"``)
    with the parachute latch threaded through the stages. ``dt`` is None for
    ``cfg.dt``, or per-lane ``(dt, dt / 6)`` tensors of the tiered timestep
    (the sixth rounded once from float64, as JAX's weakly typed step is)."""
    if dt is None:
        dt, dt6 = cfg.dt, cfg.dt / 6.0
    else:
        dt, dt6 = dt
    half = 0.5 * dt

    def axpy(a, k):
        return tuple(s + a * d for s, d in zip(st, k))

    if cfg.wind_eval_per_step:
        # one wind lookup at the step's starting altitude, for every stage
        w = wind_fn(st[2])

        def eval_wind(alt):
            return w
    else:
        eval_wind = wind_fn

    k1, para = dynamics_c(scene, cfg, eval_wind, t, st, para)
    k2, para = dynamics_c(scene, cfg, eval_wind, t + half, axpy(half, k1), para)
    if cfg.integrator == "rk2":
        new = tuple(s + dt * b for s, b in zip(st, k2))
    else:
        k3, para = dynamics_c(scene, cfg, eval_wind, t + half, axpy(half, k2), para)
        k4, para = dynamics_c(scene, cfg, eval_wind, t + dt, axpy(dt, k3), para)
        new = tuple(s + dt6 * (a + 2 * b + 2 * c + d)
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


def _coarse_lanes(scene, cfg, st, ev, t, dt_big):
    """The tiered timestep's coarse lanes: settled ballistic fall after
    apogee, clear of the chute-deploy altitude by 1.5 coarse steps; canopy
    descent once the opening has settled; and, with ``ascent_q_threshold``,
    a quiet coast before apogee (burnt out, chute not latched, clear, low
    dynamic pressure from its own atmosphere lookup)."""
    rocket, settle = scene.rocket, cfg.descent_settle_time
    fall_speed = torch.clamp_min(-st[5], 0.0)
    clear = st[2] > (rocket.parachute_deployment_altitude + 1.5 * fall_speed * dt_big)
    ballistic = ((ev["apod"] > 0) & (ev["para"] == 0) & ((t - ev["apo_t"]) > settle)
                 & clear)
    chuted = (ev["para"] > 0) & ((t - ev["dep_t"]) > settle)
    coarse = ballistic | chuted
    if cfg.ascent_q_threshold > 0.0:
        density = atmosphere_properties(scene.atmosphere, st[2]).density
        q_est = 0.5 * density * (st[3] * st[3] + st[4] * st[4] + st[5] * st[5])
        coarse = coarse | ((t > scene.motor.burn_time) & (ev["apod"] == 0)
                           & (ev["para"] == 0) & clear
                           & (q_est < cfg.ascent_q_threshold))
    return coarse


class FlightCore(NamedTuple):
    """The flight after its rail phase, as ``flight_setup`` returns it: the
    pieces every driver of the main loop (summary, recorder, envelope)
    shares."""
    rail_time: torch.Tensor
    time_of: Callable      # ev -> [B] time of each lane
    lane_active: Callable  # ev -> [B] bool, whether the lane takes another step
    step: Callable         # (st, ev, run) -> (st, ev, lane_active): one masked step
    summarize: Callable    # (st, ev) -> the SUMMARY_KEYS dict


def flight_setup(scene, cfg, wind_fn, ics):
    """Launch attitude, rail phase and rail-exit diagnostics, then the main
    loop's initial carry and closures (JAX ``_flight_setup``). Returns
    ``(st, ev, core)``: the 14-component state tuple, the event dict and the
    ``FlightCore``.

    ``ics``: 12 ``[B]`` tensors (px, py, pz, vx, vy, vz, roll, pitch, yaw,
    ox, oy, oz). With ``descent_dt_scale > 1`` (tiered) each lane carries
    its own time, advanced by its own step, and the time its chute latched;
    otherwise time is ``step_time`` of the step counter."""
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
    tiered = cfg.descent_dt_scale > 1
    if tiered:
        dt_big = cfg.dt * cfg.descent_dt_scale
        fine, big = torch.full_like(f0, cfg.dt), torch.full_like(f0, dt_big)
        fine6, big6 = torch.full_like(f0, cfg.dt / 6.0), torch.full_like(f0, dt_big / 6.0)
        ev["t"] = rail_time
        ev["dep_t"] = torch.full_like(f0, math.inf)

    def time_of(ev):
        return ev["t"] if tiered else step_time(rail_time, ev["step"], cfg.dt)

    def lane_active(ev):
        return (ev["done"] == 0) & (time_of(ev) < cfg.max_time) & (
            ev["step"] < cfg.max_steps)

    def step(st, ev, run):
        t = time_of(ev)
        step_new = ev["step"] + 1
        if tiered:
            coarse = _coarse_lanes(scene, cfg, st, ev, t, dt_big)
            dt_lane = torch.where(coarse, big, fine)
            new_st, para = rk4_c(scene, cfg, wind_fn, t, st, ev["para"],
                                 dt=(dt_lane, torch.where(coarse, big6, fine6)))
            t_new = t + dt_lane
        else:
            new_st, para = rk4_c(scene, cfg, wind_fn, t, st, ev["para"])
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
        if cfg.terminate_nonfinite:
            finite = torch.isfinite(alt) & torch.isfinite(vzn) & torch.isfinite(speed)
            newly_div = (~finite | ~(speed < cfg.speed_guard)).to(torch.int32)
        else:
            newly_div = i0
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
        if tiered:
            new_ev["t"] = t_new
            new_ev["dep_t"] = torch.where(para > ev["para"], t_new, ev["dep_t"])
        st = tuple(torch.where(run, a, b) for a, b in zip(new_st, st))
        ev = {k: torch.where(run, new_ev[k], ev[k]) for k in ev}
        return st, ev, lane_active(ev)

    def summarize(st, ev):
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

    return st, ev, FlightCore(rail_time, time_of, lane_active, step, summarize)


def _run_steps(step, st, ev, run):
    """The main loop: ``step`` while any lane runs."""
    while bool(run.any()):
        st, ev, run = step(st, ev, run)
    return st, ev


# main-loop steps replayed between two reads of the loop condition
GRAPH_STEPS = 16


def _capture(fn, carry):
    """``fn``, a function of a tuple of tensors that returns a tuple of the
    same shapes, captured as a CUDA graph that replaces ``carry`` by
    ``fn(carry)`` in place. Returns ``(graph, carry)``, ``carry`` now a
    copy of the given tensors, the graph's inputs and outputs. A replay
    launches the eager call's kernels with the same arguments, so the result
    is the eager loop's, bit for bit, without its per-operation launch cost.
    A warm-up call on copies runs first, on a side stream; whatever ``fn``
    writes besides its result, it writes there too."""
    carry = tuple(x.clone() for x in carry)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(tuple(x.clone() for x in carry))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a, b in zip(carry, fn(carry)):
            a.copy_(b)
    return graph, carry


def _packing():
    """``(pack, unpack)``: ``pack(st, ev, *rest)`` flattens a loop carry
    into one tuple of tensors (what ``_capture`` takes), ``unpack`` returns
    ``(st, ev, rest)``."""
    keys = []

    def pack(st, ev, *rest):
        keys[:] = list(ev)
        return (*st, *ev.values(), *rest)

    def unpack(c):
        n = N_STATE
        return c[:n], dict(zip(keys, c[n:n + len(keys)])), c[n + len(keys):]

    return pack, unpack


def _replay_steps(step, st, ev, run):
    """The main loop on a CUDA device: one ``step`` captured as a CUDA graph
    (``_capture``) and replayed, ``GRAPH_STEPS`` at a time, until no lane
    runs. Steps replayed after the last lane stopped change nothing: a
    stopped lane keeps its state."""
    if not bool(run.any()):
        return st, ev
    pack, unpack = _packing()

    def flat(c):
        st, ev, (run,) = unpack(c)
        return pack(*step(st, ev, run))

    graph, carry = _capture(flat, pack(st, ev, run))
    while bool(carry[-1].any()):
        for _ in range(GRAPH_STEPS):
            graph.replay()
    st, ev, _ = unpack(carry)
    return st, ev


def flight_components(scene, cfg, wind_fn, ics) -> dict:
    """Full flight: launch attitude, rail phase, RK4 main loop with masked
    events (apogee, coast timeouts, ground, 100 km cut, non-finite stop).

    ``ics``: 12 ``[B]`` tensors (px, py, pz, vx, vy, vz, roll, pitch, yaw,
    ox, oy, oz). Returns a dict of ``[B]`` tensors keyed by ``SUMMARY_KEYS``
    (int32 for ``INT_KEYS``). ``quat_*`` is the rail-exit (= launch)
    attitude."""
    st, ev, core = flight_setup(scene, cfg, wind_fn, ics)
    loop = _replay_steps if st[0].is_cuda else _run_steps
    st, ev = loop(core.step, st, ev, core.lane_active(ev))
    return core.summarize(st, ev)


# ------------------------------------------------------------------ recording
# A recorded frame: the time since rail exit and the state, then the derived
# channels (``derived_c``) in this order; ``valid`` beside them.
STATE_KEYS = ("px", "py", "pz", "vx", "vy", "vz", "qw", "qx", "qy", "qz",
              "ox", "oy", "oz", "frac")
FRAME_KEYS = ("time",) + STATE_KEYS
DERIVED_KEYS = (
    "mass", "center_of_mass", "Ixx", "Iyy", "Izz",
    "euler_roll", "euler_pitch", "euler_yaw",
    "thrust", "drag", "cd", "cl", "cm", "cp_location_dynamic", "stability_margin",
    "angle_of_attack", "sideslip_angle", "speed", "altitude", "mach",
)
_EULER = ("euler_roll", "euler_pitch", "euler_yaw")


def record_names(cfg) -> tuple:
    """The derived channels a recording under ``cfg`` holds, in
    ``DERIVED_KEYS`` order: none without ``record_derived``, every one
    without ``record_channels``, else those it names, where any Euler name
    ("euler_angles" or a component) selects all three (the trajectory
    stacks them as one ``[..., 3]`` leaf). A name that is no channel
    raises."""
    if not cfg.record_derived:
        return ()
    if cfg.record_channels is None:
        return DERIVED_KEYS
    keep = set(cfg.record_channels)
    unknown = keep - set(DERIVED_KEYS) - {"euler_angles"}
    if unknown:
        raise ValueError(f"record_channels: no derived channel named {sorted(unknown)}; "
                         f"the channels are {DERIVED_KEYS} (and 'euler_angles')")
    if keep & ({"euler_angles"} | set(_EULER)):
        keep |= set(_EULER)
    return tuple(k for k in DERIVED_KEYS if k in keep)


def derived_c(scene, cfg, wind_fn, t_off, st) -> dict:
    """The derived quantities of a recorded frame (JAX ``derived_c``, the
    reference's extraction loop): flat ``[B]`` tensors keyed by
    ``DERIVED_KEYS``, the Euler angles one per component. ``t_off`` is the
    time since rail exit, at which thrust is evaluated ungated by the
    propellant (as the reference's extraction loop does)."""
    del cfg
    (px, py, pz, vx, vy, vz, qw, qx, qy, qz, ox, oy, oz, frac) = st
    rocket = scene.rocket
    mp = mass_properties(rocket, frac)
    atm = atmosphere_properties(scene.atmosphere, pz)
    wu, wv, ww = wind_fn(pz)
    rvx, rvy, rvz = vx - wu, vy - wv, vz - ww
    r = rotmat_c(qw, qx, qy, qz)
    ub = r[0] * rvx + r[3] * rvy + r[6] * rvz
    vb = r[1] * rvx + r[4] * rvy + r[7] * rvz
    wb = r[2] * rvx + r[5] * rvy + r[8] * rvz
    rel_sq = rvx * rvx + rvy * rvy + rvz * rvz
    mach = safe_sqrt(rel_sq) / atm.speed_of_sound
    aoa, beta = _aero_angles(ub, vb, wb)
    cp_val = dynamic_cp(rocket, mach)
    coeffs = aero_coefficients(rocket, mach, aoa, beta,
                               center_of_mass=mp.center_of_mass, power_on=(frac > 0.0))
    q_dyn = 0.5 * atm.density * rel_sq
    thrust = thrust_at(scene.motor, t_off, atm.pressure)

    # Euler angles of the quaternion, ops.quaternion.quaternion_to_euler's math
    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(torch.abs(sinp) >= 1, torch.sign(sinp) * (math.pi / 2),
                        arcsin(torch.clamp(sinp, -1.0, 1.0)))
    return {
        "mass": mp.mass,
        "center_of_mass": mp.center_of_mass,
        "Ixx": mp.Ixx,
        "Iyy": mp.Iyy,
        "Izz": mp.Izz,
        "euler_roll": arctan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy)),
        "euler_pitch": pitch,
        "euler_yaw": arctan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz)),
        "thrust": thrust,
        "drag": q_dyn * coeffs.cd * rocket.reference_area,
        "cd": coeffs.cd,
        "cl": coeffs.cl,
        "cm": coeffs.cm,
        "cp_location_dynamic": cp_val,
        "stability_margin": (cp_val - mp.center_of_mass) / rocket.reference_diameter,
        "angle_of_attack": aoa,
        "sideslip_angle": beta,
        "speed": safe_sqrt(vx * vx + vy * vy + vz * vz),
        "altitude": pz,
        "mach": mach,
    }


def n_frames(cfg) -> int:
    """Frames of a recording under ``cfg``: the rail-exit frame, then one
    every ``record_stride`` steps up to ``max_steps``."""
    return -(-cfg.max_steps // max(1, cfg.record_stride)) + 1


def _run_blocks(block, carry, n_blocks, running):
    """Run ``block`` (a function of a flat tuple of tensors that returns
    one of the same shapes, some steps of the main loop) while
    ``running(carry)`` holds, at most ``n_blocks`` times. Returns ``(carry,
    blocks run)``."""
    i = 0
    while i < n_blocks and bool(running(carry)):
        carry = block(carry)
        i += 1
    return carry, i


def _replay_blocks(block, carry, n_blocks, running, stride):
    """``_run_blocks`` on a CUDA device: ``block`` captured once as a CUDA
    graph (``_capture``) and replayed, about ``GRAPH_STEPS`` steps between
    two reads of the condition. Blocks replayed after every lane stopped
    repeat the frozen state (and write what the block writes for it)."""
    if n_blocks < 1 or not bool(running(carry)):
        return carry, 0
    graph, carry = _capture(block, carry)
    per_read, i = max(1, GRAPH_STEPS // stride), 0
    while i < n_blocks and bool(running(carry)):
        k = min(per_read, n_blocks - i)
        for _ in range(k):
            graph.replay()
        i += k
    return carry, i


def _blocks(block, carry, n_blocks, running, stride):
    """``block`` is ``stride`` steps of the main loop."""
    if carry[0].is_cuda:
        return _replay_blocks(block, carry, n_blocks, running, stride)
    return _run_blocks(block, carry, n_blocks, running)


def flight_components_trajectory(scene, cfg, wind_fn, ics):
    """The flight of ``flight_components``, recording a frame every
    ``record_stride`` masked steps (JAX ``flight_components_trajectory``):
    the same steps, so the summary dict is ``flight_components``' bit for
    bit. Returns ``(summary dict, records)``, ``records`` a dict of
    time-major ``[T, B]`` tensors (``T = n_frames(cfg)``) keyed by
    ``FRAME_KEYS``, plus ``valid`` (bool) and ``derived`` (a dict keyed by
    ``record_names(cfg)``).

    Frame 0 is the rail-exit state; frame i the state after block i of
    ``record_stride`` steps, ``valid`` where the lane ran at the block's
    start. Frames after the loop ends are the frozen terminal frame, not
    valid. This is the plain version of the kernel's recording build
    (``kernels/flight_summary.py flight_record``); on a CUDA device a block
    is replayed as a CUDA graph."""
    st, ev, core = flight_setup(scene, cfg, wind_fn, ics)
    names = record_names(cfg)
    stride = max(1, cfg.record_stride)
    total = n_frames(cfg)

    def frame(st, ev):
        t_off = core.time_of(ev) - core.rail_time
        out = (t_off, *st)
        if names:
            d = derived_c(scene, cfg, wind_fn, t_off, st)
            out += tuple(d[k] for k in names)
        return out

    rec0 = frame(st, ev)
    run = core.lane_active(ev)
    bufs = [x.new_zeros((total,) + x.shape) for x in rec0]
    for b, x in zip(bufs, rec0):
        b[0] = x
    valid = torch.zeros((total,) + run.shape, dtype=torch.bool, device=run.device)
    valid[0] = True

    pack, unpack = _packing()

    def block(c):
        st, ev, (run, i) = unpack(c)
        ran = run
        for _ in range(stride):
            st, ev, run = core.step(st, ev, run)
        for b, x in zip(bufs, frame(st, ev)):
            b.index_copy_(0, i, x[None])
        valid.index_copy_(0, i, ran[None])
        return pack(st, ev, run, i + 1)

    i0 = torch.ones(1, dtype=torch.int64, device=run.device)
    carry, done = _blocks(block, pack(st, ev, run, i0), total - 1,
                          lambda c: c[-2].any(), stride)
    st, ev, _ = unpack(carry)
    stop = done + 1
    if stop < total:  # the frozen terminal frame, not valid
        for b, x in zip(bufs, frame(st, ev)):
            b[stop:] = x
    recs = {k: b for k, b in zip(FRAME_KEYS, bufs)}
    recs["valid"] = valid
    recs["derived"] = {k: b for k, b in zip(names, bufs[len(FRAME_KEYS):])}
    return core.summarize(st, ev), recs


def _bin_sum(x: torch.Tensor, ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``[C, n_bins]`` sums of ``x [C, B]`` over the lanes of each bin."""
    return x.new_zeros((x.shape[0], n_bins)).index_add_(1, ids, x)


def hist_bucket(frac: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The histogram bucket of a fraction of the bucket width,
    ``clip(int32(frac), 0, n_buckets - 1)`` as XLA converts (saturating, NaN
    to 0), as int64 indices."""
    return torch.nan_to_num(frac, nan=0.0).clamp(0, n_buckets - 1).to(torch.int64)


def flight_components_envelope(scene, cfg, wind_fn, ics, channels, n_bins, n_buckets,
                               bin_dt, lo, width, hist_every=1):
    """The flight of ``flight_components_trajectory`` reduced, record step
    by record step, to per-time-bin aggregates of the ``derived_c``
    ``channels`` (JAX ``flight_components_envelope``): no ``[T, B]`` frames.
    The same steps, cadence, initial frame and ``valid`` as the recorder;
    each record step folds its ``[C, B]`` values into the bins of their time
    since rail exit (``bin_dt``): count, mean and centred M2 by a batched
    Chan merge, min and max, and the fixed-edge histogram (calibrated edges
    ``lo``/``width`` ``[C, n_bins]``, ``n_buckets`` buckets) every
    ``hist_every``-th record step, with the count of values outside the
    edges.

    Returns ``(summary dict, agg)``: ``n/mean/m2/min/max [C, n_bins]``,
    ``hist [C, n_bins, n_buckets]`` and ``clipped [C]`` (float32, exact
    integer counts), what ``mc.envelope.EnvelopeAccumulator.add_aggregates``
    merges. The sums are ``index_add_`` (scatter) over the lanes; the JAX
    package contracts one-hot matrices on the TPU's MXU instead. On a CUDA
    device this runs the eager core with a block of steps and its
    accumulation replayed as a CUDA graph, the record index and the
    ``hist_every`` gate on the device: the card runs it unkernelled (its
    lane-synchronous merge across lanes does not map onto the flight
    kernel's one thread per lane)."""
    st, ev, core = flight_setup(scene, cfg, wind_fn, ics)
    stride = max(1, cfg.record_stride)
    hist_every = max(1, int(hist_every))
    channels = tuple(channels)
    unknown = set(channels) - set(DERIVED_KEYS)
    if unknown:
        raise ValueError(f"envelope channels must be derived channels, not {sorted(unknown)}")
    n_ch, dtype, dev = len(channels), st[0].dtype, st[0].device
    lo_a = torch.as_tensor(lo, device=dev).to(dtype)
    width_a = torch.as_tensor(width, device=dev).to(dtype)
    chan_base = torch.arange(n_ch, device=dev)[:, None] * (n_bins * n_buckets)

    def accumulate(acc, st, ev, ran, hist_w):
        n, mean, m2, vmin, vmax, hist, clipped = acc
        t_off = core.time_of(ev) - core.rail_time
        d = derived_c(scene, cfg, wind_fn, t_off, st)
        vals = torch.stack([d[ch] for ch in channels])  # [C, B]
        ids = torch.clamp(torch.floor(t_off / bin_dt).to(torch.int32), 0, n_bins - 1).long()
        w = ran.to(dtype)
        m = torch.isfinite(vals)
        mv = m.to(dtype)
        v0 = torch.where(m, vals, 0.0)
        n_b = _bin_sum(mv * w, ids, n_bins)
        s_b = _bin_sum(v0 * w, ids, n_bins)
        mean_b = s_b / torch.clamp_min(n_b, 1.0)
        dcen = (v0 - mean_b[:, ids]) * mv
        m2_b = _bin_sum(dcen * dcen * w, ids, n_bins)
        tot = n + n_b
        safe = torch.clamp_min(tot, 1.0)
        delta = mean_b - mean

        sel = m & ran
        at = ids.expand(n_ch, -1)
        vmin_b = torch.full_like(n, math.inf).scatter_reduce(
            1, at, torch.where(sel, vals, math.inf), "amin")
        vmax_b = torch.full_like(n, -math.inf).scatter_reduce(
            1, at, torch.where(sel, vals, -math.inf), "amax")

        # fixed-edge histogram, masked as the frame path's (_bin_histogram_mc)
        frac = (v0 - lo_a[:, ids]) / torch.clamp_min(width_a[:, ids], 1e-30)
        bucket = hist_bucket(frac, n_buckets)
        flat = (chan_base + ids * n_buckets + bucket).reshape(-1)
        h_b = torch.zeros(n_ch * n_bins * n_buckets, dtype=torch.float32,
                          device=dev).index_add_(0, flat, sel.to(torch.float32).reshape(-1))
        out = m & ((frac < 0.0) | (frac >= n_buckets)) & ran
        return (tot, mean + delta * n_b / safe, m2 + m2_b + delta * delta * n * n_b / safe,
                torch.minimum(vmin, vmin_b), torch.maximum(vmax, vmax_b),
                hist + hist_w * h_b.reshape(n_ch, n_bins, n_buckets),
                clipped + hist_w * out.to(torch.float32).sum(1))

    zeros = torch.zeros((n_ch, n_bins), dtype=dtype, device=dev)
    acc = (zeros, zeros, zeros, torch.full_like(zeros, math.inf),
           torch.full_like(zeros, -math.inf),
           torch.zeros((n_ch, n_bins, n_buckets), dtype=torch.float32, device=dev),
           torch.zeros(n_ch, dtype=torch.float32, device=dev))
    run = core.lane_active(ev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    acc = accumulate(acc, st, ev, torch.ones_like(run), one)  # the rail-exit frame

    pack, unpack = _packing()

    def block(c):
        st, ev, (run, i, *acc) = unpack(c)
        ran = run
        for _ in range(stride):
            st, ev, run = core.step(st, ev, run)
        hist_w = ((i % hist_every) == 0).to(torch.float32).reshape(())
        acc = accumulate(acc, st, ev, ran, hist_w)
        return pack(st, ev, run, i + 1, *acc)

    i0 = torch.ones(1, dtype=torch.int64, device=dev)
    carry, _ = _blocks(block, pack(st, ev, run, i0, *acc), n_frames(cfg) - 1,
                       lambda c: c[-9].any(), stride)
    st, ev, (_, _, *acc) = unpack(carry)
    agg = dict(zip(("n", "mean", "m2", "min", "max", "hist", "clipped"), acc))
    return core.summarize(st, ev), agg
