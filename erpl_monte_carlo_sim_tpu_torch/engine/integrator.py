"""RK4 step and branch-free event state machine of the stacked-vector
engine (``erpl_monte_carlo_sim_tpu/engine/integrator.py``).

The reference's main loop, with its inline ``break``s and the parachute
latch mutated inside the right-hand side, is a pure ``carry -> carry``
step here: classic RK4 with the latch handed from stage to stage, the
quaternion normalized after every step, and every stop (ground, 100 km,
the tiered coast timeouts, a non-finite state) and apogee detection a
boolean mask carried in ``EventState`` with the running summaries. Leaves
carry an optional leading lane axis; the caller masks finished lanes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.wind import wind_at_altitude
from ..ops.math import safe_norm
from ..ops.quaternion import normalize_quaternion
from .component import step_time
from .config import SimConfig
from .dynamics import rocket_dynamics
from .state import FlightState

__all__ = ["EventState", "StepCarry", "rk4_step", "init_carry", "advance"]

SPEED_OF_SOUND_SL = 340.294


@dataclasses.dataclass(frozen=True)
class EventState:
    """Event flags and running summaries, one of each a lane."""

    parachute_deployed: torch.Tensor  # bool
    apogee_detected: torch.Tensor  # bool
    apogee_time: torch.Tensor  # absolute t at detection (the coast timer's base)
    max_coast_time: torch.Tensor  # the tiered coast budget chosen at detection
    done: torch.Tensor  # bool: the lane stopped
    diverged: torch.Tensor  # bool: the lane went non-finite
    max_altitude: torch.Tensor
    t_at_max_altitude: torch.Tensor  # absolute t
    max_speed: torch.Tensor
    max_mach_proxy: torch.Tensor  # max speed / sea-level speed of sound
    end_time: torch.Tensor  # absolute t at the stop


@dataclasses.dataclass(frozen=True)
class StepCarry:
    state: FlightState
    step: torch.Tensor  # int32: absolute t = rail_time + step * dt
    rail_time: torch.Tensor
    events: EventState


def init_carry(state_exit: FlightState, rail_time,
               speed_of_sound_sl: float = SPEED_OF_SOUND_SL) -> StepCarry:
    """The carry at rail exit. The rail-exit state counts as recorded (the
    reference appends it before its loop), so the summaries start from it."""
    alt = state_exit.position[..., 2]
    speed = safe_norm(state_exit.velocity)
    f = torch.as_tensor(rail_time, dtype=alt.dtype, device=alt.device)
    b = torch.zeros_like(alt, dtype=torch.bool)
    events = EventState(
        parachute_deployed=b, apogee_detected=b, apogee_time=torch.zeros_like(f),
        max_coast_time=torch.zeros_like(f), done=b, diverged=b, max_altitude=alt,
        t_at_max_altitude=f, max_speed=speed, max_mach_proxy=speed / speed_of_sound_sl,
        end_time=f)
    return StepCarry(state=state_exit, step=torch.zeros_like(alt, dtype=torch.int32),
                     rail_time=f, events=events)


def rk4_step(scene, cfg: SimConfig, t, state: FlightState, parachute):
    """One RK4 step of ``cfg.dt``, the parachute latch handed from each
    stage to the next. Returns ``(state', latch')``."""
    dt = cfg.dt
    wind = (wind_at_altitude(scene.wind, state.position[..., 2]) if cfg.wind_eval_per_step
            else None)
    k1, p1 = rocket_dynamics(scene, cfg, t, state, parachute, wind)
    k2, p2 = rocket_dynamics(scene, cfg, t + 0.5 * dt, state + (0.5 * dt) * k1, p1, wind)
    k3, p3 = rocket_dynamics(scene, cfg, t + 0.5 * dt, state + (0.5 * dt) * k2, p2, wind)
    k4, p4 = rocket_dynamics(scene, cfg, t + dt, state + dt * k3, p3, wind)
    new = state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return new.replace(quaternion=normalize_quaternion(new.quaternion)), p4


def _update_events(cfg: SimConfig, t_new, state: FlightState, ev: EventState,
                   parachute) -> EventState:
    """The reference's event logic after a step."""
    alt = state.position[..., 2]
    vz = state.velocity[..., 2]
    speed = safe_norm(state.velocity)

    # running summaries; strict > keeps the first maximum, as np.argmax does
    better = alt > ev.max_altitude
    max_altitude = torch.where(better, alt, ev.max_altitude)
    t_at_max = torch.where(better, t_new, ev.t_at_max_altitude)
    max_speed = torch.maximum(ev.max_speed, speed)
    max_mach = torch.maximum(ev.max_mach_proxy, speed / SPEED_OF_SOUND_SL)

    # apogee and the tiered coast budget
    detect = (alt > cfg.apogee_min_altitude) & (vz < 0.0) & ~ev.apogee_detected
    coast_budget = torch.where(
        alt > cfg.coast_alt_hi, cfg.coast_time_hi,
        torch.where(alt > cfg.coast_alt_mid, cfg.coast_time_mid,
                    torch.full_like(alt, cfg.coast_time_lo)))
    apogee_detected = ev.apogee_detected | detect
    apogee_time = torch.where(detect, t_new, ev.apogee_time)
    max_coast_time = torch.where(detect, coast_budget, ev.max_coast_time)

    # stops
    ground = (alt <= cfg.ground_altitude) & (vz <= 0.0)
    excessive = alt > cfg.excessive_altitude
    coast_done = (apogee_detected & (alt > cfg.coast_alt_mid)
                  & ((t_new - apogee_time) > max_coast_time))
    diverged = ev.diverged
    if cfg.terminate_nonfinite:
        finite = torch.isfinite(alt) & torch.isfinite(vz) & torch.isfinite(speed)
        diverged = diverged | ~finite | ~(speed < cfg.speed_guard)

    newly_done = ground | excessive | coast_done | (diverged & ~ev.diverged)
    return EventState(
        parachute_deployed=parachute, apogee_detected=apogee_detected,
        apogee_time=apogee_time, max_coast_time=max_coast_time, done=ev.done | newly_done,
        diverged=diverged, max_altitude=max_altitude, t_at_max_altitude=t_at_max,
        max_speed=max_speed, max_mach_proxy=max_mach,
        end_time=torch.where(ev.done, ev.end_time, t_new))


def advance(scene, cfg: SimConfig, carry: StepCarry) -> StepCarry:
    """One main-loop iteration, an RK4 step and its events, on every lane;
    the caller masks the lanes that stopped. Times are ``step_time`` of the
    step counter."""
    t = step_time(carry.rail_time, carry.step, cfg.dt)
    new_state, parachute = rk4_step(scene, cfg, t, carry.state,
                                    carry.events.parachute_deployed)
    step_new = carry.step + 1
    t_new = step_time(carry.rail_time, step_new, cfg.dt)
    events = _update_events(cfg, t_new, new_state, carry.events, parachute)
    return StepCarry(state=new_state, step=step_new, rail_time=carry.rail_time, events=events)
