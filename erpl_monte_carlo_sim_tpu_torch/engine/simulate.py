"""The single-flight entry points (``erpl_monte_carlo_sim_tpu/engine/simulate.py``):
``simulate_summary``, ``simulate_flight`` and ``simulate_batch_chunked``
over the stacked-vector engine (``engine.state``, ``engine.rail``,
``engine.dynamics``, ``engine.integrator``).

Each takes a ``Scene`` and ``InitialConditions`` with an optional leading
lane axis on the initial conditions (``[3]`` or ``[B, 3]``; the scene's
leaves are shared or ``[B]``, its wind table ``[N, 3]`` or ``[B, N, 3]``)
and dispatches on where the initial conditions lie:

* CPU tensors run the eager stacked physics, the plain version
  (``simulate_summary_reference``, ``simulate_flight_reference``,
  ``simulate_batch_chunked_reference``, which run on any device; on a CUDA
  device their loop replays a captured step, or record block, as a CUDA
  graph, bit for bit the eager loop);
* CUDA tensors launch the hand-written flight kernel of
  ``kernels/flight_summary.py`` through ``engine.batch``: its summary build
  for ``simulate_summary`` (the counterpart of the JAX package's Pallas
  kernel ``simulate_summary_pallas``), its carry build, one launch a chunk,
  for ``simulate_batch_chunked``, and its recording build and derived pass
  for ``simulate_flight``, each with the stacked engine's speed
  (``KernelFlags.stacked_speed``: a NaN speed counts 0, as ``safe_norm``
  makes it). A single flight flies as one lane and is squeezed back.

There is no fallback from one route to the other: a kernel that does not
build or launch raises. Both routes refuse ``descent_dt_scale != 1`` and
fly RK4 on the wind table as given whatever ``integrator`` and
``wind_table_bf16`` say, as the JAX package's stacked path does. Reported
times are offset by the rail exit time.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.flight_summary import check_chunk_steps, flight_summary_chunked, max_chunks
from ..models.atmosphere import atmosphere_properties
from ..models.motor import thrust_at
from ..models.rocket import aero_coefficients, dynamic_cp, mass_properties
from ..models.wind import wind_at_altitude
from ..ops.frames import angle_of_attack, mach_number, sideslip_angle
from ..ops.quaternion import (quaternion_to_euler, quaternion_to_rotation_matrix,
                              rotate_by_matrix_t)
from ..utils.tree import floats_as, tree_map
from .component import _blocks, record_names, step_time
from .config import SimConfig
from .integrator import StepCarry, advance, init_carry
from .rail import RailInfo, simulate_rail, simulate_rail_masked
from .state import FlightState, InitialConditions, initial_state

__all__ = ["FlightSummary", "Trajectory", "simulate_summary", "simulate_flight",
           "simulate_batch_chunked", "simulate_summary_reference", "simulate_flight_reference",
           "simulate_batch_chunked_reference"]


@dataclasses.dataclass(frozen=True)
class FlightSummary:
    """Per-flight outputs: the headline metrics (times offset by the rail
    exit time), final state, event flags and rail diagnostics."""

    apogee_altitude: torch.Tensor
    apogee_time: torch.Tensor
    range: torch.Tensor
    flight_time: torch.Tensor
    landing_position: torch.Tensor  # [..., 3]
    final_velocity: torch.Tensor  # [..., 3]
    max_speed: torch.Tensor
    parachute_deployed: torch.Tensor  # bool
    diverged: torch.Tensor  # bool
    n_steps: torch.Tensor  # int32
    rail: RailInfo


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """A recorded history, ``[B, T, ...]`` leaves (``[T, ...]`` for a single
    flight). ``valid[..., k]`` is True for the frames the reference would
    have recorded (before the lane stopped); frame 0 is the rail-exit
    state, times are offset by the rail exit time. ``derived`` maps the
    recorded derived channels to ``[B, T]`` tensors, the Euler angles
    stacked as ``euler_angles [B, T, 3]`` (empty without
    ``record_derived``)."""

    time: torch.Tensor  # [B, T]
    position: torch.Tensor  # [B, T, 3]
    velocity: torch.Tensor  # [B, T, 3]
    quaternion: torch.Tensor  # [B, T, 4]
    angular_velocity: torch.Tensor  # [B, T, 3]
    propellant_fraction: torch.Tensor  # [B, T]
    valid: torch.Tensor  # [B, T] bool
    derived: dict


def _summary_from_carry(carry: StepCarry, rail_info: RailInfo) -> FlightSummary:
    ev = carry.events
    pos = carry.state.position
    return FlightSummary(
        apogee_altitude=ev.max_altitude,
        apogee_time=ev.t_at_max_altitude - carry.rail_time,
        range=torch.sqrt(pos[..., 0] ** 2 + pos[..., 1] ** 2),
        flight_time=ev.end_time - carry.rail_time,
        landing_position=pos,
        final_velocity=carry.state.velocity,
        max_speed=ev.max_speed,
        parachute_deployed=ev.parachute_deployed,
        diverged=ev.diverged,
        n_steps=carry.step,
        rail=rail_info,
    )


def _require_parity_dt(cfg: SimConfig) -> None:
    """The tiered timestep (``descent_dt_scale``) is implemented on the
    component path only, and is refused here as in the JAX package."""
    if cfg.descent_dt_scale != 1:
        raise ValueError(
            "descent_dt_scale is implemented on the component path "
            "(erpl_monte_carlo_sim_tpu_torch.engine.simulate_summary_batch); this "
            "stacked-vector path supports parity settings only. Use descent_dt_scale=1 "
            "(e.g. dataclasses.replace(cfg, descent_dt_scale=1, ascent_q_threshold=0.0)).")


def _stacked_cfg(cfg: SimConfig) -> SimConfig:
    """``cfg`` as the stacked-vector engine reads it, on either route:
    parity timestep only (``_require_parity_dt``), and ``integrator`` and
    ``wind_table_bf16``, which the JAX package's stacked path does not read
    (it always integrates RK4 on the wind table as given), set to ``"rk4"``
    and ``False``, so the kernel on the card, which would honour them, flies
    the same function as the CPU."""
    _require_parity_dt(cfg)
    return dataclasses.replace(cfg, integrator="rk4", wind_table_bf16=False)


def _select(run: torch.Tensor, new, old):
    """``new`` where ``run``, else ``old``, leaf by leaf of a carry."""
    if dataclasses.is_dataclass(new):
        return type(new)(*(_select(run, getattr(new, f.name), getattr(old, f.name))
                           for f in dataclasses.fields(new)))
    return torch.where(run.reshape(run.shape + (1,) * (new.ndim - run.ndim)), new, old)


def _flatten(carry: StepCarry) -> tuple:
    """A carry's tensors in field order (what ``component._capture`` takes)."""
    if dataclasses.is_dataclass(carry):
        return tuple(x for f in dataclasses.fields(carry)
                     for x in _flatten(getattr(carry, f.name)))
    return (carry,)


def _unflatten(like: StepCarry, flat) -> StepCarry:
    """``_flatten``'s inverse, on the structure of ``like``."""
    it = iter(flat)

    def build(x):
        if dataclasses.is_dataclass(x):
            return type(x)(*(build(getattr(x, f.name)) for f in dataclasses.fields(x)))
        return next(it)

    return build(like)


def _running(carry: StepCarry, cfg: SimConfig) -> torch.Tensor:
    """Lanes that take another step: not stopped, inside ``max_time``."""
    return ~carry.events.done & (step_time(carry.rail_time, carry.step, cfg.dt) < cfg.max_time)


def _chunk_lane_active(carry: StepCarry, cfg: SimConfig) -> torch.Tensor:
    """Lanes that take another step: not stopped, inside ``max_time`` and
    ``max_steps``."""
    return _running(carry, cfg) & (carry.step < cfg.max_steps)


def _masked_advance(scene, cfg: SimConfig, carry: StepCarry, bounded: bool):
    """``advance`` on the running lanes, with ``max_steps`` as a bound too
    where ``bounded``. Returns ``(carry', run)``."""
    run = _chunk_lane_active(carry, cfg) if bounded else _running(carry, cfg)
    return _select(run, advance(scene, cfg, carry), carry), run


def _run_chunk(scene, carry: StepCarry, cfg: SimConfig, chunk_steps: int):
    """At most ``chunk_steps`` masked steps (fewer once no lane runs):
    ``(carry', whether a lane still runs)``. On a CUDA device the step
    replays as a CUDA graph (``component._blocks``), bit for bit the eager
    loop."""
    def step(flat):
        return _flatten(_masked_advance(scene, cfg, _unflatten(carry, flat), bounded=True)[0])

    flat, _ = _blocks(step, _flatten(carry), chunk_steps,
                      lambda f: _chunk_lane_active(_unflatten(carry, f), cfg).any(), 1)
    carry = _unflatten(carry, flat)
    return carry, bool(_chunk_lane_active(carry, cfg).any())


def simulate_summary_reference(scene, ic: InitialConditions,
                               cfg: SimConfig = SimConfig()) -> FlightSummary:
    """The plain version of ``simulate_summary``, on any device: the rail
    phase, then ``advance`` on the lanes that run until every lane stopped
    (``max_time``, ``max_steps``): one chunk of ``max_steps`` steps.
    ``cfg.unroll`` is not read: the result is the same for any value."""
    cfg = _stacked_cfg(cfg)
    scene = floats_as(scene, ic.position.dtype)  # the ICs' dtype, as engine.batch
    state_exit, rail_time, rail_info = simulate_rail(scene, cfg, initial_state(ic))
    carry, _ = _run_chunk(scene, init_carry(state_exit, rail_time), cfg, cfg.max_steps)
    return _summary_from_carry(carry, rail_info)


def simulate_batch_chunked_reference(scene_b, ic_b: InitialConditions,
                                     cfg: SimConfig = SimConfig(), chunk_steps: int = 8192,
                                     progress=None) -> FlightSummary:
    """The plain version of ``simulate_batch_chunked``, on any device: the
    masked rail phase, then chunks of at most ``chunk_steps`` masked steps
    (``_run_chunk``) until no lane runs, at most ``ceil(max_steps /
    chunk_steps) + 1`` chunks, with ``progress(k, that bound)`` after chunk
    ``k``. The masked steps leave a stopped lane as it is, so the result
    is ``simulate_summary_reference``'s bit for bit."""
    cfg = _stacked_cfg(cfg)
    chunk_steps = check_chunk_steps(chunk_steps)
    scene_b = floats_as(scene_b, ic_b.position.dtype)
    state_exit, rail_time, rail_info = simulate_rail_masked(scene_b, cfg, initial_state(ic_b))
    carry = init_carry(state_exit, rail_time)
    n_chunks = max_chunks(cfg, chunk_steps)
    for k in range(1, n_chunks + 1):
        carry, any_active = _run_chunk(scene_b, carry, cfg, chunk_steps)
        if progress is not None:
            progress(k, n_chunks)
        if not any_active:
            break
    return _summary_from_carry(carry, rail_info)


def _derived_quantities(scene, cfg: SimConfig, t_abs, state: FlightState) -> dict:
    """The derived outputs of recorded states, the reference's extraction
    loop field for field. Its thrust takes the time ``t_abs`` given (the
    caller passes the offset time) without the burn gating of the
    right-hand side, as the reference's extraction loop does."""
    del cfg
    rocket = scene.rocket
    mp = mass_properties(rocket, state.propellant_fraction)
    alt = state.position[..., 2]
    atm = atmosphere_properties(scene.atmosphere, alt)
    vel_rel = state.velocity - wind_at_altitude(scene.wind, alt)
    vel_body = rotate_by_matrix_t(quaternion_to_rotation_matrix(state.quaternion), vel_rel)
    mach = mach_number(vel_rel, atm.temperature)
    aoa = angle_of_attack(vel_body)
    beta = sideslip_angle(vel_body)
    cp_val = dynamic_cp(rocket, mach)
    coeffs = aero_coefficients(rocket, mach, aoa, beta, center_of_mass=mp.center_of_mass,
                               power_on=(state.propellant_fraction > 0.0))
    q_dyn = 0.5 * atm.density * torch.linalg.vector_norm(vel_rel, dim=-1) ** 2
    return {
        "mass": mp.mass,
        "center_of_mass": mp.center_of_mass,
        "Ixx": mp.Ixx,
        "Iyy": mp.Iyy,
        "Izz": mp.Izz,
        "euler_angles": quaternion_to_euler(state.quaternion),
        "thrust": thrust_at(scene.motor, t_abs, atm.pressure),
        "drag": q_dyn * coeffs.cd * rocket.reference_area,
        "cd": coeffs.cd,
        "cl": coeffs.cl,
        "cm": coeffs.cm,
        "cp_location_dynamic": cp_val,
        "stability_margin": (cp_val - mp.center_of_mass) / rocket.reference_diameter,
        "angle_of_attack": aoa,
        "sideslip_angle": beta,
        "speed": torch.linalg.vector_norm(state.velocity, dim=-1),
        "altitude": alt,
        "mach": mach,
    }


def _recorded(cfg: SimConfig, derived: dict) -> dict:
    """The derived channels ``cfg`` records (``engine.component.record_names``)."""
    names = set(record_names(cfg))
    return {k: v for k, v in derived.items()
            if k in names or (k == "euler_angles" and "euler_roll" in names)}


def simulate_flight_reference(scene, ic: InitialConditions, cfg: SimConfig = SimConfig()):
    """The plain version of ``simulate_flight``, on any device:
    ``(FlightSummary, Trajectory)``. A frame every ``record_stride`` masked
    steps, ``ceil(max_steps / record_stride) + 1`` frames; once every lane
    stopped, the frames left repeat the stopped state, not valid (the JAX
    package's fixed-length scan records them so). On a CUDA device a block
    of ``record_stride`` steps and its frame replay as a CUDA graph
    (``component._blocks``)."""
    cfg = _stacked_cfg(cfg)
    scene = floats_as(scene, ic.position.dtype)  # the ICs' dtype, as engine.batch
    state_exit, rail_time, rail_info = simulate_rail(scene, cfg, initial_state(ic))
    carry = init_carry(state_exit, rail_time)
    stride = max(1, cfg.record_stride)
    n_records = -(-cfg.max_steps // stride)

    # time-major [T, ...] frames of the state and the step counter
    def frame(c: StepCarry) -> tuple:
        return (*_flatten(c.state), c.step)

    bufs = [x.new_zeros((n_records + 1,) + x.shape) for x in frame(carry)]
    for b, x in zip(bufs, frame(carry)):
        b[0] = x
    valid = torch.zeros((n_records + 1,) + carry.step.shape, dtype=torch.bool,
                        device=carry.step.device)
    valid[0] = True

    def block(flat):
        c, i = _unflatten(carry, flat[:-1]), flat[-1]
        c, ran = _masked_advance(scene, cfg, c, bounded=False)
        for _ in range(stride - 1):
            c = _masked_advance(scene, cfg, c, bounded=False)[0]
        for b, x in zip(bufs, frame(c)):
            b.index_copy_(0, i, x[None])
        valid.index_copy_(0, i, ran[None])
        return (*_flatten(c), i + 1)

    i0 = torch.ones(1, dtype=torch.int64, device=carry.step.device)
    flat, done = _blocks(block, (*_flatten(carry), i0), n_records,
                         lambda f: _running(_unflatten(carry, f[:-1]), cfg).any(), stride)
    carry = _unflatten(carry, flat[:-1])
    for b, x in zip(bufs, frame(carry)):  # the stopped tail
        b[done + 1:] = x

    state = FlightState(*bufs[:-1])
    t_off = bufs[-1].to(rail_time.dtype) * cfg.dt
    derived = (_recorded(cfg, _derived_quantities(scene, cfg, t_off, state))
               if cfg.record_derived else {})
    lane_axis = ic.position.ndim - 1

    def out(x):  # the time axis after the lane axis
        return x.movedim(0, lane_axis)

    traj = Trajectory(
        time=out(t_off), position=out(state.position), velocity=out(state.velocity),
        quaternion=out(state.quaternion), angular_velocity=out(state.angular_velocity),
        propellant_fraction=out(state.propellant_fraction), valid=out(valid),
        derived={k: out(v) for k, v in derived.items()})
    return _summary_from_carry(carry, rail_info), traj


def _on_card(ic: InitialConditions) -> bool:
    device = ic.position.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the flight runs on cpu or cuda, not {device}")
    return device.type == "cuda"


def _as_lanes(ic: InitialConditions):
    """``(ic with a lane axis, squeeze)``: a single flight's ``[3]`` initial
    conditions become one lane, and ``squeeze`` takes the lane axis off
    every leaf of a result again."""
    if ic.position.ndim == 2:
        return ic, lambda obj: obj
    if ic.position.ndim != 1:
        raise ValueError(f"initial conditions must be [3] or [B, 3], got "
                         f"{tuple(ic.position.shape)}")
    return tree_map(lambda x: x[None], ic), lambda obj: tree_map(lambda x: x[0], obj)


def simulate_summary(scene, ic: InitialConditions,
                     cfg: SimConfig = SimConfig()) -> FlightSummary:
    """Whole flights to their ``FlightSummary``: on CUDA tensors one launch
    of the flight kernel's summary build, on CPU tensors the stacked plain
    version."""
    cfg = _stacked_cfg(cfg)
    if not _on_card(ic):
        return simulate_summary_reference(scene, ic, cfg)
    from .batch import simulate_summary_batch

    ic_b, squeeze = _as_lanes(ic)
    return squeeze(simulate_summary_batch(scene, ic_b, cfg, _stacked_speed=True))


def simulate_batch_chunked(scene_b, ic_b: InitialConditions, cfg: SimConfig = SimConfig(),
                           chunk_steps: int = 8192, progress=None) -> FlightSummary:
    """``simulate_summary``'s flights in chunks of at most ``chunk_steps``
    masked steps, checking on the host between two chunks whether a lane
    still runs, and calling ``progress(k, n)`` after chunk ``k`` of at most
    ``n = ceil(max_steps / chunk_steps) + 1``. The chunks bound one device
    call's time and report progress on a long batch; the result is
    ``simulate_summary``'s, lane for lane. On CUDA tensors one launch of the
    flight kernel's carry build a chunk, on CPU tensors the stacked plain
    version's chunks (``simulate_batch_chunked_reference``)."""
    cfg = _stacked_cfg(cfg)
    chunk_steps = check_chunk_steps(chunk_steps)
    if not _on_card(ic_b):
        return simulate_batch_chunked_reference(scene_b, ic_b, cfg, chunk_steps, progress)
    from .batch import _prepared, _summary_pytree

    ic_l, squeeze = _as_lanes(ic_b)
    return squeeze(_summary_pytree(flight_summary_chunked(*_prepared(scene_b, ic_l), cfg,
                                                          chunk_steps, progress)))


def simulate_flight(scene, ic: InitialConditions, cfg: SimConfig = SimConfig()):
    """Whole flights with their recorded ``Trajectory``: ``(FlightSummary,
    Trajectory)``. On CUDA tensors the flight kernel's recording build and,
    where ``cfg`` records derived channels, its derived pass; on CPU tensors
    the stacked plain recorder."""
    cfg = _stacked_cfg(cfg)
    if not _on_card(ic):
        return simulate_flight_reference(scene, ic, cfg)
    from .batch import simulate_flight_batch

    ic_b, squeeze = _as_lanes(ic)
    summary, traj = simulate_flight_batch(scene, ic_b, cfg, _stacked_speed=True)
    return squeeze(summary), squeeze(traj)
