"""Batched whole flights (``erpl_monte_carlo_sim_tpu/engine/batch.py``).

``simulate_summary_batch`` takes a dispersed batch (scene leaves ``[B]`` or
shared, a ``[B, N, 3]`` or shared ``[N, 3]`` wind table, ``[B, 3]`` initial
conditions) and returns a ``FlightSummary`` of ``[B]``/``[B, 3]`` tensors.
``simulate_flight_batch`` adds the recorded ``Trajectory``, and
``simulate_envelope_batch`` reduces the recording in the loop to
per-time-bin aggregates. Summaries and trajectories run through
``kernels.flight_summary``: the CUDA kernel (its recording build for a
trajectory) for CUDA tensors, its plain PyTorch version for CPU tensors.
The in-loop envelope runs the eager core on either device (on a card as
replayed CUDA graphs; ``engine.component.flight_components_envelope``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.flight_summary import flight_record, flight_summary, stored_wind
from ..ops.quaternion import quaternion_to_euler
from ..utils.tree import tree_map
from .component import flight_components_envelope, table_wind_fn
from .config import SimConfig
from .rail import RailInfo
from .simulate import FlightSummary, Trajectory

__all__ = ["prepare_batch", "simulate_summary_batch", "simulate_flight_batch",
           "simulate_envelope_batch"]


def prepare_batch(scene_b, ic_b):
    """Split a batched scene into ``(scene without wind, grid [N], wind
    table, 12 contiguous [B] initial-condition tensors)``."""
    wind = scene_b.wind
    scene_nw = dataclasses.replace(scene_b, wind=None)
    ics = tuple(arr[..., c].contiguous()
                for arr in (ic_b.position, ic_b.velocity, ic_b.attitude,
                            ic_b.angular_velocity)
                for c in range(3))
    return scene_nw, wind.altitudes.contiguous(), wind.wind.contiguous(), ics


def _prepared(scene_b, ic_b):
    """``prepare_batch`` with every float leaf cast to the dtype of the
    initial conditions first, so both execution paths see one dtype."""
    dtype = ic_b.position.dtype
    scene_b = tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, scene_b)
    return prepare_batch(scene_b, ic_b)


def simulate_summary_batch(scene_b, ic_b, cfg: SimConfig = SimConfig()) -> FlightSummary:
    """Batched flight summaries."""
    return _summary_pytree(flight_summary(*_prepared(scene_b, ic_b), cfg))


def simulate_flight_batch(scene_b, ic_b, cfg: SimConfig = SimConfig()):
    """Batched flights with their recorded trajectories (JAX
    ``simulate_flight_batch``): ``(FlightSummary, Trajectory)``, the
    trajectory's leaves ``[B, T, ...]`` with ``T = n_frames(cfg)``, every
    ``SimConfig`` flag honoured (the tiered timestep too). The same engine
    and masked steps as ``simulate_summary_batch``, so the summary is its
    summary bit for bit: on a card the recording build of the kernel, on
    the CPU the plain recorder. The ``[T, ...]`` records become the
    ``[B, T, ...]`` trajectory once, outside the loop."""
    res, recs = flight_record(*_prepared(scene_b, ic_b), cfg)
    return _summary_pytree(res), trajectory_of(recs)


def trajectory_of(recs: dict) -> Trajectory:
    """The ``[B, T, ...]`` ``Trajectory`` of time-major ``[T, B]`` records
    (``flight_record``'s or its plain version's), the Euler angles stacked
    into ``euler_angles``."""
    def bt(x):  # [T, B] -> [B, T]
        return x.movedim(0, 1)

    def stack(*keys, src=recs):
        return torch.stack([bt(src[k]) for k in keys], dim=-1)

    d = recs["derived"]
    derived = {k: bt(v) for k, v in d.items() if not k.startswith("euler_")}
    if "euler_roll" in d:  # absent when record_channels leaves it out
        derived["euler_angles"] = stack("euler_roll", "euler_pitch", "euler_yaw", src=d)
    return Trajectory(
        time=bt(recs["time"]),
        position=stack("px", "py", "pz"),
        velocity=stack("vx", "vy", "vz"),
        quaternion=stack("qw", "qx", "qy", "qz"),
        angular_velocity=stack("ox", "oy", "oz"),
        propellant_fraction=bt(recs["frac"]),
        valid=bt(recs["valid"]),
        derived=derived,
    )


def simulate_envelope_batch(scene_b, ic_b, cfg: SimConfig, *, channels, n_bins, n_buckets,
                            bin_dt, lo, width, hist_every: int = 1):
    """Batched flights reduced in the loop to per-time-bin envelope
    aggregates, no ``[T, B]`` frames (JAX ``simulate_envelope_batch``): the
    steps and recording cadence of ``simulate_flight_batch``. ``lo`` and
    ``width`` are calibrated histogram edges ``[C, n_bins]``
    (``mc.envelope.EnvelopeAccumulator`` calibrates them on a frame-based
    first chunk). Returns ``(FlightSummary, agg)`` for
    ``EnvelopeAccumulator.add_aggregates``.

    This is eager PyTorch on either device, on a card replayed as CUDA
    graphs (``engine.component.flight_components_envelope``): no kernel
    computes it."""
    scene_nw, grid, wind, ics = _prepared(scene_b, ic_b)
    res, agg = flight_components_envelope(
        scene_nw, cfg, table_wind_fn(grid, stored_wind(wind, cfg)), ics, tuple(channels),
        int(n_bins), int(n_buckets), bin_dt, lo, width, int(hist_every))
    return _summary_pytree(res), agg


def _summary_pytree(res: dict) -> FlightSummary:
    def stack3(x, y, z):
        return torch.stack([res[x], res[y], res[z]], dim=-1)

    quat = torch.stack([res["quat_w"], res["quat_x"], res["quat_y"], res["quat_z"]],
                       dim=-1)
    rail = RailInfo(
        rail_exit_time=res["rail_exit_time"],
        rail_exit_position=stack3("rail_px", "rail_py", "rail_pz"),
        rail_exit_velocity=stack3("rail_vx", "rail_vy", "rail_vz"),
        rail_exit_speed=res["rail_exit_speed"],
        rail_exit_euler=quaternion_to_euler(quat),
        rail_exit_angle_of_attack=res["rail_exit_angle_of_attack"],
        rail_exit_sideslip=res["rail_exit_sideslip"],
        wind_at_exit=stack3("rail_wu", "rail_wv", "rail_ww"),
    )
    return FlightSummary(
        apogee_altitude=res["apogee_altitude"],
        apogee_time=res["apogee_time"],
        range=res["range"],
        flight_time=res["flight_time"],
        landing_position=stack3("final_px", "final_py", "final_pz"),
        final_velocity=stack3("final_vx", "final_vy", "final_vz"),
        max_speed=res["max_speed"],
        parachute_deployed=res["parachute_deployed"].to(torch.bool),
        diverged=res["diverged"].to(torch.bool),
        n_steps=res["n_steps"],
        rail=rail,
    )
