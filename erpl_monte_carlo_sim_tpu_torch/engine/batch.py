"""Batched whole-flight summaries (``erpl_monte_carlo_sim_tpu/engine/batch.py``).

``simulate_summary_batch`` takes a dispersed batch (scene leaves ``[B]`` or
shared, a ``[B, N, 3]`` or shared ``[N, 3]`` wind table, ``[B, 3]`` initial
conditions) and returns a ``FlightSummary`` of ``[B]``/``[B, 3]`` tensors.
Every flight runs through ``kernels.flight_summary``: the CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.flight_summary import flight_summary
from ..ops.quaternion import quaternion_to_euler
from ..utils.tree import tree_map
from .config import SimConfig
from .rail import RailInfo
from .simulate import FlightSummary

__all__ = ["prepare_batch", "simulate_summary_batch"]


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


def simulate_summary_batch(scene_b, ic_b, cfg: SimConfig = SimConfig()) -> FlightSummary:
    """Batched flight summaries. Every float leaf is cast to the dtype of the
    initial conditions first, so both execution paths see one dtype."""
    dtype = ic_b.position.dtype
    scene_b = tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, scene_b)
    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    return _summary_pytree(flight_summary(scene_nw, grid, wind, ics, cfg))


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
