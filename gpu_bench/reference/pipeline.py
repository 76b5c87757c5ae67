"""The plain reference of one analysis: draw, flights, statistics.

Everything here is plain PyTorch and NumPy under the benchmark's folder
(frozen copies of the port's plain code as of commit 848e839, trimmed to what
an analysis runs) and imports nothing of the program. The benchmark hands
both sides the same configuration file and seed; the reference works out the
lanes, the flights and the statistics again from them.

``compute`` (the low-precision control) runs every stage's arithmetic in a
lower dtype than the configuration states; the draws themselves, whose bits
are integer hashes, are made in the lanes' dtype and rounded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import random
from .engine.component import INT_KEYS, flight_components, table_wind_fn
from .engine.config import SimConfig
from .engine.state import InitialConditions
from .models.atmosphere import AtmosphereParams
from .models.motor import MotorParams
from .models.rocket import RocketParams
from .models.scene import Scene
from .models.wind import WindField, WindModelParams
from .sampler import SAMPLE_FIELDS, UncertaintyParams, draw_lanes
from .utils.tree import floats_as, is_static

__all__ = ["make_scene", "make_ic", "make_params", "make_sim_config", "draw", "fly",
           "LANE_FIELDS", "SAMPLE_FIELDS"]

# the per-lane flight leaves an analysis reports, in the port's names
LANE_FIELDS = ("apogee_altitude", "apogee_time", "range", "flight_time", "max_speed",
               "landing_position", "final_velocity", "rail_exit_time", "rail_exit_speed",
               "parachute_deployed", "diverged", "n_steps")

# the scene's shared tables, never per lane (whatever their length)
_TABLES = ("cd_mach", "cd0_table", "cda_table", "cp_shift_mach", "cp_shift_table", "curve_time",
           "curve_thrust_sl")
_PARTS = {"rocket": RocketParams, "motor": MotorParams, "atmosphere": AtmosphereParams,
          "wind_model": WindModelParams}


def _part(cls, numbers: dict, device, dtype):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in numbers:
            continue
        v = numbers[f.name]
        kwargs[f.name] = v if is_static(f) else torch.as_tensor(
            np.asarray(v, np.float64), device=device).to(dtype)
    return cls(**kwargs)


def make_scene(config: dict, device, dtype) -> Scene:
    """The configuration's vehicle, motor, atmosphere and wind model, every
    number rounded once from the file to ``dtype``; no wind until drawn."""
    parts = {k: _part(cls, config["scene"][k], device, dtype) for k, cls in _PARTS.items()}
    return Scene(wind=WindField(altitudes=torch.tensor([0.0, 1.0], dtype=dtype, device=device),
                                wind=torch.zeros((2, 3), dtype=dtype, device=device)), **parts)


def make_ic(config: dict, device, dtype) -> InitialConditions:
    return InitialConditions(**{k: torch.as_tensor(np.asarray(v, np.float64), device=device)
                                .to(dtype) for k, v in config["initial_conditions"].items()})


def make_params(config: dict, override: dict | None = None) -> UncertaintyParams:
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in {**config["dispersions"], **(override or {})}.items()}
    return UncertaintyParams(**fields)


def make_sim_config(config: dict) -> SimConfig:
    return SimConfig(**config["sim_config"])


def grid_of(config: dict, device, dtype) -> torch.Tensor:
    g = config["wind_grid"]
    return torch.linspace(0.0, float(g["top"]), int(g["points"]), dtype=dtype, device=device)


def draw(config: dict, seed_key: torch.Tensor, n: int, device, dtype, base_profile=None,
         params_override=None, compute=None):
    """``n`` lanes of the configuration under the threefry key
    ``seed_key`` (``[2]`` words), with an optional forecast ``(altitudes,
    profile)`` each lane perturbs."""
    scene = make_scene(config, device, dtype)
    ic = make_ic(config, device, dtype)
    params = make_params(config, params_override)
    if base_profile is not None:
        grid = torch.as_tensor(np.asarray(base_profile[0]), dtype=dtype, device=device)
        profile = base_profile[1]
    else:
        grid, profile = grid_of(config, device, dtype), None
    return draw_lanes(seed_key.to(device), scene, ic, params, n, grid, profile, compute)


def key_of(seed: int, device=None) -> torch.Tensor:
    return random.prng_key(seed, device)


def fly(scene_b: Scene, ic_b: InitialConditions, cfg: SimConfig, idx=None,
        compute=None) -> dict:
    """The plain flights of the lanes ``idx`` (all when None) of a batch:
    ``LANE_FIELDS`` as host NumPy arrays."""
    n = ic_b.position.shape[0]
    dtype = compute or ic_b.position.dtype

    def take(t):
        if idx is not None and t.ndim >= 1 and t.shape[0] == n:
            t = t[idx]
        return t.contiguous()

    scene = floats_as(scene_b, dtype)
    wind = take(scene.wind.wind)
    grid = scene.wind.altitudes.contiguous()
    scene_nw = dataclasses.replace(scene, wind=None)
    scene_nw = dataclasses.replace(scene_nw, **{
        part: type(getattr(scene_nw, part))(**{
            f.name: (getattr(getattr(scene_nw, part), f.name) if is_static(f) or f.name in _TABLES
                     else take(getattr(getattr(scene_nw, part), f.name)))
            for f in dataclasses.fields(getattr(scene_nw, part))})
        for part in ("rocket", "motor", "atmosphere")})
    ics = tuple(take(arr[..., c].to(dtype)) for arr in (ic_b.position, ic_b.velocity,
                                                         ic_b.attitude, ic_b.angular_velocity)
                for c in range(3))
    out = flight_components(scene_nw, cfg, table_wind_fn(grid, wind), ics)
    return lanes_of(out)


def lanes_of(out: dict) -> dict:
    """``LANE_FIELDS`` of a ``flight_components`` result, on the host."""
    def h(x):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()

    def vec(prefix):
        return np.stack([h(out[prefix + c]) for c in "xyz"], axis=-1)

    lanes = {k: h(out[k]) for k in ("apogee_altitude", "apogee_time", "range", "flight_time",
                                     "max_speed", "rail_exit_time", "rail_exit_speed")}
    lanes["landing_position"] = vec("final_p")
    lanes["final_velocity"] = vec("final_v")
    for k in INT_KEYS:
        lanes[k] = h(out[k]).astype(np.int64)
    return {k: lanes[k] for k in LANE_FIELDS}


def sample_host(sample: dict, idx=None) -> dict:
    """A drawn sample's ``SAMPLE_FIELDS`` on the host (float64, ids int64)."""
    out = {}
    for k in SAMPLE_FIELDS:
        t = sample[k]
        if idx is not None:
            t = t[idx]
        t = t.detach().cpu()
        out[k] = t.double().numpy() if t.is_floating_point() else t.numpy().astype(np.int64)
    return out
