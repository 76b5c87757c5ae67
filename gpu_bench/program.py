"""The system under test, built from a configuration file through the
port's public entry points: the scene (``utils.convert.scene_from_numpy``),
the launch, the dispersions, the ``SimConfig`` and the analyzer; and an
analysis's per-lane summary read back in the reference's names."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["scene", "initial_conditions", "uncertainty", "sim_config", "analyzer", "lanes"]


def scene(config: dict, device, dtype):
    """The configuration's vehicle as the port's ``Scene``, every number
    rounded once from the file to ``dtype`` (no wind: the analyzer draws
    each lane's)."""
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import scene_from_numpy

    parts = {k: {f: np.asarray(v, np.float64) if not isinstance(v, (str, bool)) else v
                 for f, v in part.items()}
             for k, part in config["scene"].items()}
    parts["wind"] = {"altitudes": np.array([0.0, 1.0]), "wind": np.zeros((2, 3))}
    return scene_from_numpy(parts, device, dtype)


def initial_conditions(config: dict, device, dtype):
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions

    return InitialConditions(**{k: torch.as_tensor(np.asarray(v, np.float64), device=device)
                                .to(dtype) for k, v in config["initial_conditions"].items()})


def uncertainty(config: dict, override: dict | None = None):
    from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import UncertaintyParams

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in {**config["dispersions"], **(override or {})}.items()}
    return UncertaintyParams(**fields)


def sim_config(config: dict):
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig

    return SimConfig(**config["sim_config"])


def analyzer(config: dict, device, dtype):
    """The configuration's ``MonteCarloAnalyzer``."""
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer

    return MonteCarloAnalyzer(scene=scene(config, device, dtype), sim_config=sim_config(config),
                              uncertainty_params=uncertainty(config),
                              max_lanes_per_call=int(config["max_lanes_per_call"]),
                              wind_grid_points=int(config["wind_grid"]["points"]),
                              wind_grid_top=float(config["wind_grid"]["top"]))


def lanes(summary) -> dict:
    """The port's ``FlightSummary`` (host arrays) as ``LANE_FIELDS``."""
    out = {k: np.asarray(getattr(summary, k)) for k in (
        "apogee_altitude", "apogee_time", "range", "flight_time", "max_speed",
        "landing_position", "final_velocity")}
    out["rail_exit_time"] = np.asarray(summary.rail.rail_exit_time)
    out["rail_exit_speed"] = np.asarray(summary.rail.rail_exit_speed)
    for k in ("parachute_deployed", "diverged", "n_steps"):
        out[k] = np.asarray(getattr(summary, k)).astype(np.int64)
    return out
