"""Reference-schema results dict for a single flight
(``erpl_monte_carlo_sim_tpu/reporting/results.py``).

The post-hoc CLIs (``cli.analyze_outlier``) read exactly these keys, so
this module is the compatibility boundary: a flight of the port gives the
JAX package's dict, key for key. Tensors become NumPy once, at the top;
histories recorded time-major ``[T, 3]`` are stored ``[3, T]`` (the
reference's layout), transposed on the host.
"""

from __future__ import annotations

import numpy as np

from ..engine.config import SimConfig
from ..utils.convert import to_numpy
from ..utils.serialize import object_to_serializable_dict

__all__ = ["to_results_dict"]


def to_results_dict(scene, summary, trajectory, cfg: SimConfig = SimConfig(),
                    initial_conditions=None, lane: int | None = None) -> dict:
    """Build the reference-schema results dict from one simulated flight.

    ``lane``: if the inputs are batched (``[B, ...]`` leaves), select this
    lane. ``scene`` is one lane's unbatched scene (``mc.select_lane``, or
    ``MonteCarloAnalyzer.lane_scenes``)."""
    summary, trajectory = to_numpy(summary), to_numpy(trajectory)

    def pick(x):
        x = np.asarray(x)
        return x[lane] if lane is not None else x

    valid = pick(trajectory.valid).astype(bool)
    n = int(valid.sum())  # includes the rail-exit sample at index 0

    def hist(x):
        return pick(x)[:n]

    time = hist(trajectory.time)
    position = hist(trajectory.position)  # [T, 3]
    velocity = hist(trajectory.velocity)
    quaternion = hist(trajectory.quaternion)
    omega = hist(trajectory.angular_velocity)
    prop = hist(trajectory.propellant_fraction)
    d = {k: hist(v) for k, v in trajectory.derived.items()}
    rail = summary.rail

    results = {
        "time": time,
        "position": position.T,
        "velocity": velocity.T,
        "quaternion": quaternion.T,
        "angular_velocity": omega.T,
        "propellant_fraction": prop,
        "mass": d["mass"],
        "moments_of_inertia": np.stack([d["Ixx"], d["Iyy"], d["Izz"]]),
        "altitude": d["altitude"],
        "speed": d["speed"],
        "euler_angles": d["euler_angles"].T,
        "center_of_mass": d["center_of_mass"],
        "thrust": d["thrust"],
        "drag": d["drag"],
        "cd": d["cd"],
        "cl": d["cl"],
        "cm": d["cm"],
        "cp_location_dynamic": d["cp_location_dynamic"],
        "cp_location": float(to_numpy(scene.rocket.cp_location)),
        "thrust_curve_time": to_numpy(scene.motor.curve_time),
        "thrust_curve_thrust": to_numpy(scene.motor.curve_thrust_sl),
        "stability_margin": d["stability_margin"],
        "angle_of_attack": d["angle_of_attack"],
        "sideslip_angle": d["sideslip_angle"],
        "apogee_time": float(pick(summary.apogee_time)),
        "apogee_altitude": float(pick(summary.apogee_altitude)),
        "range": float(pick(summary.range)),
        "flight_time": float(pick(summary.flight_time)),
        "rail_exit_time": float(pick(rail.rail_exit_time)),
        "rail_exit_position": pick(rail.rail_exit_position),
        "rail_exit_velocity": pick(rail.rail_exit_velocity),
        "rail_exit_speed": float(pick(rail.rail_exit_speed)),
        "rail_exit_euler": pick(rail.rail_exit_euler),
        "rail_exit_angle_of_attack": float(pick(rail.rail_exit_angle_of_attack)),
        "rail_exit_sideslip": float(pick(rail.rail_exit_sideslip)),
        "wind_at_exit": pick(rail.wind_at_exit),
        "rocket_parameters": object_to_serializable_dict(scene.rocket),
        "motor_parameters": object_to_serializable_dict(scene.motor),
        "simulation_assumptions": {
            "max_time": cfg.max_time,
            "dt_initial": cfg.dt,
            # vestigial in the reference (fixed-step RK4), kept for key parity
            "rtol": 1e-4,
            "atol": 1e-7,
            "rail_length": cfg.rail_length,
        },
    }
    if initial_conditions is not None:
        ic = to_numpy(initial_conditions)
        results["initial_conditions"] = {
            "position": pick(ic.position).tolist(),
            "velocity": pick(ic.velocity).tolist(),
            "attitude": pick(ic.attitude).tolist(),
            "angular_velocity": pick(ic.angular_velocity).tolist(),
        }
    wind = to_numpy(scene.wind.wind)
    if np.abs(wind).max() > 0:
        results["wind_profile"] = wind
        results["altitude_profile"] = to_numpy(scene.wind.altitudes)
    # the Monte Carlo trajectory sub-dict
    results["trajectory"] = {
        "time": time,
        "altitude": d["altitude"],
        "position": position,
    }
    return results
