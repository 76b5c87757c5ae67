"""Post-hoc CLI: deep-dive one per-simulation JSON export
(``erpl_monte_carlo_sim_tpu/cli/analyze_outlier.py``): apogee / flight time
/ max speed, stability-margin extrema, quaternion-norm drift, burnout
state, and post-burnout acceleration extrema, read from the result-dict
schema of ``reporting.to_results_dict`` (either package's exports).

Usage: python -m erpl_monte_carlo_sim_tpu_torch.cli.analyze_outlier <dir> <sim_id>
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main(dir_path: str, sim_id: int) -> dict:
    with open(os.path.join(dir_path, f"sim_{sim_id}.json")) as f:
        data = json.load(f)

    velocity = np.array(data["velocity"])
    angular_velocity = np.array(data["angular_velocity"])
    altitude = np.array(data["altitude"])
    speed = np.array(data["speed"])
    euler_angles = np.array(data["euler_angles"])
    quaternion = np.array(data["quaternion"])
    stability_margin = np.array(data["stability_margin"])
    prop_frac = np.array(data["propellant_fraction"])
    mass = np.array(data["mass"])
    thrust = np.array(data["thrust"])
    time = np.array(data["time"])

    print("Apogee:", data["apogee_altitude"])
    print("Flight time:", data["flight_time"])
    print("Max speed:", float(np.max(speed)))
    print("Final altitude:", float(altitude[-1]))
    print("Final velocity:", velocity[:, -1].tolist())
    if "initial_conditions" in data:
        print("Initial attitude:", data["initial_conditions"]["attitude"])
    print("Stability margin min/max:", float(np.min(stability_margin)),
          float(np.max(stability_margin)))
    print("Max |angular velocity|:", float(np.max(np.abs(angular_velocity))))
    print("Has negative stability:", bool(np.any(stability_margin < 0)))
    print("Min propellant fraction:", float(np.min(prop_frac)))
    print("Has negative mass:", bool(np.any(mass < 0)))
    qnorm = np.linalg.norm(quaternion, axis=0)
    print("Quaternion norms at start/end:", float(qnorm[0]), float(qnorm[-1]))
    max_drift = float(np.max(np.abs(qnorm - 1)))
    print("Max quaternion norm deviation:", max_drift)

    burnout_idx = int(np.argmax(prop_frac <= 0)) if np.any(prop_frac <= 0) \
        else len(prop_frac) - 1
    print("Burnout index:", burnout_idx)
    print("Burnout altitude:", float(altitude[burnout_idx]))
    print("Burnout speed:", float(speed[burnout_idx]))
    print("Burnout velocity:", velocity[:, burnout_idx].tolist())
    print("Burnout quaternion:", quaternion[:, burnout_idx].tolist())
    print("Burnout euler:", euler_angles[:, burnout_idx].tolist())
    print("Burnout stability margin:", float(stability_margin[burnout_idx]))
    print("Max thrust after burnout:", float(np.max(thrust[burnout_idx:])))

    out = {
        "apogee": data["apogee_altitude"],
        "flight_time": data["flight_time"],
        "max_speed": float(np.max(speed)),
        "max_quat_norm_drift": max_drift,
        "burnout_index": burnout_idx,
    }
    speeds_post = speed[burnout_idx:]
    if len(speeds_post) > 1:
        time_post = time[burnout_idx:]
        accel = np.diff(speeds_post) / np.diff(time_post)
        print("Max speed acceleration post burnout:", float(np.max(accel)))
        print("Min speed acceleration post burnout:", float(np.min(accel)))
        out["max_accel_post_burnout"] = float(np.max(accel))
    return out


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
