"""End-to-end example: single flight + Monte Carlo + reports + plots
(``erpl_monte_carlo_sim_tpu/example.py``).

Build the scene, load the sample wind forecast, fly one flight, run a
dispersed Monte Carlo perturbing the forecast, and write the report
artifacts, the per-simulation exports and every plot into
``outputs/monte_carlo_<timestamp>/`` under the working directory. On a card
the single flight is the recording build of the flight kernel at one lane
and the Monte Carlo its summary build; ``device="cpu"`` runs the plain
PyTorch versions instead. There is no fallback: ``device="cuda"`` without a
card raises.

Run:  python -m erpl_monte_carlo_sim_tpu_torch.example [n_samples] [--stabilized]
      [--device cuda|cpu]

``--stabilized`` enables the energy-consistent aero decomposition: the
reference's physics diverges under this wind forecast, so the default
parity mode filters most lanes as outliers, exactly like the reference.
Stabilized mode flies every lane to landing.

The figures need matplotlib, imported when the first figure is drawn, after
the report and the exports are written.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .engine import InitialConditions, SimConfig
from .engine.batch import simulate_flight_batch
from .mc import MonteCarloAnalyzer
from .models import WindField, liquid_motor, load_wind_profile_from_csv, nominal_scene
from .reporting import (
    create_output_directory,
    plot_landing_footprint,
    plot_results,
    plot_single_simulation,
    plot_thrust_twr,
    plot_trajectory_cloud,
    plot_trajectory_cloud_3d,
    save_report,
    save_simulation_results,
    to_results_dict,
)
from .utils.logging import configure, get_logger
from .utils.tree import tree_map

log = get_logger("example")

SAMPLE_WIND = os.path.join(os.path.dirname(__file__), "data", "sample_wind.csv")


def main(n_samples: int = 50, stabilized: bool = False, device="cuda"):
    log.info("6DOF Monte Carlo Rocket Simulation (PyTorch)")
    log.info("=" * 50)

    scene = nominal_scene(liquid_motor(device))
    alt_profile, wind_profile = load_wind_profile_from_csv(SAMPLE_WIND)
    scene_with_wind = dataclasses.replace(
        scene, wind=WindField.from_arrays(alt_profile, wind_profile, device))

    ic = InitialConditions.vertical_launch(device)
    cfg = SimConfig(energy_consistent_aero=stabilized)
    if stabilized:
        log.info("(stabilized aero: energy-consistent drag decomposition ON)")

    log.info("\nRunning single simulation...")
    # the Monte Carlo's engine at one lane, recorded
    ic_1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                  ic.angular_velocity)))
    summary, traj = (tree_map(lambda x: x[0], part)
                     for part in simulate_flight_batch(scene_with_wind, ic_1, cfg))
    results = to_results_dict(scene_with_wind, summary, traj, cfg, initial_conditions=ic)
    log.info(f"Rail exit speed: {results['rail_exit_speed']:.2f} m/s")
    log.info(
        f"Rail AoA: {np.degrees(results['rail_exit_angle_of_attack']):.2f} deg, "
        f"sideslip: {np.degrees(results['rail_exit_sideslip']):.2f} deg"
    )
    log.info(
        f"Apogee altitude: {results['apogee_altitude']:.1f} m "
        f"({results['apogee_altitude'] * 3.28084:.1f} ft)"
    )
    log.info(f"Range: {results['range']:.1f} m")
    log.info(f"Flight time: {results['flight_time']:.1f} s")

    log.info("\nRunning Monte Carlo analysis...")
    mc = MonteCarloAnalyzer(scene=scene, sim_config=cfg)
    mc.base_altitude_profile = alt_profile
    mc.base_wind_profile = wind_profile
    analysis = mc.run_monte_carlo(ic, n_samples=n_samples)

    log.info(f"Valid: {analysis['n_samples']}  outliers: {analysis['n_outliers']}  "
             f"({analysis['performance']['simulations_per_second']:.1f} sims/s)")
    if analysis["n_samples"]:
        s = analysis["apogee_altitude"]
        log.info(f"Apogee: mean {s['mean']:.1f} m  std {s['std']:.1f} m  "
                 f"95% CI [{s['percentiles'][0]:.1f}, {s['percentiles'][4]:.1f}] m")

    output_dir = create_output_directory()
    save_report(analysis, output_dir, analyzer=mc)
    save_simulation_results(mc, analysis, output_dir)
    plot_results(analysis, output_dir)
    if analysis["n_samples"]:
        fp = analysis["landing_footprint"]
        log.info(f"Landing footprint: mean ({fp['mean_m'][0]:.0f}, "
                 f"{fp['mean_m'][1]:.0f}) m  CEP {fp['cep_m']:.0f} m  "
                 f"95% ellipse {fp['ellipse95']['semi_major_m']:.0f} x "
                 f"{fp['ellipse95']['semi_minor_m']:.0f} m")
        plot_landing_footprint(analysis, output_dir)
        plot_trajectory_cloud(mc, analysis, output_dir)
        plot_trajectory_cloud_3d(mc, analysis, output_dir)
    plot_single_simulation(results, output_dir)
    plot_thrust_twr(results, output_dir)
    log.info(f"Report and plots saved to: {output_dir}")
    return results, analysis, output_dir


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="single flight + Monte Carlo + reports + plots")
    ap.add_argument("n_samples", nargs="?", type=int, default=50)
    ap.add_argument("--stabilized", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    configure()
    main(args.n_samples, stabilized=args.stabilized, device=args.device)
