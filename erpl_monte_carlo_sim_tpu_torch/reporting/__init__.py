"""Reporting and visualization: the reference-schema artifacts
(``erpl_monte_carlo_sim_tpu/reporting``)."""

from .plots import (
    plot_convergence,
    plot_exceedance,
    plot_landing_footprint,
    plot_results,
    plot_single_simulation,
    plot_sobol_indices,
    plot_thrust_twr,
    plot_trajectory_cloud,
    plot_trajectory_cloud_3d,
)
from .report import create_output_directory, save_report, save_simulation_results
from .results import to_results_dict

__all__ = [
    "plot_results", "plot_single_simulation", "plot_thrust_twr",
    "plot_trajectory_cloud", "plot_trajectory_cloud_3d",
    "plot_landing_footprint", "plot_exceedance", "plot_sobol_indices",
    "plot_convergence",
    "create_output_directory", "save_report", "save_simulation_results",
    "to_results_dict",
]
