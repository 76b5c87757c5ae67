"""PyTorch/CUDA port of erpl_monte_carlo_sim_tpu: dispersed 6DOF Monte Carlo
flights of a sounding rocket, on an NVIDIA H100 or on the CPU.

The JAX package ``erpl_monte_carlo_sim_tpu`` is the reference this port is
held against. Main path: ``mc.MonteCarloAnalyzer.run_monte_carlo`` ->
``mc.sample_dispersions`` -> ``engine.simulate_summary_batch`` (the CUDA
kernel ``kernels/flight_summary.py`` on the card) -> ``mc.outlier_mask`` ->
``mc.masked_stats``. The user's entry point is ``example.main``; the
reports and plots are in ``reporting``, the post-hoc tools in ``cli``;
multi-device runs (``torch.distributed``, one rank a device) in ``parallel``.
"""

from . import cli, engine, mc, models, ops, parallel, reporting, utils  # noqa: F401
from .engine import InitialConditions, SimConfig, simulate_summary_batch
from .models import (AtmosphereParams, MotorParams, RocketParams, Scene, WindField,
                     WindModelParams, liquid_motor, nominal_scene, solid_motor)

__all__ = ["InitialConditions", "SimConfig", "simulate_summary_batch",
           "AtmosphereParams", "MotorParams", "RocketParams", "Scene", "WindField",
           "WindModelParams", "liquid_motor", "nominal_scene", "solid_motor",
           "cli", "engine", "mc", "models", "ops", "parallel", "reporting", "utils"]
