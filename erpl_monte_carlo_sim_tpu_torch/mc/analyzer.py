"""Monte Carlo orchestrator (``erpl_monte_carlo_sim_tpu/mc/analyzer.py``).

``run_monte_carlo`` is the single-call branch of the JAX analyzer: sample
``n`` dispersed lanes on the analyzer's device, fly them all in one
``simulate_summary_batch`` call (the CUDA kernel on a card), filter
outliers, reduce statistics, and return the reference-schema analysis dict.
Options of the JAX analyzer that this slice does not port raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..engine.batch import simulate_summary_batch
from ..engine.config import SimConfig
from ..engine.state import InitialConditions
from ..models.scene import Scene, nominal_scene
from ..utils.convert import to_numpy
from .dispersions import UncertaintyParams, sample_dispersions
from .filter import OutlierBounds, decode_reasons, outlier_mask
from .stats import landing_footprint, masked_stats, percentile_ci

__all__ = ["MonteCarloAnalyzer"]

_METRICS = ("apogee_altitude", "range", "flight_time")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _stats_to_py(s: dict) -> dict:
    return {
        "mean": float(s["mean"]),
        "std": float(s["std"]),
        "min": float(s["min"]),
        "max": float(s["max"]),
        "percentiles": [float(v) for v in s["percentiles"].cpu()],
    }


class MonteCarloAnalyzer:
    """Dispersion analysis over a scene: pass ``scene=`` or at least a
    ``motor`` (the other parts default to the nominal vehicle). The device
    and dtype are the scene's."""

    _RANGE_FIELDS = (
        "initial_position_offset", "initial_velocity_offset",
        "initial_attitude_offset", "initial_angular_velocity_offset",
        "mass_multiplier", "thrust_multiplier", "wind_speed",
        "wind_direction", "density_multiplier", "random_seed",
    )

    def __init__(self, rocket=None, motor=None, atmosphere=None, wind_model=None, *,
                 scene: Optional[Scene] = None,
                 uncertainty_params: UncertaintyParams = UncertaintyParams(),
                 sim_config: SimConfig = SimConfig(),
                 bounds: OutlierBounds = OutlierBounds(),
                 mesh=None, max_lanes_per_call: int = 262_144, sampler: str = "prng",
                 sobol_scrambles: int = 1, sobol_wind_modes: int = 0,
                 antithetic: bool = False, control_variates: bool = False,
                 cv_wind_modes: int = 0, cv_wind_speed: int = 0,
                 importance_shift: Optional[dict] = None, two_level_lanes: int = 0,
                 wind_grid_points: int = 100, wind_grid_top: float = 25000.0,
                 wind_table_modes: Optional[int] = None):
        if scene is None:
            if motor is None:
                raise ValueError("provide either scene= or at least a motor")
            scene = nominal_scene(motor)
            for name, part in (("rocket", rocket), ("atmosphere", atmosphere),
                               ("wind_model", wind_model)):
                if part is not None:
                    scene = dataclasses.replace(scene, **{name: part})
        if mesh is not None:
            _not_ported("mesh (multi-device runs)", "P16")
        if sampler != "prng" or sobol_scrambles != 1 or sobol_wind_modes:
            _not_ported(f"sampler={sampler!r} / sobol options", "P12")
        if antithetic:
            _not_ported("antithetic sampling", "P12")
        if importance_shift:
            _not_ported("importance_shift", "P12/P13")
        if control_variates or cv_wind_modes or cv_wind_speed:
            _not_ported("control_variates", "P13")
        if two_level_lanes:
            _not_ported("two_level_lanes", "P13")
        if wind_table_modes is not None:
            _not_ported("wind_table_modes", "P8")
        self.scene = scene
        self.uncertainty_params = uncertainty_params
        self.sim_config = sim_config
        self.bounds = bounds
        self.max_lanes_per_call = max_lanes_per_call
        self.wind_grid_points = wind_grid_points
        self.wind_grid_top = wind_grid_top
        # a single forecast (altitudes[N], wind[N,3]) each lane perturbs
        self.base_altitude_profile = None
        self.base_wind_profile = None

    @property
    def device(self) -> torch.device:
        return self.scene.rocket.dry_mass.device

    def _as_ic(self, initial_conditions) -> InitialConditions:
        dtype = self.scene.rocket.dry_mass.dtype
        if isinstance(initial_conditions, InitialConditions):
            return InitialConditions(*(
                torch.as_tensor(v, dtype=dtype, device=self.device)
                for v in (initial_conditions.position, initial_conditions.velocity,
                          initial_conditions.attitude,
                          initial_conditions.angular_velocity)))
        unknown = set(initial_conditions) - {
            "position", "velocity", "attitude", "angular_velocity"}
        if unknown:
            raise ValueError(
                f"unknown initial_conditions keys {sorted(unknown)}; valid keys are "
                "position, velocity, attitude, angular_velocity (or pass an "
                "InitialConditions)")
        zero = (0.0, 0.0, 0.0)
        return InitialConditions.create(
            self.device, dtype,
            position=initial_conditions.get("position", zero),
            velocity=initial_conditions.get("velocity", zero),
            attitude=initial_conditions.get("attitude", zero),
            angular_velocity=initial_conditions.get("angular_velocity", zero),
        )

    def run_monte_carlo(self, initial_conditions, n_samples: int = 1000,
                        n_processes=None, optimized: bool = False, seed: int = 0,
                        materialize_results: Optional[int] = None,
                        chunk_steps: Optional[int] = None,
                        lane_slab: Optional[int] = None,
                        checkpoint_path: Optional[str] = None,
                        checkpoint_every: int = 16) -> dict:
        """Run ``n_samples`` dispersed flights and analyze them. Returns the
        reference-schema analysis dict plus the per-lane ``summary``,
        ``sample``, ``valid_mask`` and ``reasons``, a ``performance`` block
        and the ``landing_footprint``. ``seed`` seeds a ``torch.Generator``
        on the analyzer's device."""
        del n_processes, optimized, checkpoint_every
        if chunk_steps is not None:
            _not_ported("chunk_steps", "'Left out of the port'")
        slab = lane_slab if lane_slab is not None else self.max_lanes_per_call
        if n_samples > slab:
            _not_ported(f"n_samples > lane_slab ({slab}), the slabbed path,", "P11")
        if checkpoint_path is not None:
            raise ValueError("checkpoint_path applies to slabbed runs (n_samples > "
                             "lane_slab); this run fits one device call")
        ic = self._as_ic(initial_conditions)
        base_wind = None
        if self.base_wind_profile is not None and self.base_altitude_profile is not None:
            base_wind = (self.base_altitude_profile, self.base_wind_profile)

        t_start = time.time()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        scene_b, ic_b, sample = sample_dispersions(
            gen, self.scene, ic, self.uncertainty_params, n_samples,
            base_wind=base_wind, wind_grid_points=self.wind_grid_points,
            wind_grid_top=self.wind_grid_top)
        summary = simulate_summary_batch(scene_b, ic_b, self.sim_config)
        valid, reasons = outlier_mask(summary, self.bounds)
        stats = {k: masked_stats(getattr(summary, k), valid) for k in _METRICS}

        # one readback to the host (also the sync point)
        summary_np = to_numpy(summary)
        valid_np = valid.cpu().numpy()
        reasons_np = reasons.cpu().numpy()
        stats_py = {k: _stats_to_py(v) for k, v in stats.items()}
        for k in stats_py:
            stats_py[k]["percentile_ci"] = percentile_ci(getattr(summary_np, k), valid_np)
        elapsed = time.time() - t_start

        n_valid = int(valid_np.sum())
        sample_np = to_numpy(sample)
        lp = np.asarray(summary_np.landing_position)
        fin = valid_np & np.isfinite(lp[:, 0]) & np.isfinite(lp[:, 1])

        analysis = {
            "n_samples": n_valid,
            "n_failed": 0,  # lanes cannot fail; divergence is an outlier
            "n_outliers": n_samples - n_valid,
            "apogee_altitude": stats_py["apogee_altitude"],
            "range": stats_py["range"],
            "flight_time": stats_py["flight_time"],
            "landing_footprint": landing_footprint(lp[fin, 0], lp[fin, 1]),
            "parameter_ranges_observed": self._parameter_ranges(sample_np, valid_np),
            "summary": summary_np,
            "sample": sample_np,
            "valid_mask": valid_np,
            "reasons": reasons_np,
            "initial_conditions": ic,
            "performance": {
                "total_time": elapsed,
                "simulations_per_second": n_samples / max(elapsed, 1e-9),
                "cores_used": 1,
            },
        }
        limit = 1000 if materialize_results is None else materialize_results
        analysis["results"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=True, limit=limit)
        analysis["outliers"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=False, limit=limit)
        return analysis

    @staticmethod
    def _parameter_ranges(sample_np, valid_np) -> dict:
        """Observed min/max of each dispersion parameter over valid lanes."""
        out = {}
        if valid_np.sum() == 0:
            return out
        for name in MonteCarloAnalyzer._RANGE_FIELDS:
            arr = getattr(sample_np, name)[valid_np]
            out[name] = {"min": arr.min(axis=0).tolist(), "max": arr.max(axis=0).tolist()}
        return out

    @staticmethod
    def _materialize_records(summary_np, sample_np, valid_np, reasons_np,
                             want_valid: bool, limit: int) -> list:
        """Light per-lane records (the reference's per-result dicts without
        the trajectory histories)."""
        idx = np.nonzero(valid_np if want_valid else ~valid_np)[0][:limit]
        records = []
        for i in idx:
            rec = {
                "simulation_id": int(i),
                "apogee_altitude": float(summary_np.apogee_altitude[i]),
                "apogee_time": float(summary_np.apogee_time[i]),
                "range": float(summary_np.range[i]),
                "flight_time": float(summary_np.flight_time[i]),
                "max_speed": float(summary_np.max_speed[i]),
                "landing_position": summary_np.landing_position[i].tolist(),
                "rail_exit_speed": float(summary_np.rail.rail_exit_speed[i]),
                "rail_exit_time": float(summary_np.rail.rail_exit_time[i]),
                "parachute_deployed": bool(summary_np.parachute_deployed[i]),
                "parameters": {
                    "initial_position_offset":
                        sample_np.initial_position_offset[i].tolist(),
                    "initial_velocity_offset":
                        sample_np.initial_velocity_offset[i].tolist(),
                    "initial_attitude_offset":
                        sample_np.initial_attitude_offset[i].tolist(),
                    "initial_angular_velocity_offset":
                        sample_np.initial_angular_velocity_offset[i].tolist(),
                    "mass_multiplier": float(sample_np.mass_multiplier[i]),
                    "thrust_multiplier": float(sample_np.thrust_multiplier[i]),
                    "wind_speed": float(sample_np.wind_speed[i]),
                    "wind_direction": float(sample_np.wind_direction[i]),
                    "density_multiplier": float(sample_np.density_multiplier[i]),
                    "random_seed": int(sample_np.random_seed[i]),
                },
            }
            if not want_valid:
                rec["outlier_reasons"] = decode_reasons(int(reasons_np[i]))
            records.append(rec)
        return records
