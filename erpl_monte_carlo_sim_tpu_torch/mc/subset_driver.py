"""The analyzer's rare-event entry points (``erpl_monte_carlo_sim_tpu/mc/subset_driver.py``).

``MonteCarloAnalyzer.subset_tail`` and ``subset_quantile`` re-express the
dispersion distribution as a push-forward of N(0, I_d)
(``mc.dispersions.sample_from_normals``: the 19 scalar channels and the
per-lane AR(1) turbulence driver) and drive ``mc.subset``'s multilevel
splitting with batched flights: every chain step is one call of
``simulate_summary_batch`` on the analyzer's device (one K1 launch on a
card), or with ``chunk_steps`` of ``engine.simulate_batch_chunked`` (one
launch a chunk), and its values come back to the host for the chains.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine.batch import simulate_summary_batch
from ..engine.simulate import simulate_batch_chunked
from .dispersions import normal_dims, sample_from_normals
from .filter import outlier_mask

__all__ = ["SubsetDriverMixin"]


class SubsetDriverMixin:
    """Rare-event methods of ``MonteCarloAnalyzer``."""

    def subset_tail(self, initial_conditions, metric: str, threshold: float, *,
                    direction: str = "above", n_per_level: int = 2048, p0: float = 0.125,
                    seed: int = 0, n_runs: int = 1, beta0: float = 0.6, max_levels: int = 15,
                    chunk_steps: Optional[int] = None) -> dict:
        """P(metric > threshold) by subset simulation (``mc.subset``), down
        to about 1e-9 at a few thousand flights per decade. ``direction=
        "below"`` estimates P(metric < threshold). Invalid lanes never
        exceed: ``probability`` is the joint P(exceed and valid), and
        ``probability_given_valid`` divides it by level 0's valid fraction.
        The analyzer's sampler options do not apply (the run draws its own
        normals); forecast ensembles are refused. ``n_runs > 1`` runs seeds
        ``seed .. seed + n_runs - 1`` and pools them (``pool_subset_runs``,
        the between-seed interval). ``failure_channels`` profiles the final
        populations' failure samples."""
        from .subset import pool_subset_runs, subset_simulation

        g_fn, d, n_knots, sign = self._subset_g_fn(initial_conditions, metric, direction,
                                                   n_runs, chunk_steps)
        results, pop_u, pop_fail = [], [], []
        for k in range(int(n_runs)):
            r = subset_simulation(g_fn, d, threshold=sign * float(threshold),
                                  n_per_level=n_per_level, p0=p0, seed=seed + k, beta0=beta0,
                                  max_levels=max_levels, return_population=True)
            pop_u.append(r.pop("u_final"))
            pop_fail.append(r.pop("g_final") >= sign * float(threshold))
            # the internal, sign-flipped thresholds back in metric units
            r["threshold"] = float(threshold)
            for lv in r["levels"]:
                lv["threshold"] = sign * lv["threshold"]
            results.append(r)
        res = results[0] if int(n_runs) == 1 else pool_subset_runs(results)
        res["failure_channels"] = self._failure_channels(
            np.concatenate(pop_u, axis=0), np.concatenate(pop_fail, axis=0), n_knots)
        res["metric"] = metric
        res["direction"] = direction
        vf = res["valid_fraction"]
        res["probability_given_valid"] = res["probability"] / vf if vf > 0 else float("nan")
        return res

    def subset_quantile(self, initial_conditions, metric: str, p_target: float, *,
                        direction: str = "above", n_per_level: int = 2048, p0: float = 0.125,
                        seed: int = 0, n_runs: int = 1, beta0: float = 0.6,
                        chunk_steps: Optional[int] = None) -> dict:
        """The bound ``T`` with P(metric > T) = ``p_target`` by subset
        simulation: the inverse of ``subset_tail``, with its conventions
        (``p_target`` is a joint exceed-and-valid fraction). ``n_runs > 1``
        pools the seeds (``pool_subset_quantiles``: the mean bound with a
        between-seed Student-t interval in metric units)."""
        from .subset import pool_subset_quantiles, subset_quantile

        g_fn, d, n_knots, sign = self._subset_g_fn(initial_conditions, metric, direction,
                                                   n_runs, chunk_steps)
        results, pop_u, pop_fail = [], [], []
        for k in range(int(n_runs)):
            r = subset_quantile(g_fn, d, p_target=float(p_target), n_per_level=n_per_level,
                                p0=p0, seed=seed + k, beta0=beta0, return_population=True)
            pop_u.append(r.pop("u_final"))
            pop_fail.append(r.pop("g_final") >= r["threshold"])
            r["threshold"] = sign * r["threshold"]
            lo, hi = r["ci95_threshold"]
            r["ci95_threshold"] = sorted(
                [sign * lo, sign * hi], key=lambda v: (np.isnan(v), v),
            ) if direction == "below" else [lo, hi]
            for lv in r["levels"]:
                lv["threshold"] = sign * lv["threshold"]
            results.append(r)
        res = results[0] if int(n_runs) == 1 else pool_subset_quantiles(results)
        res["failure_channels"] = self._failure_channels(
            np.concatenate(pop_u, axis=0), np.concatenate(pop_fail, axis=0), n_knots)
        res["metric"] = metric
        res["direction"] = direction
        return res

    def _subset_g_fn(self, initial_conditions, metric: str, direction: str, n_runs: int,
                     chunk_steps):
        """Checks the options and returns ``(g_fn, d, n_knots, sign)``:
        ``g_fn`` maps a host ``[n, d]`` array of standard normals to the
        host ``[n]`` array of ``sign * metric``, with invalid and non-finite
        lanes at ``-inf``, flying the lanes on the analyzer's device (with
        ``chunk_steps``, through ``engine.simulate_batch_chunked``)."""
        scalar_metrics = ("apogee_altitude", "apogee_time", "range", "flight_time",
                          "max_speed")
        if metric not in scalar_metrics:
            raise ValueError(f"metric must be one of {scalar_metrics}, got {metric!r}")
        if direction not in ("above", "below"):
            raise ValueError(f"direction must be 'above' or 'below', got {direction!r}")
        if int(n_runs) < 1:
            raise ValueError(f"n_runs must be >= 1, got {n_runs}")
        ic = self._as_ic(initial_conditions)
        base_wind = None
        if self.base_wind_profile is not None and self.base_altitude_profile is not None:
            if np.ndim(self.base_wind_profile) == 3:
                raise ValueError("subset simulation does not support forecast ensembles; "
                                 "condition on one member (base_wind_profile[k]) and run "
                                 "per member")
            base_wind = (self.base_altitude_profile, self.base_wind_profile)
            n_knots = int(np.shape(self.base_altitude_profile)[0])
        else:
            n_knots = int(self.wind_grid_points)
        d = normal_dims(n_knots)
        sign = 1.0 if direction == "above" else -1.0
        cfg, bounds, scene, params = (self.sim_config, self.bounds, self.scene,
                                      self.uncertainty_params)

        def g_fn(u_np):
            scene_b, ic_b, _ = sample_from_normals(
                u_np, scene, ic, params=params, base_wind=base_wind,
                wind_grid_points=self.wind_grid_points, wind_grid_top=self.wind_grid_top)
            if chunk_steps is not None:
                summary = simulate_batch_chunked(scene_b, ic_b, cfg, chunk_steps=chunk_steps)
            else:
                summary = simulate_summary_batch(scene_b, ic_b, cfg)
            valid, _ = outlier_mask(summary, bounds)
            vals = getattr(summary, metric)
            out = torch.where(valid & torch.isfinite(vals), sign * vals, -torch.inf)
            return out.cpu().numpy()

        return g_fn, d, n_knots, sign

    # the column layout of mc.dispersions.sample_from_normals (a fixed contract)
    _U_CHANNELS = (
        "initial_position_x", "initial_position_y", "initial_position_z",
        "initial_velocity_x", "initial_velocity_y", "initial_velocity_z",
        "initial_attitude_x", "initial_attitude_y", "initial_attitude_z",
        "initial_angular_velocity_x", "initial_angular_velocity_y",
        "initial_angular_velocity_z",
        "mass", "thrust_recorded", "motor_thrust", "motor_flow",
        "wind_speed", "wind_direction", "density",
    )

    @classmethod
    def _failure_channels(cls, u_final, fail_mask, n_knots: int):
        """The ``failure_channels`` block: each channel's sigma-unit mean and
        std over the final populations' failure samples (the empirical design
        point) and the turbulence driver's mean square per component; None
        when no final lane fails."""
        fail = np.asarray(fail_mask, bool)
        if not fail.any():
            return None
        uf = np.asarray(u_final, np.float64)[fail]
        chans = [{"name": nm, "mean": float(uf[:, j].mean()), "std": float(uf[:, j].std())}
                 for j, nm in enumerate(cls._U_CHANNELS)]
        turb = uf[:, len(cls._U_CHANNELS):].reshape(uf.shape[0], n_knots, 3)
        return {
            "n_failure_samples": int(fail.sum()),
            "channels": chans,
            "turbulence_ms": {"u": float((turb[..., 0] ** 2).mean()),
                              "v": float((turb[..., 1] ** 2).mean()),
                              "w": float((turb[..., 2] ** 2).mean())},
            "note": (
                "sigma-units conditional means over the failure region "
                "(MCMC-correlated samples: indicative, not stderr-exact). "
                "wind_speed/wind_direction are uniform channels — a "
                "positive mean reads 'above median'. thrust_recorded is "
                "the reference's dead channel (drawn but the motor uses "
                "its own draw, monte_carlo.py:170,193): its mean is a "
                "built-in placebo check."
            ),
        }
