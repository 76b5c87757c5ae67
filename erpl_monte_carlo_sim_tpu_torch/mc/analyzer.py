"""Monte Carlo orchestrator (``erpl_monte_carlo_sim_tpu/mc/analyzer.py``).

``run_monte_carlo`` samples dispersed lanes on the analyzer's device under
the threefry key ``PRNGKey(seed)`` (``random``: the JAX package's lanes for
the same seed, on the CPU and on a card), flies
them through ``simulate_summary_batch`` (the CUDA kernel on a card, its
plain version on the CPU), filters outliers, reduces statistics and returns
the reference-schema analysis dict. A run that fits one device call
(``n_samples <= lane_slab``) is one call; a larger one runs slab by slab
(``_run_slabbed``), slab k drawn under ``fold_in(PRNGKey(seed), k)`` as the
JAX package draws it, with the statistics accumulated on the host (exactly,
or as streams past ``stats_stream_threshold`` lanes), an optional mid-run
checkpoint, and ``run_to_precision``'s sequential stop. The sampling
variants (``sampler="sobol"`` with ``sobol_scrambles`` and
``sobol_wind_modes``, ``antithetic``, ``importance_shift``, an ensemble base
wind) add the JAX analyzer's ``qmc_error``, ``importance``, ``ensemble`` and
``wind_members`` blocks; the estimators add ``control_variates``
(``control_variates``, ``cv_wind_modes``, ``cv_wind_speed``: ``mc.cv``) and
``two_level`` (``two_level_lanes``: ``mc.two_level``), single-call and
slabbed, and ``subset_tail`` / ``subset_quantile`` (``mc.subset_driver``).
``wind_table_modes=K`` flies each call's lanes on mode-compressed tables
(``models.wind.WindModes``: K turbulence modes plus the mean structure, a
documented approximation, exact at ``K >= wind_grid_points``); the
accumulators keep the realized tables, and the two-level correction's fast
leg flies compressed.

``mesh=`` (a ``parallel.LaneMesh``, one rank a device) spreads each call's
flights over the ranks of a ``torch.distributed`` group: every rank draws
the whole batch from the seed, as a run without a mesh does, flies its
contiguous block of lanes, and the summaries are gathered in lane order
(``parallel.run_sharded_summaries``), so a lane's values do not depend on
the world size and every rank forms the same analysis, the run without a
mesh's. A slabbed run splits each slab
so, and its host accumulators, streams and stop rule go on identically on
every rank; only rank 0 writes a checkpoint, and on resume it reads the
file and hands it to every rank, so the ranks need share no filesystem.
A call or slab whose lanes do not split evenly over the ranks raises
(``parallel.mesh.lane_block``), as the JAX package's ``device_put`` onto
``P("batch")`` refuses an uneven dimension; nothing is padded quietly.

Each run remembers its lanes (``_last_batch``: the single call's batch, or
a slabbed run's recipe), so that ``resimulate_trajectories``, ``lane_scenes``
and ``flight_envelope`` (``mc.resimulate``) can fly any of them again, on
the compressed tables the run flew under ``wind_table_modes``. Both
draws go through one seam each, ``_draw_single`` and ``_draw_slab``, which
the tests replace to feed the JAX package's lanes through the analyzer.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..engine.batch import simulate_summary_batch
from ..engine.config import SimConfig
from ..engine.simulate import simulate_batch_chunked
from ..engine.state import InitialConditions
from ..models.scene import Scene, nominal_scene
from .. import random
from ..utils.convert import to_numpy
from .dispersions import UncertaintyParams, sample_dispersions
from .ensemble import EnsembleAccumulator
from .filter import OutlierBounds, decode_reasons, outlier_mask
from .importance import log_weights, weighted_mean
from .resimulate import ResimulationMixin
from .subset_driver import SubsetDriverMixin
from .stats import PERCENTILES, landing_footprint, masked_stats, percentile_ci

__all__ = ["MonteCarloAnalyzer"]

log = logging.getLogger(__name__)

_METRICS = ("apogee_altitude", "range", "flight_time")


def _draw(analyzer, ic, n: int, key: torch.Tensor, base_wind):
    """``n`` lanes under the threefry ``key`` on the analyzer's device,
    under its sampling options. The seams make the key there: a key moved
    from the host waits for the card."""
    return sample_dispersions(key, analyzer.scene, ic, analyzer.uncertainty_params, n,
                              base_wind=base_wind, wind_grid_points=analyzer.wind_grid_points,
                              wind_grid_top=analyzer.wind_grid_top, sampler=analyzer.sampler,
                              sobol_scrambles=analyzer.sobol_scrambles,
                              sobol_wind_modes=analyzer.sobol_wind_modes,
                              antithetic=analyzer.antithetic,
                              importance_shift=analyzer.importance_shift)


def _draw_single(analyzer, ic, n: int, seed: int, base_wind):
    """A single-call run's ``(scene_b, ic_b, sample)``: ``n`` lanes under
    ``PRNGKey(seed)``. The run's one draw; tests replace it to feed other
    lanes through the run."""
    return _draw(analyzer, ic, n, random.prng_key(seed, analyzer.device), base_wind)


def _draw_slab(analyzer, ic, k: int, slab: int, seed: int, base_wind):
    """Slab ``k``'s ``(scene_b, ic_b, sample)``: always a full slab of lanes
    under ``fold_in(PRNGKey(seed), k)``, so a lane's values depend only on
    ``(seed, k, slab)``; under ``sampler="sobol"`` each slab is its own
    scramble, an independent randomized-QMC replicate. The slab loop's one
    draw; tests replace it to feed other lanes through the loop."""
    return _draw(analyzer, ic, slab, random.fold_in(random.prng_key(seed, analyzer.device), k),
                 base_wind)


def _host_stats(values: np.ndarray, mask: np.ndarray) -> dict:
    """NumPy twin of ``masked_stats`` for the host-accumulated lanes of a
    slabbed run: population std, linear percentiles, and the order-statistic
    percentile intervals."""
    vals = values[mask & np.isfinite(values)]
    if vals.size == 0:
        nan = float("nan")
        return {"mean": nan, "std": nan, "min": nan, "max": nan,
                "percentiles": [nan] * len(PERCENTILES),
                "percentile_ci": [[nan, nan]] * len(PERCENTILES)}
    ones = np.ones(vals.shape, bool)
    return {
        "mean": float(vals.mean()),
        "std": float(vals.std()),
        "min": float(vals.min()),
        "max": float(vals.max()),
        "percentiles": [float(v) for v in np.percentile(vals, PERCENTILES)],
        "percentile_ci": percentile_ci(vals, ones),
    }


def _stats_to_py(s: dict) -> dict:
    return {
        "mean": float(s["mean"]),
        "std": float(s["std"]),
        "min": float(s["min"]),
        "max": float(s["max"]),
        "percentiles": [float(v) for v in s["percentiles"].cpu()],
    }


class MonteCarloAnalyzer(SubsetDriverMixin, ResimulationMixin):
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
                 stats_stream_threshold: int = 4_194_304,
                 metrics_sample_cap: int = 1_048_576,
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
            from ..parallel.mesh import LaneMesh

            if not isinstance(mesh, LaneMesh):
                raise TypeError(f"mesh must be a parallel.LaneMesh (parallel.make_mesh()), "
                                f"not {type(mesh).__name__}")
            dev = scene.rocket.dry_mass.device
            if (mesh.device.type, mesh.device.index or 0) != (dev.type, dev.index or 0):
                raise ValueError(f"the scene lives on {dev}, this rank's device is "
                                 f"{mesh.device}: build the scene on mesh.device")
        if wind_table_modes is not None and wind_table_modes < 1:
            raise ValueError("wind_table_modes must be >= 1 (or None)")
        # regression control variates (mc.cv): the headline means adjusted by
        # their fitted response to the draws, optionally with the top
        # turbulence-mode scores and the wind speed at knots as controls
        if cv_wind_modes < 0:
            raise ValueError("cv_wind_modes must be >= 0")
        if cv_wind_modes and not control_variates:
            raise ValueError("cv_wind_modes requires control_variates=True")
        if cv_wind_speed < 0:
            raise ValueError("cv_wind_speed must be >= 0")
        if cv_wind_speed and not control_variates:
            raise ValueError("cv_wind_speed requires control_variates=True")
        if importance_shift:
            if sampler != "prng" or antithetic:
                raise ValueError("importance_shift requires sampler='prng', no antithetic")
            if control_variates:
                # the controls' known means are the nominal distribution's
                raise ValueError("importance_shift and control_variates are exclusive")
        # two-level bias correction (mc.two_level): this many coupled lanes
        # under the run's fast flags and their parity twin
        if two_level_lanes < 0:
            raise ValueError("two_level_lanes must be >= 0")
        if two_level_lanes:
            from .two_level import FAST_FIELDS, parity_twin

            if parity_twin(sim_config) == sim_config and not wind_table_modes:
                raise ValueError(
                    "two_level_lanes needs at least one fast flag in "
                    f"sim_config (one of {FAST_FIELDS}) or "
                    "wind_table_modes; the config is already exact parity "
                    "— there is no bias to correct")
            if importance_shift:
                raise ValueError("two_level_lanes and importance_shift are exclusive")
        if stats_stream_threshold < 1 or metrics_sample_cap < 1:
            raise ValueError("stats_stream_threshold and metrics_sample_cap must be >= 1")
        self.scene = scene
        self.uncertainty_params = uncertainty_params
        self.sim_config = sim_config
        self.bounds = bounds
        self.mesh = mesh
        # the sampling options of mc.sample_dispersions; slabbed runs and
        # re-simulation draw every lane again under them. With sobol,
        # sobol_scrambles > 1 splits a single call into independently
        # scrambled blocks, whose means give the qmc_error block
        self.sampler = sampler
        self.sobol_scrambles = sobol_scrambles
        self.sobol_wind_modes = sobol_wind_modes
        self.antithetic = antithetic
        # the headline stats then describe the shifted population; the
        # importance block weighs the lanes back to the nominal one
        self.importance_shift = tuple(sorted(importance_shift.items())) \
            if importance_shift else ()
        self.control_variates = control_variates
        self.cv_wind_modes = cv_wind_modes
        self.cv_wind_speed = cv_wind_speed
        self._cv_proj = None  # (grid, projector) memo
        self._cv_spd = None   # (grid, base, knot indices, leaves) memo
        self.two_level_lanes = two_level_lanes
        # a run of more lanes goes slab by slab; past stats_stream_threshold
        # lanes the statistics stream and only the first metrics_sample_cap
        # lanes' metrics are kept
        self.max_lanes_per_call = max_lanes_per_call
        self.stats_stream_threshold = stats_stream_threshold
        self.metrics_sample_cap = metrics_sample_cap
        self.wind_grid_points = wind_grid_points
        self.wind_grid_top = wind_grid_top
        # each lane's wind as K mode scores on a shared basis, for the
        # flights only (_compress_for_sim); the basis memo is keyed as the
        # JAX package keys it
        self.wind_table_modes = wind_table_modes
        self._wind_basis_memo = None  # (key, basis tensor)
        # a forecast (altitudes[N], wind[N,3]) each lane perturbs, or an
        # ensemble wind[K,N,3] (models.load_wind_ensemble_from_csvs) of which
        # each lane perturbs a uniformly drawn member
        self.base_altitude_profile = None
        self.base_wind_profile = None
        # the last run's lanes (and the compressed wind a single call flew),
        # and the last re-simulation (mc.resimulate)
        self._last_batch = None
        self._last_modes = None
        self._resim_memo = None

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

    def _compress_for_sim(self, scene_b, base_wind):
        """``scene_b`` with its per-lane tables mode-compressed
        (``models.wind.WindModes``) under ``wind_table_modes``, for the
        flights; a shared table, or no ``wind_table_modes``, passes. The
        basis is memoized on ``(K, grid, forecast)``."""
        k = self.wind_table_modes
        wind = scene_b.wind
        if not k or wind.wind.ndim != 3:
            return scene_b
        from ..models.wind import compress_wind, wind_mode_basis

        grid = wind.altitudes.detach().cpu().numpy()
        extra = None if base_wind is None else np.asarray(to_numpy(base_wind[1]))
        key = (int(k), grid.tobytes(), None if extra is None else extra.tobytes())
        if self._wind_basis_memo is None or self._wind_basis_memo[0] != key:
            basis = wind_mode_basis(self.scene.wind_model, grid, k, extra_profiles=extra)
            self._wind_basis_memo = (key, torch.as_tensor(basis, device=wind.wind.device))
        return dataclasses.replace(scene_b,
                                   wind=compress_wind(wind, self._wind_basis_memo[1]))

    def _base_wind(self):
        if self.base_wind_profile is not None and self.base_altitude_profile is not None:
            return (self.base_altitude_profile, self.base_wind_profile)
        return None

    def run_monte_carlo(self, initial_conditions, n_samples: int = 1000,
                        n_processes=None, optimized: bool = False, seed: int = 0,
                        materialize_results: Optional[int] = None,
                        chunk_steps: Optional[int] = None,
                        lane_slab: Optional[int] = None,
                        checkpoint_path: Optional[str] = None,
                        checkpoint_every: int = 16) -> dict:
        """Run ``n_samples`` dispersed flights and analyze them. Returns the
        reference-schema analysis dict plus a ``performance`` block and the
        ``landing_footprint``; the lanes are drawn under ``PRNGKey(seed)``
        (``random``), the JAX package's lanes for the same seed.

        Up to ``lane_slab`` lanes (default ``max_lanes_per_call``) fly in one
        call, and the analysis holds the per-lane ``summary``, ``sample``,
        ``valid_mask`` and ``reasons``. More lanes fly slab by slab
        (``_run_slabbed``): ``summary`` and ``sample`` are None, the per-lane
        headline metrics are in ``metrics``, and a ``convergence`` history
        is added. ``checkpoint_path``: a slabbed run writes its state there
        every ``checkpoint_every`` slabs and the same call resumes from it,
        bit for bit (``mc.slab_checkpoint``); the file goes when the run
        completes. ``chunk_steps``: the flights run in chunks of at most
        that many steps (``engine.simulate_batch_chunked``: the stacked
        engine's physics, one launch of the kernel's carry build a chunk on
        a card), not through ``simulate_summary_batch``."""
        del n_processes, optimized
        if chunk_steps is not None and self.wind_table_modes:
            # the chunks fly WindField tables only (the stacked engine):
            # dropping the compression asked for would misreport what ran
            raise ValueError("wind_table_modes applies to the component batch path; "
                             "it does not compose with chunk_steps")
        slab = lane_slab if lane_slab is not None else self.max_lanes_per_call
        if checkpoint_path is not None and checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        ic = self._as_ic(initial_conditions)
        base_wind = self._base_wind()
        self._last_batch = self._last_modes = self._resim_memo = None
        self._check_split(min(n_samples, slab))
        if n_samples > slab:
            return self._run_slabbed(ic, n_samples, slab, seed, materialize_results,
                                     base_wind, checkpoint_path, checkpoint_every,
                                     chunk_steps=chunk_steps)
        if checkpoint_path is not None:
            raise ValueError("checkpoint_path applies to slabbed runs (n_samples > "
                             "lane_slab); this run fits one device call")

        t_start = time.time()
        scene_b, ic_b, sample = _draw_single(self, ic, n_samples, seed, base_wind)
        scene_sim = self._compress_for_sim(scene_b, base_wind)
        summary = self._fly(scene_b, scene_sim, ic_b, n_samples, chunk_steps)
        valid, reasons = outlier_mask(summary, self.bounds)
        stats = {k: masked_stats(getattr(summary, k), valid) for k in _METRICS}
        cv_moments = None
        if self.control_variates:
            from .cv import cv_slab_moments

            cv_moments = cv_slab_moments(
                sample, summary, valid, torch.ones(n_samples, dtype=torch.bool,
                                                   device=valid.device),
                self.uncertainty_params, self.scene.motor,
                self._cv_wind_ctrl(scene_b, sample, base_wind))

        # one readback to the host (also the sync point)
        summary_np = to_numpy(summary)
        valid_np = valid.cpu().numpy()
        reasons_np = reasons.cpu().numpy()
        stats_py = {k: _stats_to_py(v) for k, v in stats.items()}
        for k in stats_py:
            stats_py[k]["percentile_ci"] = percentile_ci(getattr(summary_np, k), valid_np)
        elapsed = time.time() - t_start
        self._last_batch = (scene_b, ic_b)
        if scene_sim is not scene_b:
            self._last_modes = scene_sim.wind

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
                "cores_used": 1 if self.mesh is None else self.mesh.size,
            },
        }
        headline = {k: np.asarray(getattr(summary_np, k)) for k in _METRICS}
        ens_acc = EnsembleAccumulator.from_base_wind(base_wind)
        if ens_acc is not None:  # post-stratified forecast-ensemble stats
            ens_acc.add(sample_np.wind_member, valid_np, headline)
            analysis["ensemble"] = ens_acc.block()
            analysis["wind_members"] = np.asarray(sample_np.wind_member)
        if self.importance_shift:
            analysis["importance"] = self._importance_block(
                headline, valid_np, log_weights(sample_np, self.uncertainty_params,
                                                self.scene.motor, self.importance_shift))
        if cv_moments is not None:
            from .cv import CVMoments, finalize_cv

            acc = CVMoments()
            acc.add(cv_moments)
            analysis["control_variates"] = finalize_cv(acc, self._cv_names())
        if self.sampler == "sobol" and self.sobol_scrambles > 1:
            # each scramble's block of lanes is one randomized-QMC replicate
            size = n_samples // self.sobol_scrambles
            means = {k: [] for k in headline}
            for i in range(self.sobol_scrambles):
                part = slice(i * size, (i + 1) * size)
                ok = valid_np[part]
                for k, v in headline.items():
                    means[k].append(float(np.mean(v[part][ok])) if ok.any() else float("nan"))
            analysis["qmc_error"] = self._qmc_error(means)
        if self.two_level_lanes:
            analysis["two_level"] = self._two_level(ic, seed, base_wind, analysis)
        limit = 1000 if materialize_results is None else materialize_results
        analysis["results"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=True, limit=limit)
        analysis["outliers"] = self._materialize_records(
            summary_np, sample_np, valid_np, reasons_np, want_valid=False, limit=limit)
        return analysis

    def run_optimized_monte_carlo(self, initial_conditions, n_samples=1000,
                                  chunk_size=None, **kw) -> dict:
        """The reference's API name for ``run_monte_carlo``: the batched
        path is the optimized one, and ``chunk_size`` has no meaning here."""
        del chunk_size
        return self.run_monte_carlo(initial_conditions, n_samples, **kw)

    def run_to_precision(self, initial_conditions, *, criteria, max_samples: int,
                         min_samples: int = 0, seed: int = 0,
                         lane_slab: Optional[int] = None,
                         materialize_results: Optional[int] = None,
                         chunk_steps: Optional[int] = None) -> dict:
        """Run slabs until every criterion holds (``mc.sequential`` criteria
        or their spec dicts, checked after each slab), but never fewer than
        ``min_samples`` lanes, or until ``max_samples``. Stopping early is
        exact: the analysis is ``run_monte_carlo(n_samples=n_used)``'s with
        the same slab, bit for bit, plus a ``sequential`` block (each
        criterion's report, ``n_used``, ``stopped_early``, ``satisfied``).
        ``chunk_steps``: ``run_monte_carlo``'s, except that with
        ``wind_table_modes`` the chunks fly the uncompressed tables, as the
        JAX package's ``run_to_precision`` does."""
        from .sequential import parse_criterion

        if not criteria:
            raise ValueError("criteria must be a non-empty list")
        crits = [parse_criterion(c) for c in criteria]
        if self.sampler != "sobol" and any(getattr(c, "requires_sobol", False) for c in crits):
            raise ValueError(
                "qmc_mean_stderr criteria need sampler='sobol' (slab "
                "means are independent RQMC replicates only under the "
                "per-slab Owen scrambles); on prng draws use "
                "mean_stderr, which is valid AND tighter there")
        if self.importance_shift:
            raise ValueError(
                "run_to_precision counts unweighted lanes; "
                "importance-sampled runs need weighted estimators (and IS "
                "exists to make n small) — use run_monte_carlo")
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        if min_samples > max_samples:
            raise ValueError("min_samples must be <= max_samples")
        ic = self._as_ic(initial_conditions)
        slab = lane_slab if lane_slab is not None else self.max_lanes_per_call

        def stop_rule(slab_metrics, valid_np):
            for c in crits:
                c.update(slab_metrics[c.metric][valid_np])
            return all(c.satisfied() for c in crits)

        self._last_batch = self._last_modes = self._resim_memo = None
        self._check_split(slab)
        analysis = self._run_slabbed(ic, max_samples, slab, seed, materialize_results,
                                     self._base_wind(), stop_rule=stop_rule,
                                     min_samples=min_samples, chunk_steps=chunk_steps)
        n_used = int(analysis["n_total"])
        analysis["sequential"] = {
            "max_samples": int(max_samples), "min_samples": int(min_samples),
            "lane_slab": int(slab), "n_used": n_used,
            "stopped_early": n_used < max_samples,
            "satisfied": all(c.satisfied() for c in crits),
            "criteria": [c.block() for c in crits],
        }
        return analysis

    # ---------------------------------------------------------- slab loop
    def _run_slabbed(self, ic, n_samples, slab, seed, materialize_results, base_wind,
                     checkpoint_path=None, checkpoint_every=16, stop_rule=None,
                     min_samples=0, chunk_steps=None) -> dict:
        """The lane axis in slabs of ``slab`` lanes, one device call each;
        slab k draws under ``fold_in(PRNGKey(seed), k)``, and its statistics
        accumulate on the host through the registry of
        ``mc.slab_accumulators``: exactly (the same percentile rule and
        population std as one call) up to ``stats_stream_threshold`` lanes,
        past it as streams (exact moments, a quantile sketch, tail order
        statistics), with ``metrics``/``valid_mask``/``reasons`` then the
        first ``metrics_sample_cap`` lanes (``metrics_is_sample``).
        ``stop_rule(slab_metrics, valid_np)`` is ``run_to_precision``'s."""
        from .slab_accumulators import SlabContext, build_registry

        t_start = time.time()
        limit = 1000 if materialize_results is None else materialize_results
        streaming = n_samples > self.stats_stream_threshold
        if streaming and self.importance_shift:
            # the weighted estimators need every lane's (weight, metric) pair
            raise ValueError(
                "importance_shift runs need per-lane weights: keep "
                "n_samples <= stats_stream_threshold (IS makes small n "
                "sufficient; that is its purpose)")
        accs = build_registry(self, n_samples=n_samples, limit=limit, streaming=streaming,
                              base_wind=base_wind,
                              ens_acc=EnsembleAccumulator.from_base_wind(base_wind))
        by_key = {a.key: a for a in accs}
        n_done = n_valid_total = slab_idx = 0
        n_slabs = -(-n_samples // slab)
        ckpt_fp = None
        if checkpoint_path:
            from .slab_checkpoint import (load_slab_state, read_slab_state, run_fingerprint,
                                          save_slab_state)

            ckpt_fp = run_fingerprint(self, ic, n_samples, slab, seed, base_wind, limit,
                                      chunk_steps)
            # rank 0's file, read there and handed to every rank: the ranks
            # need share no filesystem, and all resume from one slab
            raw = read_slab_state(checkpoint_path) if self._writes_files else None
            if self.mesh is not None:
                from ..parallel.mesh import broadcast_object

                raw = broadcast_object(raw, self.mesh)
            st = load_slab_state(checkpoint_path, ckpt_fp, accs, raw)
            if st is not None:
                n_done, slab_idx = st["n_done"], st["slab_idx"]
                n_valid_total = st["n_valid_total"]
                log.info("resumed from %s: slab %d/%d (%d lanes done)", checkpoint_path,
                         slab_idx, n_slabs, n_done)
        while n_done < n_samples:
            n_s = min(slab, n_samples - n_done)
            scene_b, ic_b, sample = _draw_slab(self, ic, slab_idx, slab, seed, base_wind)
            # chunks fly the stacked engine, on the uncompressed tables
            scene_sim = (scene_b if chunk_steps is not None
                         else self._compress_for_sim(scene_b, base_wind))
            summary = self._fly(scene_b, scene_sim, ic_b, slab, chunk_steps)
            # lane ids are global: seed == simulation_id across slabs
            sample = dataclasses.replace(sample, random_seed=sample.random_seed + n_done)
            valid, reasons = outlier_mask(summary, self.bounds)
            # the padding lanes of a ragged last slab reach no output
            ranges_mask = valid if n_s == slab else valid & (
                torch.arange(slab, device=valid.device) < n_s)
            ctx = SlabContext(summary=summary, sample=sample, scene_b=scene_b, valid=valid,
                              reasons=reasons, ranges_mask=ranges_mask, n_s=n_s, slab=slab,
                              n_done=n_done)
            n_valid_total += int(ctx.valid_np.sum())
            ctx.n_valid_total = n_valid_total
            for acc in accs:
                acc.update(ctx)
            n_done += n_s
            slab_idx += 1
            log.info("slab %d/%d: %d/%d lanes", slab_idx, n_slabs, n_done, n_samples)
            if stop_rule is not None:
                # every slab folds into the criteria; stopping after slab k
                # is the run that asked for its lanes
                met = stop_rule(ctx.slab_metrics, ctx.valid_np)
                if met and min_samples <= n_done < n_samples:
                    log.info("sequential stop after slab %d (%d of %d lanes)", slab_idx,
                             n_done, n_samples)
                    n_samples = n_done
                    n_slabs = slab_idx
            if (ckpt_fp is not None and n_done < n_samples and slab_idx % checkpoint_every == 0
                    and self._writes_files):
                save_slab_state(checkpoint_path, {"n_done": n_done, "slab_idx": slab_idx,
                                                  "n_valid_total": n_valid_total},
                                accs, ckpt_fp)
        if ckpt_fp is not None and self._writes_files and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)
        elapsed = time.time() - t_start
        # the recipe that draws any slab again (mc.resimulate)
        self._last_batch = {"slabbed": True, "seed": seed, "slab": slab,
                            "n_samples": n_samples, "ic": ic, "base_wind": base_wind}

        if streaming:
            stats_blocks = by_key["stream"].stats_blocks()
        else:
            metrics_all, valid_all, _ = by_key["prefix"].concatenated()
            stats_blocks = {k: _host_stats(metrics_all[k], valid_all) for k in _METRICS}
        analysis = {
            "n_samples": n_valid_total,
            "n_failed": 0,
            "n_outliers": n_samples - n_valid_total,
            **stats_blocks,
            "summary": None,
            "streams": None,
            "tail_reservoirs": None,
            "n_total": n_samples,
            "sample": None,
            "initial_conditions": ic,
            "performance": {
                "total_time": elapsed,
                "simulations_per_second": n_samples / max(elapsed, 1e-9),
                "cores_used": 1 if self.mesh is None else self.mesh.size,
            },
        }
        for acc in accs:
            acc.finalize(analysis, self)
        if self.two_level_lanes:
            analysis["two_level"] = self._two_level(ic, seed, base_wind, analysis)
        return analysis

    @property
    def _writes_files(self) -> bool:
        """Whether this process writes the run's files: rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _check_split(self, lanes_per_call: int) -> None:
        """Raise when a call's lanes do not split evenly over the mesh."""
        if self.mesh is not None:
            from ..parallel.mesh import lane_block

            lane_block(lanes_per_call, self.mesh)

    def _fly(self, scene_b, scene_sim, ic_b, n: int, chunk_steps=None):
        """The summaries of a call's ``n`` lanes: one
        ``simulate_summary_batch`` without a mesh, or with ``chunk_steps``
        ``simulate_batch_chunked``; with a mesh, this rank's block of lanes
        (on the tables ``scene_sim`` flies: the compressed ones under
        ``wind_table_modes``) flown on its device and every rank's gathered
        in lane order."""
        if self.mesh is None:
            if chunk_steps is not None:
                return simulate_batch_chunked(scene_b, ic_b, self.sim_config,
                                              chunk_steps=chunk_steps)
            return simulate_summary_batch(scene_sim, ic_b, self.sim_config)
        from ..parallel.mesh import lane_block
        from ..parallel.sharded import run_sharded_summaries
        from .resimulate import _take

        block = lane_block(n, self.mesh)
        ids = torch.arange(block.start, block.stop)
        modes = scene_sim.wind if scene_sim is not scene_b else None
        return run_sharded_summaries(self._as_flown(scene_b, modes, ids), _take(ic_b, None, ids),
                                     None, self.sim_config, self.mesh, n,
                                     chunk_steps=chunk_steps)

    def _cv_wind_ctrl(self, scene_b, sample, base_wind):
        """The ``wind_ctrl`` dict of ``mc.cv``'s wind-table controls, None when
        ``cv_wind_modes`` and ``cv_wind_speed`` are both off. The ``[N, K]``
        projector (a host SVD) and the knots' exact speed means (Rice and
        quadrature) are memoized on the whole grid, and the means also on the
        forecast base."""
        if not (self.cv_wind_modes or self.cv_wind_speed):
            return None
        from .cv import wind_mode_projector, wind_speed_ctrl_leaves

        alt = scene_b.wind.altitudes
        alt_np = alt.detach().cpu().numpy().astype(np.float64)
        base_np = None if base_wind is None else np.asarray(to_numpy(base_wind[1]), np.float64)
        # a forecast grid can share its length and ends with another spacing
        grid_stale = (self._cv_proj is None or self._cv_proj[0].shape != alt_np.shape
                      or not np.array_equal(self._cv_proj[0], alt_np))
        if self.cv_wind_modes and grid_stale:
            self._cv_proj = (alt_np, torch.as_tensor(
                wind_mode_projector(self.scene.wind_model, alt_np, self.cv_wind_modes),
                dtype=alt.dtype, device=alt.device))
        ctrl = {"wind": scene_b.wind.wind, "ws": sample.wind_speed, "wd": sample.wind_direction,
                "proj": self._cv_proj[1] if self.cv_wind_modes else None, "alt": alt,
                "model": self.scene.wind_model,
                "base": None if base_wind is None else base_wind[1]}
        if self.cv_wind_speed:
            spd_stale = (self._cv_spd is None or self._cv_spd[0].shape != alt_np.shape
                         or not np.array_equal(self._cv_spd[0], alt_np)
                         or (self._cv_spd[1] is None) != (base_np is None)
                         or (base_np is not None and not np.array_equal(self._cv_spd[1], base_np)))
            if spd_stale:
                leaves, idx = wind_speed_ctrl_leaves(
                    self.uncertainty_params, self.scene.wind_model, alt_np, self.cv_wind_speed,
                    base=base_np, dtype=alt.dtype, device=alt.device)
                self._cv_spd = (alt_np, base_np, idx, leaves)
            ctrl.update(self._cv_spd[3])
        return ctrl

    def _cv_names(self) -> list:
        """The control names of the matrix built: the projector's column
        count (it clamps to the grid) and the knots kept."""
        from .cv import control_names

        k_eff = 0
        if self.cv_wind_modes and self._cv_proj is not None:
            k_eff = int(self._cv_proj[1].shape[1])
        spd_alts = ()
        if self.cv_wind_speed and self._cv_spd is not None:
            spd_alts = tuple(self._cv_spd[0][self._cv_spd[2]])
        return control_names(self.uncertainty_params, self.scene.motor, k_eff, spd_alts)

    def _two_level(self, ic, seed, base_wind, analysis) -> dict:
        """``analysis["two_level"]``: the fast flags' measured bias from a
        small coupled batch (``mc.two_level``) and the corrected headline
        means. The corrected stderr adds the main run's i.i.d. std/sqrt(n)
        and the bias's stderr in quadrature (the batch is decorrelated from
        every slab); under Sobol or antithetic lanes std/sqrt(n) is not the
        mean's error, so it is left out (None) with a ``stderr_note``."""
        from .two_level import METRICS, two_level_block

        block = two_level_block(self.scene, ic, self.sim_config, self.two_level_lanes, seed,
                                params=self.uncertainty_params, bounds=self.bounds,
                                base_wind=base_wind, wind_grid_points=self.wind_grid_points,
                                wind_grid_top=self.wind_grid_top,
                                # the fast leg flies compressed, as the run
                                # did, so the bias covers the truncation
                                fast_transform=(
                                    (lambda sb: self._compress_for_sim(sb, base_wind))
                                    if self.wind_table_modes else None))
        iid_main = self.sampler == "prng" and not self.antithetic
        if not iid_main:
            block["stderr_note"] = (
                "corrected_stderr omitted: the main run's lanes are not "
                f"i.i.d. (sampler={self.sampler!r}, "
                f"antithetic={self.antithetic}), so std/sqrt(n) is not its "
                "mean's sampling error — use qmc_error for sobol; the "
                "corrected_mean and bias/bias_stderr remain valid")
        n_main = max(int(analysis["n_samples"]), 1)
        for k in METRICS:
            st = analysis[k]
            block[k]["corrected_mean"] = float(st["mean"]) + block[k]["bias"]
            if iid_main:
                main_stderr = float(st["std"]) / np.sqrt(n_main)
                block[k]["corrected_stderr"] = float(np.hypot(main_stderr,
                                                              block[k]["bias_stderr"]))
            else:
                block[k]["corrected_stderr"] = None
        return block

    def _importance_block(self, values_by_name: dict, valid_np, lw) -> dict:
        """The ``analysis["importance"]`` block of both layouts: the shift,
        each lane's log weight, and each headline metric's weighted mean
        under the nominal distribution (the stats blocks describe the
        shifted population)."""
        imp = {"shift": dict(self.importance_shift), "log_weights": lw,
               "note": "self-normalized IS estimates under the nominal "
                       "distribution; use mc.importance.weighted_tail or "
                       "exceedance_from_analysis for tail probabilities"}
        for name, vals in values_by_name.items():
            imp[name] = weighted_mean(vals, valid_np, lw)
        return imp

    @staticmethod
    def _qmc_error(block_means: dict) -> dict:
        """Randomized-QMC error bars: ``block_means[metric]`` are the means of
        independently scrambled Sobol blocks (i.i.d. estimates of the
        target); stderr = std(blocks, ddof=1) / sqrt(K) over the finite
        ones."""
        out = {}
        for name, means in block_means.items():
            m = np.asarray([x for x in means if np.isfinite(x)], float)
            stderr = float(m.std(ddof=1) / np.sqrt(m.size)) if m.size > 1 else float("nan")
            out[name] = {"block_means": m.tolist(), "mean_stderr": stderr}
        return out

    @staticmethod
    def _footprint_moments(landing: torch.Tensor, mask: torch.Tensor) -> tuple:
        """One slab's centred landing moments, reduced on its device: ``(n,
        mean_x, mean_y, M2x, M2y, Cxy)`` about the slab's own mean (centred
        sums stay accurate in float32, where raw moments cancel), one
        readback."""
        x, y = landing[:, 0], landing[:, 1]
        m = mask & torch.isfinite(x) & torch.isfinite(y)
        n = torch.sum(m)
        nf = torch.clamp_min(n, 1).to(x.dtype)
        mx = torch.sum(torch.where(m, x, 0.0)) / nf
        my = torch.sum(torch.where(m, y, 0.0)) / nf
        dx = torch.where(m, x - mx, 0.0)
        dy = torch.where(m, y - my, 0.0)
        out = torch.stack([n.to(torch.float64)] + [v.to(torch.float64) for v in (
            mx, my, torch.sum(dx * dx), torch.sum(dy * dy), torch.sum(dx * dy))])
        n, *moments = out.cpu().tolist()
        return (int(n), *moments)

    @classmethod
    def _parameter_ranges_device(cls, sample, valid) -> dict:
        """Masked min and max of each dispersion parameter over the valid
        lanes, reduced on the sample's device in float64 (exact for every
        float leaf and for lane ids below 2**53): one readback per slab, not
        the whole sample."""
        cols = [torch.sum(valid).to(torch.float64).reshape(1)]
        for name in cls._RANGE_FIELDS:
            arr = getattr(sample, name).to(torch.float64)
            arr = arr.reshape(arr.shape[0], -1)
            cols += [torch.amin(torch.where(valid[:, None], arr, torch.inf), dim=0),
                     torch.amax(torch.where(valid[:, None], arr, -torch.inf), dim=0)]
        host = torch.cat(cols).cpu().numpy()
        if host[0] == 0:
            return {}
        out, pos = {}, 1
        for name in cls._RANGE_FIELDS:
            arr = getattr(sample, name)
            w = 1 if arr.ndim == 1 else arr.shape[1]
            mn, mx = host[pos:pos + w], host[pos + w:pos + 2 * w]
            pos += 2 * w
            if not arr.is_floating_point():
                mn, mx = mn.astype(np.int64), mx.astype(np.int64)
            if arr.ndim == 1:
                mn, mx = mn[0], mx[0]
            out[name] = {"min": mn.tolist(), "max": mx.tolist()}
        return out

    @staticmethod
    def _merge_ranges(a: dict, b: dict) -> dict:
        if not a:
            return b
        if not b:
            return a
        out = {}
        for name in a.keys() | b.keys():
            if name not in a:
                out[name] = b[name]
            elif name not in b:
                out[name] = a[name]
            else:
                out[name] = {"min": np.minimum(a[name]["min"], b[name]["min"]).tolist(),
                             "max": np.maximum(a[name]["max"], b[name]["max"]).tolist()}
        return out

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
                             want_valid: bool, limit: int, offset: int = 0) -> list:
        """Light per-lane records (the reference's per-result dicts without
        the trajectory histories). ``offset``: the global id of lane 0 (a
        slab's)."""
        idx = np.nonzero(valid_np if want_valid else ~valid_np)[0][:limit]
        records = []
        for i in idx:
            rec = {
                "simulation_id": int(i) + offset,
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
