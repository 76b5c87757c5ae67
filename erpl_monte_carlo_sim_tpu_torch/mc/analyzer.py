"""Monte Carlo orchestrator (``erpl_monte_carlo_sim_tpu/mc/analyzer.py``).

``run_monte_carlo`` samples dispersed lanes on the analyzer's device, flies
them through ``simulate_summary_batch`` (the CUDA kernel on a card, its
plain version on the CPU), filters outliers, reduces statistics and returns
the reference-schema analysis dict. A run that fits one device call
(``n_samples <= lane_slab``) is one call; a larger one runs slab by slab
(``_run_slabbed``), each slab drawn from its own generator seeded by
``slab_seed(seed, k)``, with the statistics accumulated on the host (exactly,
or as streams past ``stats_stream_threshold`` lanes), an optional mid-run
checkpoint, and ``run_to_precision``'s sequential stop. Options of the JAX
analyzer that the port does not have yet raise ``NotImplementedError``
naming the ROADMAP item that brings them.

Each run remembers its lanes (``_last_batch``: the single call's batch, or
a slabbed run's recipe), so that ``resimulate_trajectories``, ``lane_scenes``
and ``flight_envelope`` (``mc.resimulate``) can fly any of them again. Both
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
from ..engine.state import InitialConditions
from ..models.scene import Scene, nominal_scene
from ..utils.convert import to_numpy
from .dispersions import UncertaintyParams, sample_dispersions
from .filter import OutlierBounds, decode_reasons, outlier_mask
from .resimulate import ResimulationMixin
from .stats import PERCENTILES, landing_footprint, masked_stats, percentile_ci

__all__ = ["MonteCarloAnalyzer", "slab_seed"]

log = logging.getLogger(__name__)

_METRICS = ("apogee_altitude", "range", "flight_time")


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def slab_seed(seed: int, k: int) -> int:
    """The seed of slab ``k``'s generator in a run seeded ``seed``: a hash
    of the pair (``np.random.SeedSequence``), 63 bits, so that slab draws
    are independent of each other and of the single-call run's."""
    state = np.random.SeedSequence([seed % 2**64, k]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def _draw_single(analyzer, ic, n: int, seed: int, base_wind):
    """A single-call run's ``(scene_b, ic_b, sample)``: ``n`` lanes from a
    generator seeded ``seed``. The run's one draw; tests replace it to feed
    other lanes through the run."""
    gen = torch.Generator(device=analyzer.device)
    gen.manual_seed(seed)
    return sample_dispersions(gen, analyzer.scene, ic, analyzer.uncertainty_params, n,
                              base_wind=base_wind,
                              wind_grid_points=analyzer.wind_grid_points,
                              wind_grid_top=analyzer.wind_grid_top)


def _draw_slab(analyzer, ic, k: int, slab: int, seed: int, base_wind):
    """Slab ``k``'s ``(scene_b, ic_b, sample)``: always a full slab of lanes,
    so a lane's values depend only on ``(seed, k, slab)``. The slab loop's
    one draw; tests replace it to feed other lanes through the loop."""
    gen = torch.Generator(device=analyzer.device)
    gen.manual_seed(slab_seed(seed, k))
    return sample_dispersions(gen, analyzer.scene, ic, analyzer.uncertainty_params, slab,
                              base_wind=base_wind,
                              wind_grid_points=analyzer.wind_grid_points,
                              wind_grid_top=analyzer.wind_grid_top)


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


class MonteCarloAnalyzer(ResimulationMixin):
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
        if stats_stream_threshold < 1 or metrics_sample_cap < 1:
            raise ValueError("stats_stream_threshold and metrics_sample_cap must be >= 1")
        self.scene = scene
        self.uncertainty_params = uncertainty_params
        self.sim_config = sim_config
        self.bounds = bounds
        # a run of more lanes goes slab by slab; past stats_stream_threshold
        # lanes the statistics stream and only the first metrics_sample_cap
        # lanes' metrics are kept
        self.max_lanes_per_call = max_lanes_per_call
        self.stats_stream_threshold = stats_stream_threshold
        self.metrics_sample_cap = metrics_sample_cap
        self.wind_grid_points = wind_grid_points
        self.wind_grid_top = wind_grid_top
        # a single forecast (altitudes[N], wind[N,3]) each lane perturbs
        self.base_altitude_profile = None
        self.base_wind_profile = None
        # the last run's lanes, and the last re-simulation (mc.resimulate)
        self._last_batch = None
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
        ``landing_footprint``; ``seed`` seeds a ``torch.Generator`` on the
        analyzer's device.

        Up to ``lane_slab`` lanes (default ``max_lanes_per_call``) fly in one
        call, and the analysis holds the per-lane ``summary``, ``sample``,
        ``valid_mask`` and ``reasons``. More lanes fly slab by slab
        (``_run_slabbed``): ``summary`` and ``sample`` are None, the per-lane
        headline metrics are in ``metrics``, and a ``convergence`` history
        is added. ``checkpoint_path``: a slabbed run writes its state there
        every ``checkpoint_every`` slabs and the same call resumes from it,
        bit for bit (``mc.slab_checkpoint``); the file goes when the run
        completes."""
        del n_processes, optimized
        if chunk_steps is not None:
            _not_ported("chunk_steps", "'Left out of the port'")
        slab = lane_slab if lane_slab is not None else self.max_lanes_per_call
        if checkpoint_path is not None and checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        ic = self._as_ic(initial_conditions)
        base_wind = self._base_wind()
        self._last_batch = self._resim_memo = None
        if n_samples > slab:
            return self._run_slabbed(ic, n_samples, slab, seed, materialize_results,
                                     base_wind, checkpoint_path, checkpoint_every)
        if checkpoint_path is not None:
            raise ValueError("checkpoint_path applies to slabbed runs (n_samples > "
                             "lane_slab); this run fits one device call")

        t_start = time.time()
        scene_b, ic_b, sample = _draw_single(self, ic, n_samples, seed, base_wind)
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
        self._last_batch = (scene_b, ic_b)

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
        criterion's report, ``n_used``, ``stopped_early``, ``satisfied``)."""
        from .sequential import parse_criterion

        if chunk_steps is not None:
            _not_ported("chunk_steps", "'Left out of the port'")
        if not criteria:
            raise ValueError("criteria must be a non-empty list")
        crits = [parse_criterion(c) for c in criteria]
        if any(getattr(c, "requires_sobol", False) for c in crits):
            raise ValueError(
                "qmc_mean_stderr criteria need sampler='sobol' (slab "
                "means are independent RQMC replicates only under the "
                "per-slab Owen scrambles); on prng draws use "
                "mean_stderr, which is valid AND tighter there")
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

        self._last_batch = self._resim_memo = None
        analysis = self._run_slabbed(ic, max_samples, slab, seed, materialize_results,
                                     self._base_wind(), stop_rule=stop_rule,
                                     min_samples=min_samples)
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
                     min_samples=0) -> dict:
        """The lane axis in slabs of ``slab`` lanes, one device call each;
        slab k draws from ``slab_seed(seed, k)``, and its statistics
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
        accs = build_registry(self, n_samples=n_samples, limit=limit, streaming=streaming)
        by_key = {a.key: a for a in accs}
        n_done = n_valid_total = slab_idx = 0
        n_slabs = -(-n_samples // slab)
        ckpt_fp = None
        if checkpoint_path:
            from .slab_checkpoint import load_slab_state, run_fingerprint, save_slab_state

            ckpt_fp = run_fingerprint(self, ic, n_samples, slab, seed, base_wind, limit)
            st = load_slab_state(checkpoint_path, ckpt_fp, accs)
            if st is not None:
                n_done, slab_idx = st["n_done"], st["slab_idx"]
                n_valid_total = st["n_valid_total"]
                log.info("resumed from %s: slab %d/%d (%d lanes done)", checkpoint_path,
                         slab_idx, n_slabs, n_done)
        while n_done < n_samples:
            n_s = min(slab, n_samples - n_done)
            scene_b, ic_b, sample = _draw_slab(self, ic, slab_idx, slab, seed, base_wind)
            summary = simulate_summary_batch(scene_b, ic_b, self.sim_config)
            # lane ids are global: seed == simulation_id across slabs
            sample = dataclasses.replace(sample, random_seed=sample.random_seed + n_done)
            valid, reasons = outlier_mask(summary, self.bounds)
            # the padding lanes of a ragged last slab reach no output
            ranges_mask = valid if n_s == slab else valid & (
                torch.arange(slab, device=valid.device) < n_s)
            ctx = SlabContext(summary=summary, sample=sample, valid=valid, reasons=reasons,
                              ranges_mask=ranges_mask, n_s=n_s, slab=slab, n_done=n_done)
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
            if ckpt_fp is not None and n_done < n_samples and slab_idx % checkpoint_every == 0:
                save_slab_state(checkpoint_path, {"n_done": n_done, "slab_idx": slab_idx,
                                                  "n_valid_total": n_valid_total},
                                accs, ckpt_fp)
        if ckpt_fp is not None and os.path.exists(checkpoint_path):
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
                "cores_used": 1,
            },
        }
        for acc in accs:
            acc.finalize(analysis, self)
        return analysis

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
