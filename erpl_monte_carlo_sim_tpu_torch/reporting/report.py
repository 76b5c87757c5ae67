"""Monte Carlo report artifacts: JSON, TXT, per-simulation exports
(``erpl_monte_carlo_sim_tpu/reporting/report.py``).

The same ``monte_carlo_report.json`` keys and ``monte_carlo_report.txt``
layout as the JAX package, and per-simulation
``simulation_results/sim_<id>.json`` files with full time histories, made
again from the run's lanes (``MonteCarloAnalyzer.resimulate_trajectories``,
on a card the kernel's recording build) instead of being kept from the run.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np

from ..utils.serialize import object_to_serializable_dict, to_serializable

__all__ = ["create_output_directory", "save_report", "save_simulation_results"]


def create_output_directory(base: str = "outputs", prefix: str = "monte_carlo") -> str:
    """Timestamped ``outputs/monte_carlo_%Y%m%d_%H%M%S/`` dir
    (`monte_carlo.py:475-480`)."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    output_dir = os.path.join(base, f"{prefix}_{timestamp}")
    os.makedirs(output_dir, exist_ok=True)
    return output_dir


def save_report(analysis: dict, output_dir: str, analyzer=None) -> dict:
    """Write ``monte_carlo_report.json`` + ``monte_carlo_report.txt``.

    ``analyzer``: the MonteCarloAnalyzer, for scene/uncertainty metadata
    blocks (`monte_carlo.py:495-500`).
    """
    total = analysis["n_samples"]
    failed = analysis["n_failed"]
    outliers = analysis["n_outliers"]
    report = {
        "timestamp": datetime.now().isoformat(),
        "simulation_summary": {
            "total_simulations": total,
            "failed_simulations": failed,
            "outlier_simulations": outliers,
            "success_rate": total / max(total + failed + outliers, 1) * 100,
        },
        "apogee_altitude_stats": analysis["apogee_altitude"],
        "range_stats": analysis["range"],
        "flight_time_stats": analysis["flight_time"],
        "parameter_ranges_observed": analysis.get("parameter_ranges_observed"),
    }
    if analysis.get("landing_footprint", {}).get("n"):
        # beyond-reference block (additive; the reference schema is a
        # subset); an all-outlier run's n=0 NaN footprint is omitted
        report["landing_footprint"] = analysis["landing_footprint"]
    if analysis.get("control_variates"):
        # beyond-reference: variance-reduced means + delta-method stderr
        # (mc/cv.py); additive block, reference schema unaffected
        report["control_variates"] = analysis["control_variates"]
    if analysis.get("qmc_error"):
        report["qmc_error"] = analysis["qmc_error"]
    if analysis.get("two_level"):
        # beyond-reference: measured fast-flag integration bias + corrected
        # means from the coupled parity batch (mc/two_level.py)
        report["two_level"] = analysis["two_level"]
    if analysis.get("flight_envelope"):
        # beyond-reference: time-binned population bands from
        # MonteCarloAnalyzer.flight_envelope (mc/envelope.py) — callers
        # attach the block to the analysis dict before saving
        report["flight_envelope"] = analysis["flight_envelope"]
    if analysis.get("importance"):
        # weighted nominal-distribution estimates; per-lane log_weights
        # stay in the analysis dict (arrays don't belong in the report)
        imp = {k: v for k, v in analysis["importance"].items()
               if k != "log_weights"}
        report["importance"] = imp
    if analysis.get("ensemble"):
        # beyond-reference: per-forecast-member stats + post-stratified
        # mixture means (mc.ensemble) — the reference holds one forecast
        report["ensemble"] = analysis["ensemble"]
    if analysis.get("sequential"):
        # beyond-reference: run-to-precision stopping record
        # (MonteCarloAnalyzer.run_to_precision) — which criteria were met
        # and at what lane cost
        report["sequential"] = analysis["sequential"]
    if analyzer is not None:
        report["uncertainty_parameters"] = analyzer.uncertainty_params.as_dict()
        report["rocket_parameters"] = object_to_serializable_dict(analyzer.scene.rocket)
        report["motor_parameters"] = object_to_serializable_dict(analyzer.scene.motor)
        report["atmosphere_parameters"] = object_to_serializable_dict(
            analyzer.scene.atmosphere
        )
        report["wind_model_parameters"] = object_to_serializable_dict(
            analyzer.scene.wind_model
        )
    if "performance" in analysis:
        report["performance"] = analysis["performance"]

    with open(os.path.join(output_dir, "monte_carlo_report.json"), "w") as f:
        json.dump(to_serializable(report), f, indent=2)

    _write_txt_report(report, output_dir)
    return report


def _write_txt_report(report: dict, output_dir: str) -> None:
    """Human-readable report, line-for-line like `monte_carlo.py:519-560`."""
    def stats_block(f, title, stats, unit):
        f.write(f"{title} Statistics:\n")
        f.write(f"  Mean: {stats['mean']:.1f} {unit}\n")
        f.write(f"  Standard Deviation: {stats['std']:.1f} {unit}\n")
        f.write(f"  Min: {stats['min']:.1f} {unit}\n")
        f.write(f"  Max: {stats['max']:.1f} {unit}\n")
        f.write(
            f"  95% Confidence Interval: [{stats['percentiles'][0]:.1f}, "
            f"{stats['percentiles'][4]:.1f}] {unit}\n"
        )
        # beyond-reference, additive line: how well-determined the
        # percentile endpoints themselves are (order-statistic CIs,
        # mc.stats.percentile_ci) — the reference's percentiles carry no
        # sampling-error statement
        ci = stats.get("percentile_ci")
        if ci and np.isfinite(np.asarray(ci[0])).all():
            f.write(
                f"  Percentile sampling CIs (95%): "
                f"p5 [{ci[0][0]:.1f}, {ci[0][1]:.1f}], "
                f"p50 [{ci[2][0]:.1f}, {ci[2][1]:.1f}], "
                f"p95 [{ci[4][0]:.1f}, {ci[4][1]:.1f}] {unit}\n"
            )
        f.write("\n")

    with open(os.path.join(output_dir, "monte_carlo_report.txt"), "w") as f:
        f.write("Monte Carlo Analysis Report\n")
        f.write("=" * 50 + "\n\n")
        f.write(f"Generated: {report['timestamp']}\n\n")
        s = report["simulation_summary"]
        f.write("Simulation Summary:\n")
        f.write(f"  Valid simulations: {s['total_simulations']}\n")
        f.write(f"  Failed simulations: {s['failed_simulations']}\n")
        f.write(f"  Outlier simulations: {s['outlier_simulations']}\n")
        f.write(f"  Success rate: {s['success_rate']:.1f}%\n\n")
        stats_block(f, "Apogee Altitude", report["apogee_altitude_stats"], "m")
        stats_block(f, "Range", report["range_stats"], "m")
        stats_block(f, "Flight Time", report["flight_time_stats"], "s")
        if "landing_footprint" in report:
            fp = report["landing_footprint"]
            f.write("Landing Dispersion Footprint:\n")
            f.write(f"  Mean impact point: ({fp['mean_m'][0]:.1f}, "
                    f"{fp['mean_m'][1]:.1f}) m\n")
            e95 = fp["ellipse95"]
            f.write(f"  95% ellipse: {e95['semi_major_m']:.1f} x "
                    f"{e95['semi_minor_m']:.1f} m at "
                    f"{fp['orientation_deg']:.1f} deg\n")
            f.write(f"  CEP: {fp['cep_m']:.1f} m ({fp['cep_method']})\n\n")
        if "ensemble" in report:
            ens = report["ensemble"]
            f.write(f"Forecast Ensemble ({ens['n_members']} members):\n")
            for row in ens["members"]:
                apo = row["apogee_altitude"]
                rng_ = row["range"]
                f.write(
                    f"  member {row['member']}: n={row['n_valid']}/"
                    f"{row['n_drawn']} valid, apogee "
                    f"{apo['mean']:.1f} +- {apo['std']:.1f} m, range "
                    f"{rng_['mean']:.1f} +- {rng_['std']:.1f} m\n"
                )
            ps = ens["post_stratified"]
            f.write(
                "  Post-stratified means: apogee "
                f"{ps['apogee_altitude']['mean']:.2f} +- "
                f"{ps['apogee_altitude']['stderr']:.3f} m, range "
                f"{ps['range']['mean']:.2f} +- "
                f"{ps['range']['stderr']:.3f} m, flight time "
                f"{ps['flight_time']['mean']:.2f} +- "
                f"{ps['flight_time']['stderr']:.3f} s\n\n"
            )
        if "control_variates" in report:
            cv = report["control_variates"]
            f.write("Control-Variate Adjusted Means:\n")
            for name, unit in (("apogee_altitude", "m"), ("range", "m"),
                               ("flight_time", "s")):
                blk = cv.get(name)
                if blk:
                    f.write(
                        f"  {name}: {blk['mean']:.2f} +- "
                        f"{blk['stderr']:.3f} {unit} "
                        f"(variance reduction {blk['variance_reduction']:.1f}x)\n"
                    )
            f.write("\n")
        if "two_level" in report:
            tl = report["two_level"]
            f.write("Two-Level Bias Correction "
                    f"({tl['n_coupled']} coupled parity lanes):\n")
            for name, unit in (("apogee_altitude", "m"), ("range", "m"),
                               ("flight_time", "s")):
                blk = tl.get(name)
                if blk:
                    se = blk.get("corrected_stderr")
                    # None under non-i.i.d. main runs (antithetic/sobol) —
                    # see MonteCarloAnalyzer._two_level
                    se_txt = (f"+- {se:.3f} {unit}" if se is not None
                              else f"{unit} (stderr n/a: non-i.i.d. sampler)")
                    f.write(
                        f"  {name}: bias {blk['bias']:+.3f} +- "
                        f"{blk['bias_stderr']:.3f} {unit}; corrected mean "
                        f"{blk['corrected_mean']:.2f} {se_txt}\n"
                    )
            f.write("\n")
        if "flight_envelope" in report:
            env = report["flight_envelope"]
            f.write(f"Flight Envelope ({env['n_lanes']} lanes, "
                    f"{env['bin_dt']:g} s bins):\n")
            for ch, blk in env["channels"].items():
                peaks = [x for x in blk["max"] if x == x]  # drop NaN bins
                p95s = [x for x in blk["percentiles"].get("95", ())
                        if x == x]
                if peaks and p95s:
                    f.write(f"  {ch}: population max {max(peaks):.2f}, "
                            f"p95 peak {max(p95s):.2f}\n")
            f.write("\n")
        if "importance" in report:
            imp = report["importance"]
            f.write("Importance-Sampled Nominal Estimates "
                    f"(shift {imp['shift']}):\n")
            for name, unit in (("apogee_altitude", "m"), ("range", "m"),
                               ("flight_time", "s")):
                blk = imp.get(name)
                if blk:
                    f.write(f"  {name}: {blk['mean']:.2f} +- "
                            f"{blk['stderr']:.3f} {unit} "
                            f"(n_eff {blk['n_eff']:.0f})\n")
            f.write("\n")
        if "sequential" in report:
            seq = report["sequential"]
            f.write("Sequential Stopping (run-to-precision):\n")
            f.write(f"  Lanes used: {seq['n_used']} of "
                    f"{seq['max_samples']} budgeted "
                    f"({'stopped early' if seq['stopped_early'] else 'budget exhausted'})\n")
            for c in seq["criteria"]:
                if c["kind"] in ("mean_stderr", "qmc_mean_stderr"):
                    tag = (" (RQMC, %d replicates)" % c["n_replicates"]
                           if c["kind"] == "qmc_mean_stderr" else "")
                    f.write(f"  {c['metric']} mean stderr{tag}: "
                            f"{c['stderr']:.4g} (target {c['target']:.4g})"
                            f" -> {'met' if c['satisfied'] else 'NOT met'}\n")
                elif c["kind"] == "quantile_halfwidth":
                    lo, hi = c["ci95"]
                    f.write(f"  {c['metric']} p{c['percentile']:g}: "
                            f"{c['estimate']:.4g} CI95 [{lo:.4g}, {hi:.4g}]"
                            f" half-width {c['halfwidth']:.4g} "
                            f"(target {c['target']:.4g}) -> "
                            f"{'met' if c['satisfied'] else 'NOT met'}\n")
                else:
                    lo, hi = c["ci95"]
                    f.write(f"  P({c['metric']} > {c['threshold']:g}): "
                            f"{c['probability']:.4g} "
                            f"CI95 [{lo:.4g}, {hi:.4g}]"
                            + (f" vs limit {c['p_limit']:g} -> "
                               f"{c['decision'] or 'undecided'}"
                               if c["kind"] == "exceedance_decision"
                               else f" (half-width target "
                                    f"{c['target']:.4g})")
                            + "\n")
            f.write("\n")
        if "performance" in report:
            perf = report["performance"]
            f.write("Performance Statistics:\n")
            f.write(f"  Total time: {perf['total_time']:.2f} s\n")
            f.write(
                f"  Simulations per second: {perf['simulations_per_second']:.1f}\n"
            )
            f.write(f"  Cores used: {perf['cores_used']}\n")


def save_simulation_results(analyzer, analysis: dict, output_dir: str,
                            max_sims: int = 50) -> int:
    """Per-simulation ``simulation_results/sim_<id>.json`` exports for the
    first ``max_sims`` valid lanes of ``analysis["results"]``.

    The lanes fly again, recorded, under the run's ``SimConfig``
    (``resimulate_trajectories``; its one-slot memo then serves the
    trajectory clouds of the same lanes), so each export's summary values
    are the run's bit for bit. ``lane_scenes`` handles both run layouts
    (single call and slabbed). The recordings become NumPy once, for all
    lanes.

    A float32 run's histories are float32 flights: a float32 full flight
    follows its float64 flight within the float32 bars for a median 956 of
    about 5,000 frames (PERF.md, Findings), after which its history is
    one float32 flight among the ones its rounding allows. Fly the run in
    float64 where the histories themselves are the product.
    """
    from ..utils.convert import to_numpy
    from .results import to_results_dict

    sims_dir = os.path.join(output_dir, "simulation_results")
    os.makedirs(sims_dir, exist_ok=True)
    ids = [r["simulation_id"] for r in analysis["results"][:max_sims]]
    if not ids:
        return 0
    summary, traj = analyzer.resimulate_trajectories(ids)
    summary, traj = to_numpy(summary), to_numpy(traj)
    scenes = analyzer.lane_scenes(ids)
    for k, sim_id in enumerate(ids):
        results = to_results_dict(scenes[k], summary, traj, analyzer.sim_config,
                                  initial_conditions=None, lane=k)
        results["simulation_id"] = sim_id
        results["parameters"] = analysis["results"][k]["parameters"]
        # json.dumps' C encoder writes the bytes json.dump would, faster
        with open(os.path.join(sims_dir, f"sim_{sim_id}.json"), "w") as sf:
            sf.write(json.dumps(to_serializable(results)))
    return len(ids)
