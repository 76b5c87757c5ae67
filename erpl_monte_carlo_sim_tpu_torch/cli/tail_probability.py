"""Range-safety tail probability: P(metric > threshold)
(``erpl_monte_carlo_sim_tpu/cli/tail_probability.py``).

Plain Monte Carlo with its Wilson 95% interval; importance sampling
(``--shift channel=sigmas``: tilted draws weighted back to the nominal
distribution, ``mc.importance``); a GPD fit of the sample's extreme tail
extrapolated past counting reach (``--gpd``, ``mc.tail``); or subset
simulation (``--subset``, ``mc.subset``), down to about 1e-9 with neither a
tilt nor a tail model, whose ``--p-target P`` mode returns the bound held
at probability P instead (``--threshold`` then omitted) and ``--n-runs K``
pools K seeds into a between-seed interval. Runs on the card unless
``--device cpu`` asks for the CPU. Prints one JSON object.

Usage:
  python -m erpl_monte_carlo_sim_tpu_torch.cli.tail_probability \\
      --metric apogee_altitude --threshold 26000 \\
      [--n 4096] [--seed 0] [--solid] [--max-time 0] \\
      [--shift motor_thrust=2.0] [--shift mass=1.0] \\
      [--gpd] [--n-tail 1000] \\
      [--subset [--n-per-level 2048] [--p0 0.125] [--max-levels 15] \\
                [--n-runs 4] [--p-target 1e-6]] [--device cuda]

``--max-time 0`` (the default) flies full flights. ``--auto-shift`` picks the
tilt from one reverse pass through the differentiable flight
(``mc.importance.auto_shift``, ``--shift-frac`` of the design point).
"""

from __future__ import annotations

import argparse
import json

from ..engine import InitialConditions, SimConfig
from ..mc import MonteCarloAnalyzer, exceedance_from_analysis
from ..models import liquid_motor, nominal_scene, solid_motor

__all__ = ["tail_probability", "main"]


def tail_probability(metric: str, threshold: float, n: int = 4096, seed: int = 0,
                     solid: bool = False, max_time: float = 0.0,
                     shift: dict | str | None = None, gpd: bool = False, n_tail: int = 1000,
                     scene=None, sim_config=None, shift_frac: float = 0.75,
                     subset: bool = False, n_per_level: int = 2048, p0: float = 0.125,
                     max_levels: int = 15, n_runs: int = 1, p_target: float = 0.0,
                     device="cuda") -> dict:
    """P(metric > threshold | valid) with the run's metadata, on ``device``
    (a given ``scene``'s device wins). ``shift`` selects importance sampling
    (``"auto"`` picks it by ``mc.importance.auto_shift``), ``gpd`` the GPD extrapolation
    (exclusive with ``shift``: the fit needs the nominal population),
    ``subset`` subset simulation (exclusive with both); ``p_target`` with
    ``subset`` solves for the bound instead."""
    if gpd and shift:
        raise ValueError("--gpd and --shift are exclusive (the GPD fit "
                         "needs the nominal population)")
    if subset and (gpd or shift):
        raise ValueError("--subset is its own estimator; drop --gpd/--shift")
    if scene is None:
        scene = nominal_scene(solid_motor(device) if solid else liquid_motor(device))
    if sim_config is None:
        sim_config = SimConfig(max_time=max_time) if max_time > 0 else SimConfig()
    if p_target and not subset:
        raise ValueError("--p-target needs --subset (quantile mode is "
                         "subset simulation's inverse problem)")
    if threshold is None and not (subset and p_target):
        raise ValueError("--threshold is required (omit it only in "
                         "--subset --p-target quantile mode)")
    if subset and p_target and threshold is not None:
        raise ValueError("--threshold and --p-target are exclusive: "
                         "quantile mode SOLVES for the threshold held at "
                         "p_target — a supplied --threshold would be "
                         "silently ignored")
    ic = InitialConditions.vertical_launch(scene.rocket.dry_mass.device,
                                           scene.rocket.dry_mass.dtype)
    if subset and p_target:
        mc = MonteCarloAnalyzer(scene=scene, sim_config=sim_config)
        res = mc.subset_quantile(ic, metric, p_target, n_per_level=n_per_level, p0=p0,
                                 seed=seed, n_runs=n_runs)
        out = {"metric": metric, "p_target": p_target, "threshold": res["threshold"],
               "ci95_threshold": res["ci95_threshold"], "method": "subset_quantile",
               "n_sims": res["n_sims"]}
        if n_runs == 1:
            out.update(cov=res["cov"], n_levels=res["n_levels"], stalled=res["stalled"])
        else:
            out.update(n_runs=res["n_runs"], threshold_sd=res["threshold_sd"],
                       stalled_runs=res["stalled_runs"])
        return out
    if subset:
        mc = MonteCarloAnalyzer(scene=scene, sim_config=sim_config)
        res = mc.subset_tail(ic, metric, threshold, n_per_level=n_per_level, p0=p0, seed=seed,
                             max_levels=max_levels, n_runs=n_runs)
        out = {"metric": metric, "threshold": threshold,
               "probability": res["probability_given_valid"],
               "probability_joint": res["probability"],
               "ci95": [c / res["valid_fraction"] if res["valid_fraction"] else float("nan")
                        for c in res["ci95"]],
               "cov": res["cov"], "method": "subset", "n_sims": res["n_sims"]}
        if n_runs == 1:
            out.update(n_levels=res["n_levels"], stalled=res["stalled"], levels=res["levels"])
        else:
            # pooled seeds: the between-seed interval and its calibration
            out.update(n_runs=res["n_runs"], n_zero_runs=res["n_zero_runs"],
                       stalled_runs=res["stalled_runs"],
                       cov_reported_mean=res["cov_reported_mean"],
                       spread_ratio=res["spread_ratio"])
        return out
    auto_info = None
    if shift == "auto":
        from ..mc.importance import auto_shift

        shift, auto_info = auto_shift(scene, ic, sim_config, metric, threshold, frac=shift_frac)
        if not shift:
            raise ValueError(
                "auto tilt found no channel worth shifting (every |theta| < 0.05; "
                f"diagnostics: {auto_info}) — the threshold is too close to nominal for "
                "tilting to help")
    mc = MonteCarloAnalyzer(scene=scene, sim_config=sim_config, importance_shift=shift or None)
    a = mc.run_monte_carlo(ic, n_samples=n, seed=seed)
    if gpd:
        from ..mc.tail import tail_from_analysis

        blk = tail_from_analysis(a, metric, [threshold], n_tail=n_tail)
        row = {**blk["exceedance"][0], "fit": blk["fit"]}
    else:
        row = exceedance_from_analysis(a, metric, [threshold])[0]
    out = {"metric": metric, "n_lanes": n, "n_valid": a["n_samples"],
           "shift": dict(shift or {}), **row}
    if auto_info is not None:
        out["auto_shift"] = auto_info
    if shift:
        blk = a["importance"].get(metric)
        if isinstance(blk, dict) and "n_eff" in blk:
            out["n_eff"] = blk["n_eff"]  # the self-normalized denominator's health
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metric", default="apogee_altitude")
    p.add_argument("--threshold", type=float, default=None,
                   help="metric threshold (required except in --subset --p-target quantile "
                        "mode)")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solid", action="store_true")
    p.add_argument("--max-time", type=float, default=0.0)
    p.add_argument("--shift", action="append", default=[], metavar="CHANNEL=SIGMAS",
                   help="importance tilt, repeatable (e.g. motor_thrust=2)")
    p.add_argument("--auto-shift", action="store_true",
                   help="pick the tilt automatically (one reverse pass through the "
                        "differentiable flight)")
    p.add_argument("--shift-frac", type=float, default=0.75,
                   help="fraction of the design point to tilt to (with --auto-shift)")
    p.add_argument("--gpd", action="store_true",
                   help="GPD tail extrapolation instead of counting")
    p.add_argument("--n-tail", type=int, default=1000, help="exceedances used by the --gpd fit")
    p.add_argument("--subset", action="store_true",
                   help="subset simulation (adaptive multilevel splitting) — deep tails "
                        "without a tilt or a tail model")
    p.add_argument("--n-per-level", type=int, default=2048,
                   help="lanes per subset level (with --subset)")
    p.add_argument("--p0", type=float, default=0.125,
                   help="subset level survival fraction (with --subset)")
    p.add_argument("--max-levels", type=int, default=15)
    p.add_argument("--n-runs", type=int, default=1,
                   help="pooled subset replicates (with --subset): between-seed 95%% CI "
                        "instead of the per-run level-independence approximation")
    p.add_argument("--p-target", type=float, default=0.0,
                   help="quantile mode (with --subset): report the metric bound held at "
                        "this probability instead of the probability at a bound")
    p.add_argument("--device", default="cuda",
                   help="where the flights run (default cuda; cpu for a host without a card)")
    args = p.parse_args(argv)
    shift = {}
    for s in args.shift:
        name, _, val = s.partition("=")
        shift[name] = float(val)
    if args.auto_shift:
        if shift:
            p.error("--auto-shift and --shift are exclusive")
        shift = "auto"
    out = tail_probability(args.metric, args.threshold, n=args.n, seed=args.seed,
                           solid=args.solid, max_time=args.max_time, shift=shift, gpd=args.gpd,
                           n_tail=args.n_tail, shift_frac=args.shift_frac, subset=args.subset,
                           n_per_level=args.n_per_level, p0=args.p0,
                           max_levels=args.max_levels, n_runs=args.n_runs,
                           p_target=args.p_target, device=args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
