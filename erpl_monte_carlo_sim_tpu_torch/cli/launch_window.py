"""Launch-window range-safety sweep: go/no-go over forecast wind candidates
(``erpl_monte_carlo_sim_tpu/cli/launch_window.py``).

The forecast is bracketed as a (ground wind speed) x (direction) candidate
grid. Each candidate runs one Monte Carlo with the mean wind held at that
candidate's power-law profile and the AR(1) turbulence dispersing around it
(the forecast-perturbation mode), and is judged against explicit
range-safety limits: exceedance probabilities with Wilson CIs, the landing
footprint's CEP, and a go/no-go verdict.

Candidates share the seed (common random numbers), so candidate
DIFFERENCES are far better resolved than each candidate's absolute level,
the right trade for a go/no-go boundary. Runs on the card unless
``--device cpu`` asks for the CPU. Prints one JSON object.

Usage:
  python -m erpl_monte_carlo_sim_tpu_torch.cli.launch_window \\
      --speeds 2,5,8,11 --directions 0,90,180,270 \\
      --range-limit 3000 [--apogee-ceiling 30000] [--p-limit 0.01] \\
      [--n 2048] [--seed 0] [--solid] [--max-time 0] [--plot DIR] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..engine import InitialConditions, SimConfig
from ..mc import MonteCarloAnalyzer, exceedance_from_analysis
from ..mc.dispersions import UncertaintyParams
from ..mc.stats import PERCENTILES
from ..models import liquid_motor, nominal_scene, solid_motor
from ..models.wind import power_law_profile
from ..utils.tree import tree_map

__all__ = ["launch_window_sweep", "main"]


def _candidate_profile(scene, speed: float, direction_deg: float,
                       grid_points: int, grid_top: float):
    """Power-law mean wind profile blowing TOWARD ``direction_deg``
    (measured from +x, counterclockwise), on the analyzer's wind grid,
    computed on the host in float64."""
    alts = np.linspace(0.0, grid_top, grid_points)
    wind_model = tree_map(lambda t: t.detach().cpu().double(), scene.wind_model)
    mag = power_law_profile(wind_model, torch.as_tensor(np.maximum(alts, 1e-3)),
                            speed).numpy()
    rad = np.deg2rad(direction_deg)
    prof = np.stack(
        [mag * np.cos(rad), mag * np.sin(rad), np.zeros_like(mag)], axis=1
    )
    return alts, prof


def launch_window_sweep(
    speeds,
    directions_deg,
    n: int = 2048,
    seed: int = 0,
    solid: bool = False,
    max_time: float = 0.0,
    range_limit: float | None = None,
    apogee_ceiling: float | None = None,
    p_limit: float = 0.01,
    scene=None,
    sim_config=None,
    uncertainty_params=None,
    wind_grid_points: int = 100,
    wind_grid_top: float = 25000.0,
    adaptive_max_n: int | None = None,
    device="cuda",
) -> dict:
    """One MC per (speed, direction) candidate; returns the sweep table.

    A candidate is GO when every configured limit holds with margin: the
    Wilson 95% UPPER bound of each exceedance probability is <= ``p_limit``
    (the conservative side of the CI, so "go" is robust to the sampling
    noise of ``n`` lanes). With no limits configured, ``go`` is None and
    the sweep is purely descriptive.

    The candidate's mean wind is HELD: the default dispersions here zero
    the uniform (speed, direction) mean-wind offset that
    ``UncertaintyParams`` otherwise adds on top of a forecast profile
    (`monte_carlo.py:265-288`) — each candidate must answer "what if the
    forecast IS this profile", with only AR(1) turbulence and the
    vehicle/IC channels dispersing around it. Pass ``uncertainty_params``
    explicitly to model forecast uncertainty instead.

    ``adaptive_max_n``: sequential sweep — each candidate runs ``n``-lane
    slabs until its go/no-go is DECIDED (the Wilson 95% interval for every
    configured exceedance lies entirely on one side of ``p_limit``;
    ``mc.sequential.ExceedanceDecision``) or ``adaptive_max_n`` lanes are
    spent. Candidates far from the boundary decide after one slab; only
    boundary cases use the budget. Requires at least one limit. Rows gain
    ``n_used`` and ``decided``.

    ``device``: where the runs fly (a given ``scene``'s device wins).
    """
    if scene is None:
        scene = nominal_scene(solid_motor(device) if solid else liquid_motor(device))
    if uncertainty_params is None:
        uncertainty_params = UncertaintyParams(
            wind_speed_range=(0.0, 0.0), wind_direction_range=(0.0, 0.0)
        )
    if adaptive_max_n is not None:
        if range_limit is None and apogee_ceiling is None:
            raise ValueError(
                "adaptive_max_n needs at least one limit (range_limit / "
                "apogee_ceiling) to decide against"
            )
        if adaptive_max_n < n:
            raise ValueError("adaptive_max_n must be >= n (the slab size)")
    if sim_config is None:
        sim_config = SimConfig(max_time=max_time) if max_time > 0 \
            else SimConfig()
    device = scene.rocket.dry_mass.device
    ic = InitialConditions.vertical_launch(device, scene.rocket.dry_mass.dtype)
    candidates = []
    for speed in speeds:
        for direction in directions_deg:
            mc = MonteCarloAnalyzer(
                scene=scene, sim_config=sim_config,
                uncertainty_params=uncertainty_params,
                wind_grid_points=wind_grid_points,
                wind_grid_top=wind_grid_top,
            )
            alts, prof = _candidate_profile(
                scene, float(speed), float(direction),
                wind_grid_points, wind_grid_top,
            )
            mc.base_altitude_profile = alts
            mc.base_wind_profile = prof
            if adaptive_max_n is not None:
                crit = []
                if range_limit is not None:
                    crit.append({"metric": "range", "exceed": range_limit,
                                 "p_limit": p_limit})
                if apogee_ceiling is not None:
                    crit.append({"metric": "apogee_altitude",
                                 "exceed": apogee_ceiling,
                                 "p_limit": p_limit})
                a = mc.run_to_precision(
                    ic, criteria=crit, max_samples=adaptive_max_n,
                    min_samples=n, lane_slab=n, seed=seed,
                )
            else:
                a = mc.run_monte_carlo(ic, n_samples=n, seed=seed)
            row = {
                "wind_speed": float(speed),
                "wind_direction_deg": float(direction),
                "n_valid": int(a["n_samples"]),
                "n_outliers": int(a["n_outliers"]),
                "apogee_altitude": {k: a["apogee_altitude"][k]
                                    for k in ("mean", "std")},
                "range": {k: a["range"][k] for k in ("mean", "std")},
                "range_p95": a["range"]["percentiles"][
                    PERCENTILES.index(95.0)
                ],
                "landing_footprint": {
                    "mean_m": a["landing_footprint"]["mean_m"],
                    "cep_m": a["landing_footprint"]["cep_m"],
                },
            }
            checks = []
            if range_limit is not None:
                ex = exceedance_from_analysis(a, "range", [range_limit])[0]
                row["p_range_exceed"] = ex
                checks.append(ex["ci95"][1] <= p_limit)
            if apogee_ceiling is not None:
                ex = exceedance_from_analysis(
                    a, "apogee_altitude", [apogee_ceiling]
                )[0]
                row["p_apogee_exceed"] = ex
                checks.append(ex["ci95"][1] <= p_limit)
            row["go"] = bool(all(checks)) if checks else None
            if adaptive_max_n is not None:
                seq = a["sequential"]
                row["n_used"] = seq["n_used"]
                row["decided"] = seq["satisfied"]
            candidates.append(row)
    return {
        "n_per_candidate": n,
        "adaptive_max_n": adaptive_max_n,
        "seed": seed,
        "common_random_numbers": True,
        "limits": {
            "range_limit": range_limit,
            "apogee_ceiling": apogee_ceiling,
            "p_limit": p_limit,
            "rule": "go iff Wilson-95 upper bound of every exceedance "
                    "probability <= p_limit",
        },
        "speeds": [float(s) for s in speeds],
        "directions_deg": [float(d) for d in directions_deg],
        "candidates": candidates,
        "go_count": sum(1 for r in candidates if r["go"]),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Launch-window range-safety sweep over forecast winds"
    )
    ap.add_argument("--speeds", default="2,5,8",
                    help="comma-separated ground wind speeds (m/s at 10 m)")
    ap.add_argument("--directions", default="0,90,180,270",
                    help="comma-separated wind directions (deg from +x)")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solid", action="store_true")
    ap.add_argument("--max-time", type=float, default=0.0)
    ap.add_argument("--range-limit", type=float, default=None)
    ap.add_argument("--apogee-ceiling", type=float, default=None)
    ap.add_argument("--p-limit", type=float, default=0.01)
    ap.add_argument("--adaptive-max-n", type=int, default=None,
                    metavar="N_MAX",
                    help="sequential mode: run --n-lane slabs per "
                    "candidate until its go/no-go is decided or N_MAX "
                    "lanes are spent")
    ap.add_argument("--plot", default=None, metavar="DIR",
                    help="also write launch_window.png into DIR")
    ap.add_argument("--device", default="cuda",
                    help="where the runs fly: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sweep = launch_window_sweep(
        [float(x) for x in args.speeds.split(",")],
        [float(x) for x in args.directions.split(",")],
        n=args.n, seed=args.seed, solid=args.solid, max_time=args.max_time,
        range_limit=args.range_limit, apogee_ceiling=args.apogee_ceiling,
        p_limit=args.p_limit, adaptive_max_n=args.adaptive_max_n,
        device=args.device,
    )
    if args.plot:
        from ..reporting.plots import plot_launch_window

        sweep["plot"] = plot_launch_window(sweep, args.plot)
    print(json.dumps(sweep, indent=2))
    return sweep


if __name__ == "__main__":
    main()
