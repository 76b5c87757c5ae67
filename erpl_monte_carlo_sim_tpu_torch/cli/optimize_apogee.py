"""Gradient-based optimization of a flight metric over a scene parameter
(``erpl_monte_carlo_sim_tpu/cli/optimize_apogee.py``).

Line-search gradient ascent (``engine.diff.line_search_ascent``) on any
dotted scene field, each evaluation one forward and reverse pass through
the differentiable flight; ``--robust`` ascends the dispersed objective
instead, the mean over N Monte Carlo lanes less ``--lam`` times their std
(``mc.optimize_robust``). Runs on the card unless ``--device cpu`` asks for
the CPU.

Usage:
  python -m erpl_monte_carlo_sim_tpu_torch.cli.optimize_apogee \\
      [param] [steps] [lr] [--bounds LO HI] [--robust [N_LANES]] [--lam X] \\
      [--max-time T] [--metric m] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..engine import InitialConditions, SimConfig
from ..engine.diff import _scene_accessors, line_search_ascent, metric_and_grad
from ..models import liquid_motor, nominal_scene

__all__ = ["optimize", "main"]


def optimize(param: str = "rocket.fin_span", steps: int = 24, lr: float = None,
             cfg: SimConfig = None, verbose: bool = True, metric: str = "apogee_altitude",
             bounds: tuple | None = None, device="cuda"):
    """Gradient-ascend ``metric`` with respect to ``param`` on the nominal
    flight (``steps`` evaluations at most). Returns the ``(value, metric,
    grad)`` history (an ``AscentHistory``; ``hist.info`` holds the converged
    point)."""
    cfg = cfg or SimConfig(max_time=120.0)
    scene = nominal_scene(liquid_motor(device))
    ic = InitialConditions.vertical_launch(device)
    read, write = _scene_accessors(param)
    dtype = read(scene).dtype
    k = 0

    def evaluate(value):
        nonlocal k
        m, grad = metric_and_grad(write(scene, torch.tensor(value, dtype=dtype, device=device)),
                                  ic, cfg, metric=metric, wrt=param)
        m, grad = float(m), float(grad)
        if verbose:
            print(f"eval {k}: {param}={value:.6g}  {metric}={m:.1f}  "
                  f"d({metric})/d({param})={grad:.3g}")
        k += 1
        return (value, m, grad), m, grad

    hist = line_search_ascent(evaluate, float(read(scene)), steps, lr, bounds=bounds)
    if verbose and hist:
        print(f"{hist.info['reason']}: {param}={hist.info['value']:.6g} "
              f"{metric}={hist.info['objective']:.1f} (converged={hist.info['converged']}, "
              f"{hist.info['n_evals']} evals)")
    return hist


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description="Gradient ascent on a flight metric over a dotted scene parameter "
                    "(nominal flight, or --robust for the dispersed mean - lam*std objective)")
    ap.add_argument("param", nargs="?", default="rocket.fin_span")
    ap.add_argument("steps", nargs="?", type=int, default=24,
                    help="evaluation budget for the line search")
    ap.add_argument("lr", nargs="?", type=float, default=None,
                    help="initial step magnitude (default 2%% of start value; the line "
                         "search adapts it)")
    ap.add_argument("--bounds", nargs=2, type=float, default=None, metavar=("LO", "HI"),
                    help="clamp the parameter to [LO, HI]")
    ap.add_argument("--robust", nargs="?", type=int, const=256, default=0, metavar="N_LANES",
                    help="optimize the dispersed objective over N lanes")
    ap.add_argument("--lam", type=float, default=0.0,
                    help="risk aversion: objective = mean - lam*std")
    ap.add_argument("--max-time", type=float, default=120.0)
    ap.add_argument("--metric", default="apogee_altitude")
    ap.add_argument("--device", default="cuda",
                    help="where the flights run (default cuda; cpu for a host without a card)")
    args = ap.parse_args(argv)
    bounds = tuple(args.bounds) if args.bounds else None
    if args.robust:
        from ..mc.robust import optimize_robust

        return optimize_robust(
            nominal_scene(liquid_motor(args.device)),
            InitialConditions.vertical_launch(args.device), SimConfig(max_time=args.max_time),
            wrt=args.param, metric=args.metric, n_lanes=args.robust, risk_lambda=args.lam,
            steps=args.steps, lr=args.lr, bounds=bounds, verbose=True)
    return optimize(args.param, args.steps, args.lr, cfg=SimConfig(max_time=args.max_time),
                    metric=args.metric, bounds=bounds, device=args.device)


if __name__ == "__main__":
    main()
