"""Design optimization under dispersion (``erpl_monte_carlo_sim_tpu/mc/robust.py``).

Gradient ascent of a design parameter against the dispersed population's
statistics,

    objective(v) = mean_lanes[metric(v)] - risk_lambda * std_lanes[metric(v)],

its value and gradient from one reverse pass through the differentiable
flight (``engine.diff.simulate_metrics_diff``) of the whole dispersed batch.
This is sample-average approximation: the lanes are drawn once under
``PRNGKey(seed)`` (``_draw_lanes``, the one draw: the JAX package's lanes)
and stay fixed across evaluations, so the objective is
a deterministic function of ``v`` and plain line-search ascent converges.

The design parameter must be a shared scene leaf (fin or parachute
geometry, rail length, ...): a dispersed leaf (``motor.thrust_scale`` after
sampling) is refused, since one scalar would overwrite the draws. A lane
that diverges poisons the reverse pass even where the primal mean masks it
(a zero cotangent times a NaN is NaN), so every lane must be finite or the
objective raises.
"""

from __future__ import annotations

import torch

from ..engine.diff import (DIFF_METRICS, _scene_accessors, gradients, line_search_ascent,
                           simulate_metrics_diff)
from .. import random
from .dispersions import UncertaintyParams, sample_dispersions

__all__ = ["dispersed_objective_and_grad", "optimize_robust"]


def _draw_lanes(scene, ic, n_lanes: int, seed: int, params: UncertaintyParams, base_wind):
    """The SAA lanes ``(scene_b, ic_b)``: ``n_lanes`` prng lanes on the
    scene's device under ``PRNGKey(seed)``."""
    scene_b, ic_b, _ = sample_dispersions(random.prng_key(seed), scene, ic, params, n_lanes,
                                          base_wind=base_wind)
    return scene_b, ic_b


def dispersed_objective_and_grad(scene, ic, cfg, *, wrt: str, metric: str = "apogee_altitude",
                                 n_lanes: int = 256, seed: int = 0,
                                 params: UncertaintyParams = UncertaintyParams(),
                                 risk_lambda: float = 0.0, base_wind: tuple | None = None,
                                 value=None, n_steps: int | None = None) -> tuple:
    """``(objective, d objective / d scene.<wrt>, diagnostics)`` at ``value``
    (None: the scene's own), over ``n_lanes`` dispersed lanes: ``objective =
    mean(metric) - risk_lambda * std(metric)`` (population std; not formed
    when ``risk_lambda`` is 0, and then reported as 0). Diagnostics are
    ``{"mean", "std", "value"}`` floats."""
    if metric not in DIFF_METRICS:
        raise ValueError(f"metric must be one of {DIFF_METRICS}, got {metric!r}")
    read, write = _scene_accessors(wrt)
    scene_b, ic_b = _draw_lanes(scene, ic, n_lanes, seed, params, base_wind)
    nominal_leaf = read(scene)
    if read(scene_b).ndim != nominal_leaf.ndim:
        raise ValueError(
            f"scene.{wrt} is a DISPERSED (per-lane) leaf in the sampled batch; a scalar "
            "design write would overwrite the draws. Optimize a shared design leaf instead "
            "(fin/parachute geometry, rail length, dry structural dimensions)")
    v0 = torch.as_tensor(value if value is not None else nominal_leaf.detach(),
                         dtype=nominal_leaf.dtype, device=nominal_leaf.device)
    v = v0.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        # write() refreshes the derived geometry in tensors, so a geometry
        # gradient carries the stability-margin channel too
        m = simulate_metrics_diff(write(scene_b, v), ic_b, cfg, n_steps=n_steps)[metric]
        mean = torch.mean(m)
        if risk_lambda == 0.0:
            obj, std = mean, torch.zeros_like(mean)
        else:
            std = torch.sqrt(torch.mean((m - mean) ** 2))
            obj = mean - risk_lambda * std
        (grad,) = gradients(obj, [v])
    if not bool(torch.isfinite(obj)) or not bool(torch.isfinite(grad).all()):
        raise FloatingPointError(
            "non-finite dispersed objective/gradient: a lane diverged (reverse passes "
            "cannot mask NaN lanes). Use a windowed config or "
            "SimConfig(energy_consistent_aero=True) for full flights")
    diag = {"mean": float(mean.detach()), "std": float(std.detach()), "value": float(v0)}
    return obj.detach(), grad, diag


def optimize_robust(scene, ic, cfg, *, wrt: str, metric: str = "apogee_altitude",
                    n_lanes: int = 256, seed: int = 0,
                    params: UncertaintyParams = UncertaintyParams(), risk_lambda: float = 0.0,
                    base_wind: tuple | None = None, steps: int = 24, lr: float | None = None,
                    bounds: tuple | None = None, verbose: bool = False) -> list:
    """Gradient-ascend the dispersed objective with respect to
    ``scene.<wrt>`` by ``engine.diff.line_search_ascent`` (``steps`` is the
    evaluation budget). The ``seed`` lanes stay fixed for the whole ascent.
    Returns the history ``[(value, objective, grad, mean, std), ...]``, one
    entry per evaluation, rejected trials included (an ``AscentHistory``:
    ``hist.info`` holds the converged point)."""
    read, _ = _scene_accessors(wrt)

    def evaluate(value):
        obj, grad, diag = dispersed_objective_and_grad(
            scene, ic, cfg, wrt=wrt, metric=metric, n_lanes=n_lanes, seed=seed, params=params,
            risk_lambda=risk_lambda, base_wind=base_wind, value=value)
        obj, grad = float(obj), float(grad)
        if verbose:
            print(f"  {wrt}={value:.6g}  objective={obj:.4f}  mean={diag['mean']:.4f}  "
                  f"std={diag['std']:.4f}  grad={grad:.4g}", flush=True)
        return (value, obj, grad, diag["mean"], diag["std"]), obj, grad

    return line_search_ascent(evaluate, float(read(scene)), steps, lr, bounds=bounds)
