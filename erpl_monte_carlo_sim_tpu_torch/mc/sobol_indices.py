"""Variance-based sensitivity: Sobol' indices of the dispersed flight
(``erpl_monte_carlo_sim_tpu/mc/sobol_indices.py``).

Which dispersion channel drives the spread? First-order indices S_i give
the variance share of channel group i alone, total-order indices T_i with
every interaction it takes part in; T_i far above S_i marks a channel
whose effect is mostly interaction, where linear tools (control variates,
gradients) stop working.

Saltelli pick-freeze with Jansen's estimators: two independent draw
matrices A and B, and per group a matrix AB_i equal to A but for group i's
columns, taken from B; ``S_i = mean(f_B (f_ABi - f_A)) / V`` and ``T_i =
mean((f_A - f_ABi)^2) / (2 V)``. Each matrix is one batched flight call of
``n`` lanes (one K1 launch on a card): ``k + 2`` calls, plus one per
requested subset (``pairs``), whose closed index less its parts' gives the
pure interaction share (inclusion-exclusion for larger subsets).

The groups mirror ``mc.dispersions``: the 19 scalar channels by meaning,
and ``wind_turbulence``, the per-lane AR(1) driver as one group. The draws
are assembled by the production ``_build_scene``, the turbulence given as
its explicit driver (``noise``; the JAX package passes it through an
identity basis, which is the same numbers). Zero-sigma groups and the
solid motor's flow multiplier are skipped, not reported as zero.

Lanes are paired across matrices, so a row is kept only when it is valid
in every matrix (``n_valid``). The draws are the JAX package's: matrix
``m`` (0: A, 1: B) under ``fold_in(PRNGKey(seed), m)``, group ``i`` of it
under ``fold_in(., i)`` (``_draw_matrix``, a seam of the tests), and a
forecast ensemble's members under ``_build_scene``'s turbulence key
``PRNGKey(0)``, the same in every matrix. The bootstrap resamples rows
jointly with ``np.random.default_rng(seed)``'s indices in the JAX
package's order, so its intervals can be compared.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..engine.batch import simulate_summary_batch
from .. import random
from .dispersions import UncertaintyParams, _build_scene
from .filter import OutlierBounds, outlier_mask

__all__ = ["sobol_indices", "jansen_estimates", "active_groups", "select_interaction_pairs",
           "pure_interactions"]

_SCALAR_GROUPS = (
    # (group, channel key, kind, dims): "normal" draws z * sigma, "mult"
    # 1 + z * sigma, "uniform" lo + (hi - lo) u
    ("position", "pos_off", "normal", 3),
    ("velocity", "vel_off", "normal", 3),
    ("attitude", "att_off", "normal", 3),
    ("angular_velocity", "omg_off", "normal", 3),
    ("mass", "mass_mult", "mult", 1),
    ("motor_thrust", "motor_thrust_mult", "mult", 1),
    ("motor_flow", "motor_flow_mult", "mult", 1),
    ("wind_speed", "wind_speed", "uniform", 1),
    ("wind_direction", "wind_dir", "uniform", 1),
    ("density", "density_mult", "mult", 1),
)
METRICS = ("apogee_altitude", "range", "flight_time")


def _group_sigmas(scene, params: UncertaintyParams) -> dict:
    return {
        "position": params.initial_position,
        "velocity": params.initial_velocity,
        "attitude": params.initial_attitude,
        "angular_velocity": params.initial_angular_velocity,
        "mass": params.mass_uncertainty,
        "motor_thrust": float(scene.motor.thrust_uncertainty),
        "motor_flow": float(scene.motor.mass_flow_uncertainty),
        "wind_speed": params.wind_speed_range[1] - params.wind_speed_range[0],
        "wind_direction": params.wind_direction_range[1] - params.wind_direction_range[0],
        "density": params.atmospheric_density_uncertainty,
    }


def active_groups(scene, params: UncertaintyParams = UncertaintyParams(),
                  turbulence: bool = True) -> list:
    """The groups that can move the output for this scene and these
    params (zero-sigma groups and the solid motor's inert flow multiplier
    left out)."""
    sig = _group_sigmas(scene, params)
    out = []
    for g, _, _, _ in _SCALAR_GROUPS:
        if not np.any(np.asarray(sig[g], np.float64) != 0.0):
            continue
        if g == "motor_flow" and bool(scene.motor.mdot_follows_thrust):
            continue
        out.append(g)
    if turbulence and float(scene.wind_model.turbulence_intensity) > 0.0:
        out.append("wind_turbulence")
    return out


def _draw_matrix(seed: int, matrix: int, n: int, knots: int, dtype, device) -> dict:
    """Matrix ``matrix``'s (0: A, 1: B) standardized draws under
    ``fold_in(PRNGKey(seed), matrix)``: ``z ~ N(0, 1)`` for the Gaussian
    groups, ``u ~ U(0, 1)`` for the uniform ones, the ``[n, knots, 3]``
    AR(1) driver; group ``i`` under ``fold_in(., i)`` (the turbulence is
    group 10). The estimator's one draw; tests can replace it to feed other
    draws."""
    key = random.fold_in(random.prng_key(seed, device), matrix)
    d = {}
    for i, (g, _, kind, dims) in enumerate(_SCALAR_GROUPS):
        shape = (n, dims) if dims > 1 else (n,)
        draw = random.uniform if kind == "uniform" else random.normal
        d[g] = draw(random.fold_in(key, i), shape, dtype)
    d["wind_turbulence"] = random.normal(random.fold_in(key, len(_SCALAR_GROUPS)),
                                       (n, knots, 3), dtype)
    return d


def _assemble(scene, ic, params, draws, grid, base_wind, dtype):
    """Standardized draws to batched ``(Scene, InitialConditions)`` through
    the production ``_build_scene``, whose turbulence key ``PRNGKey(0)``
    draws a forecast ensemble's members (the JAX package's fixed key)."""
    sig = _group_sigmas(scene, params)
    device = grid.device
    n = draws["mass"].shape[0]
    ch = {}
    for g, ch_key, kind, _ in _SCALAR_GROUPS:
        z = torch.as_tensor(draws[g], dtype=dtype, device=device)
        if kind == "normal":
            ch[ch_key] = z * torch.as_tensor(sig[g], dtype=dtype, device=device)
        elif kind == "mult":
            ch[ch_key] = 1.0 + z * torch.as_tensor(sig[g], dtype=dtype, device=device)
        else:
            lo, hi = {"wind_speed": params.wind_speed_range,
                      "wind_direction": params.wind_direction_range}[g]
            ch[ch_key] = lo + (hi - lo) * z
    # the recorded-but-unused thrust multiplier never acts: its slot at its mean
    ch["thrust_mult_recorded"] = torch.ones(n, dtype=dtype, device=device)
    ch["noise"] = torch.as_tensor(draws["wind_turbulence"], dtype=dtype, device=device)
    scene_b, ic_b, _ = _build_scene(scene, ic, ch, base_wind, grid,
                                    random.prng_key(0, device))
    return scene_b, ic_b


def select_interaction_pairs(gaps: dict, threshold: float = 0.1, max_groups: int = 4) -> list:
    """``pairs="auto"``'s rule: the groups whose total-minus-first-order gap
    reaches ``threshold``, the ``max_groups`` largest, all their 2-subsets in
    ``gaps``' key order."""
    order = list(gaps)
    cand = [g for g in order if gaps[g] >= threshold]
    cand = sorted(cand, key=lambda g: -gaps[g])[:max_groups]
    cand.sort(key=order.index)
    return [(g1, g2) for i, g1 in enumerate(cand) for g2 in cand[i + 1:]]


def pure_interactions(est: dict, subsets: list) -> dict:
    """Each subset's pure interaction share from ``jansen_estimates``: its
    closed index less every smaller effect inside it (inclusion-exclusion in
    size order; every sub-subset of a subset of more than 2 groups must be
    among ``subsets``)."""
    pure = {}
    for p in sorted(subsets, key=len):
        val = est["groups"][p]["S"] - sum(est["groups"][g]["S"] for g in p)
        for q, qv in pure.items():
            if set(q) < set(p):
                val -= qv
        pure[p] = val
    return pure


def jansen_estimates(f_a, f_b, f_abs: dict) -> dict:
    """Jansen's first- and total-order indices per group from masked metric
    vectors, with the pooled mean and variance they share."""
    f_a = np.asarray(f_a, np.float64)
    f_b = np.asarray(f_b, np.float64)
    pooled = np.concatenate([f_a, f_b])
    mean = pooled.mean()
    var = pooled.var()
    out = {"mean": float(mean), "variance": float(var), "groups": {}}
    if var <= 0.0:
        for g in f_abs:
            out["groups"][g] = {"S": 0.0, "T": 0.0}
        return out
    a, b = f_a - mean, f_b - mean
    for g, f_ab in f_abs.items():
        ab = np.asarray(f_ab, np.float64) - mean
        out["groups"][g] = {"S": float(np.mean(b * (ab - a)) / var),
                            "T": float(np.mean((a - ab) ** 2) / (2.0 * var))}
    return out


def _check_pairs(pairs, groups) -> list:
    pairs = [tuple(p) for p in (pairs or [])]
    for p in pairs:
        if len(p) < 2 or len(set(p)) != len(p) or not set(p) <= set(groups):
            raise ValueError(f"pair {p} must name >= 2 DISTINCT analyzed groups "
                             f"(analyzed: {sorted(groups)})")
    sets = [frozenset(p) for p in pairs]
    if len(set(sets)) != len(sets):
        raise ValueError("duplicate pair/subset requested")
    for p in pairs:
        if len(p) > 2:
            missing = [q for k in range(2, len(p)) for q in itertools.combinations(p, k)
                       if frozenset(q) not in sets]
            if missing:
                raise ValueError(f"subset {p} needs its sub-subsets {missing} requested too "
                                 "(inclusion-exclusion)")
    return pairs


def sobol_indices(scene, ic, sim_config, *, params: UncertaintyParams = UncertaintyParams(),
                  n: int = 2048, seed: int = 0, metrics: tuple = METRICS,
                  groups: list | None = None, base_wind: tuple | None = None,
                  wind_grid_points: int = 100, wind_grid_top: float = 25000.0,
                  bounds: OutlierBounds = OutlierBounds(), n_boot: int = 500,
                  pairs: list | str | None = None) -> dict:
    """The Sobol' decomposition of the dispersed flight metrics on the
    scene's device. Returns per metric ``{"mean", "variance", "first_order":
    {group: {"S", "ci95"}}, "total_order": {group: {"T", "ci95"}},
    ["second_order": {"g1*g2": {"closed", "interaction", "ci95"}}],
    "sum_first_order"}``, plus ``groups``, ``pairs``, ``n``, ``n_valid``
    (rows valid in every matrix) and ``n_sims``. ``groups=None`` takes
    every active group; ``pairs="auto"`` picks the 2-subsets of the (at
    most 4) groups whose interaction gap reaches 0.1 from the first-order
    matrices. Bootstrap 95% intervals over ``n_boot`` joint row resamples
    (``second_order``'s on the pure interaction)."""
    if groups is None:
        groups = active_groups(scene, params)
    else:
        known = set(active_groups(scene, params))
        bad = [g for g in groups if g not in known]
        if bad:
            raise ValueError(f"unknown or inert groups {bad}; active groups for this "
                             f"scene are {sorted(known)}")
    if not groups:
        raise ValueError("no active dispersion channels to analyze")
    auto_pairs = pairs == "auto"
    if not auto_pairs:
        pairs = _check_pairs(pairs, groups)
    dtype, device = scene.rocket.dry_mass.dtype, scene.rocket.dry_mass.device
    if base_wind is not None:
        grid = torch.as_tensor(base_wind[0], dtype=dtype, device=device)
        base_wind = (grid, torch.as_tensor(base_wind[1], dtype=dtype, device=device))
    else:
        grid = torch.linspace(0.0, wind_grid_top, wind_grid_points, dtype=dtype, device=device)

    draws_a = _draw_matrix(seed, 0, n, grid.shape[0], dtype, device)
    draws_b = _draw_matrix(seed, 1, n, grid.shape[0], dtype, device)

    def run(draws):
        scene_b, ic_b = _assemble(scene, ic, params, draws, grid, base_wind, dtype)
        summary = simulate_summary_batch(scene_b, ic_b, sim_config)
        valid, _ = outlier_mask(summary, bounds)
        vals = {m: getattr(summary, m).cpu().numpy().astype(np.float64) for m in metrics}
        return vals, valid.cpu().numpy()

    f_a, valid = run(draws_a)
    f_b, v = run(draws_b)
    valid = valid & v
    f_ab = {}
    for g in groups:
        f_ab[g], v = run({**draws_a, g: draws_b[g]})
        valid &= v
    if auto_pairs:
        # each group's interaction budget from the matrices run so far
        if int(valid.sum()) < 16:
            raise ValueError(f"only {int(valid.sum())} of {n} lanes are jointly valid "
                             "before pair selection; raise n or loosen the bounds")
        gaps = {}
        for g in groups:
            gap = 0.0
            for m in metrics:
                e = jansen_estimates(f_a[m][valid], f_b[m][valid],
                                     {g: f_ab[g][m][valid]})["groups"][g]
                gap = max(gap, e["T"] - e["S"])
            gaps[g] = gap
        pairs = select_interaction_pairs(gaps)
    f_ab2 = {}
    for p in pairs:
        f_ab2[p], v = run({**draws_a, **{g: draws_b[g] for g in p}})
        valid &= v
    n_valid = int(valid.sum())
    if n_valid < 16:
        raise ValueError(f"only {n_valid} of {n} lanes are jointly valid across all "
                         "matrices; raise n or loosen the outlier bounds")

    rng = np.random.default_rng(seed)
    boot_idx = rng.integers(0, n_valid, (n_boot, n_valid)) if n_boot > 0 else None
    out = {"n": int(n), "n_valid": n_valid, "n_sims": int(n * (2 + len(groups) + len(pairs))),
           "groups": list(groups), "pairs": ["*".join(p) for p in pairs]}
    for m in metrics:
        fa, fb = f_a[m][valid], f_b[m][valid]
        fabs = {g: f_ab[g][m][valid] for g in groups}
        fabs.update({p: f_ab2[p][m][valid] for p in pairs})
        est = jansen_estimates(fa, fb, fabs)
        block = {"mean": est["mean"], "variance": est["variance"],
                 "first_order": {}, "total_order": {}}
        keys = list(groups) + pairs
        ci = {k: {"S": [None, None], "T": [None, None]} for k in keys}
        if n_boot > 0:
            reps = {k: {"S": np.empty(n_boot), "T": np.empty(n_boot)} for k in keys}
            for r in range(n_boot):
                i = boot_idx[r]
                e = jansen_estimates(fa[i], fb[i], {k: fabs[k][i] for k in keys})
                for g in groups:
                    reps[g]["S"][r] = e["groups"][g]["S"]
                    reps[g]["T"][r] = e["groups"][g]["T"]
                pr = pure_interactions(e, pairs)
                for p in pairs:
                    reps[p]["S"][r] = pr[p]  # the interaction share, not the closed index
            for k in keys:
                for which in (("S", "T") if k in groups else ("S",)):
                    lo, hi = np.percentile(reps[k][which], [2.5, 97.5])
                    ci[k][which] = [float(lo), float(hi)]
        for g in groups:
            block["first_order"][g] = {"S": est["groups"][g]["S"], "ci95": ci[g]["S"]}
            block["total_order"][g] = {"T": est["groups"][g]["T"], "ci95": ci[g]["T"]}
        if pairs:
            pure = pure_interactions(est, pairs)
            block["second_order"] = {"*".join(p): {"closed": est["groups"][p]["S"],
                                                   "interaction": pure[p],
                                                   "ci95": ci[p]["S"]} for p in pairs}
        block["sum_first_order"] = float(sum(est["groups"][g]["S"] for g in groups))
        out[m] = block
    return out
