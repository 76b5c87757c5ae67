"""Two-level (coupled) bias correction for runs under fast flags
(``erpl_monte_carlo_sim_tpu/mc/two_level.py``).

The fast flags (``descent_dt_scale``, ``ascent_q_threshold``,
``wind_eval_per_step``, ``wind_table_bf16``, ``integrator="rk2"``) trade a
small deterministic integration bias for less step work. At large n the
mean's sampling stderr falls below that bias, and the identity

    E[f_parity] = E[f_fast] + E[f_parity - f_fast]

repairs it: the full run under the fast flags, plus a small batch of
coupled lanes (the same draws) flown under both configurations, whose
difference varies far less than the population, so a few thousand lanes
pin the bias.

The correction batch draws plain prng lanes (an honest i.i.d. stderr)
under ``fold_in(PRNGKey(seed), CORRECTION_SLAB)``, the JAX package's key: a
fold far from the run's small slab indices, so the batch is decorrelated
from every slab and from the single call. Its draw goes through one seam,
``_draw_correction``. Both legs fly through ``simulate_summary_batch`` (K1
on a card, one build per configuration).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..engine.batch import simulate_summary_batch
from .. import random
from .dispersions import UncertaintyParams, sample_dispersions
from .filter import OutlierBounds, outlier_mask

__all__ = ["FAST_FIELDS", "METRICS", "CORRECTION_SLAB", "parity_twin", "two_level_block"]

# SimConfig fields that change the integrated physics for speed; the other
# opt-ins are physics choices (energy_consistent_aero) or act only on lanes
# the filter drops (terminate_nonfinite, speed_guard)
FAST_FIELDS = ("descent_dt_scale", "ascent_q_threshold", "wind_eval_per_step",
               "wind_table_bf16", "integrator")

METRICS = ("apogee_altitude", "range", "flight_time")

# what the correction batch folds into the run's key (the JAX package's
# ``_KEY_SALT``)
CORRECTION_SLAB = 0x2B1A5C0


def parity_twin(cfg):
    """``cfg`` with every fast flag at its exact-parity default."""
    defaults = type(cfg)()
    return dataclasses.replace(cfg, **{f: getattr(defaults, f) for f in FAST_FIELDS})


def _draw_correction(scene, ic, params, n: int, seed: int, base_wind, wind_grid_points: int,
                     wind_grid_top: float):
    """The correction batch's ``(scene_b, ic_b, sample)``: ``n`` prng lanes
    on the scene's device under ``fold_in(PRNGKey(seed), CORRECTION_SLAB)``.
    The batch's one draw; tests can replace it to feed other lanes."""
    key = random.fold_in(random.prng_key(seed), CORRECTION_SLAB)
    return sample_dispersions(key, scene, ic, params, n, base_wind=base_wind,
                              wind_grid_points=wind_grid_points, wind_grid_top=wind_grid_top)


def two_level_block(scene, ic, cfg, n: int, seed: int = 0, *,
                    params: UncertaintyParams = UncertaintyParams(),
                    bounds: OutlierBounds = OutlierBounds(), base_wind=None,
                    wind_grid_points: int = 100, wind_grid_top: float = 25000.0,
                    fast_transform=None) -> dict:
    """Fly ``n`` coupled lanes under ``cfg`` and its parity twin and estimate
    the per-metric bias ``E[f_parity - f_fast]`` over the lanes valid in
    both legs: ``bias``, ``bias_stderr``, ``abs_max_delta`` and the parity
    leg's ``population_sigma``, with the coupling counts and each leg's wall
    (the card synchronized by the readback). The analyzer adds the corrected
    means. ``fast_transform`` is a ``scene_b -> scene_b`` hook of the fast
    leg alone (the analyzer's mode compression under ``wind_table_modes``,
    so that the bias covers the truncation); the parity leg flies the
    realized tables."""
    twin = parity_twin(cfg)
    if twin == cfg and fast_transform is None:
        raise ValueError("two-level correction needs at least one fast flag set "
                         f"(one of {FAST_FIELDS}) or a fast_transform; the config is "
                         "already exact parity")
    t0 = time.time()
    scene_b, ic_b, _ = _draw_correction(scene, ic, params, n, seed, base_wind,
                                        wind_grid_points, wind_grid_top)
    runs, leg_wall = {}, {}
    for label, c in (("fast", cfg), ("parity", twin)):
        t1 = time.time()
        leg_scene = scene_b
        if label == "fast" and fast_transform is not None:
            leg_scene = fast_transform(scene_b)
        s = simulate_summary_batch(leg_scene, ic_b, c)
        m, _ = outlier_mask(s, bounds)
        runs[label] = ({k: getattr(s, k).cpu().numpy() for k in METRICS}, m.cpu().numpy())
        leg_wall[label] = round(time.time() - t1, 3)
    both = runs["fast"][1] & runs["parity"][1]
    n_coupled = int(both.sum())
    block = {
        "n_lanes": int(n),
        "n_coupled": n_coupled,
        # lanes whose validity flips between the legs, left out of the estimate
        "mismatched_validity": int((runs["fast"][1] != runs["parity"][1]).sum()),
        "config_delta": {f: [getattr(cfg, f), getattr(twin, f)]
                         for f in FAST_FIELDS if getattr(cfg, f) != getattr(twin, f)},
        "wall_s": 0.0,
        "wall_s_legs": leg_wall,
    }
    for k in METRICS:
        par = runs["parity"][0][k][both].astype(np.float64)
        d = par - runs["fast"][0][k][both]
        if n_coupled >= 2:
            bias = float(d.mean())
            stderr = float(d.std(ddof=1) / np.sqrt(n_coupled))
            amax = float(np.abs(d).max())
            sigma = float(par.std())
        else:  # everything filtered: NaN, never a crash
            bias = stderr = amax = sigma = float("nan")
        block[k] = {"bias": bias, "bias_stderr": stderr, "abs_max_delta": amax,
                    "population_sigma": sigma}
    block["wall_s"] = round(time.time() - t0, 3)
    return block
