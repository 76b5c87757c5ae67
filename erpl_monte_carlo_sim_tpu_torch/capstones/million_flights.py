"""1,048,576 dispersed flights of the 6 s window (about 1k steps a lane) on
one card, sampling included (``scripts/million_flights.py`` of the JAX
package).

Two calls of 524,288 lanes under ``PRNGKey(1)`` and ``PRNGKey(2)``, each
drawn by ``mc.sample_dispersions`` and flown by
``engine.simulate_summary_batch`` (on a card the flight kernel), after one
warm call under ``PRNGKey(0)`` before the clock starts (on a card it also
builds the kernels it flies). ``--fast`` flies the fast configuration:
``integrator="rk2"``, ``wind_eval_per_step`` and ``wind_table_bf16``, each
call's wind tables compressed to 24 turbulence modes on the sampler's grid
(``models.compress_wind``; on a card the kernel flies each lane's expanded
table, the scores rounded to bfloat16 once).

Run:  python -m erpl_monte_carlo_sim_tpu_torch.capstones.million_flights [--fast]
      [--device cpu]
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import random
from ..engine import InitialConditions, SimConfig, simulate_summary_batch
from ..mc import sample_dispersions
from ..models import compress_wind, liquid_motor, nominal_scene, wind_mode_basis
from . import card_or_cpu, device_name, parse_args, print_result

__all__ = ["HALF", "SEEDS", "WARM_SEED", "WINDOW", "FAST_FLAGS", "MODES", "config", "batch",
           "run", "main"]

HALF = 524_288          # lanes a call: two calls make 1,048,576 flights
SEEDS = (1, 2)
WARM_SEED = 0
WINDOW = 6.0
FAST_FLAGS = dict(integrator="rk2", wind_eval_per_step=True, wind_table_bf16=True)
MODES = 24              # turbulence modes of the --fast tables
MODE_GRID = (0.0, 25000.0, 100)  # the sampler's wind grid: linspace(*MODE_GRID)


def config(fast: bool, max_time: float = WINDOW) -> SimConfig:
    return SimConfig(max_time=max_time, **(FAST_FLAGS if fast else {}))


def batch(seed: int, scene, ic, lanes: int, basis=None):
    """One call's ``(scene_b, ic_b)``: ``lanes`` lanes under
    ``PRNGKey(seed)`` on the scene's device, their tables compressed onto
    ``basis`` where one is given."""
    scene_b, ic_b, _ = sample_dispersions(random.prng_key(seed, ic.position.device), scene, ic,
                                          n=lanes)
    if basis is not None:
        scene_b = dataclasses.replace(scene_b, wind=compress_wind(scene_b.wind, basis))
    return scene_b, ic_b


def run(fast: bool = False, device="cuda", *, lanes: int = HALF, seeds=SEEDS,
        warm_seed=WARM_SEED, max_time: float = WINDOW):
    """The script's run: one call of ``lanes`` lanes for each seed of
    ``seeds``, timed together from the first draw to the last readback,
    after a warm call under ``warm_seed`` (None: no warm call). Returns the
    JSON result and each timed call's ``FlightSummary``."""
    dev = card_or_cpu(device)
    cfg = config(fast, max_time)
    scene = nominal_scene(liquid_motor(dev))
    ic = InitialConditions.vertical_launch(dev)
    basis = (wind_mode_basis(scene.wind_model, np.linspace(*MODE_GRID), MODES)
             if fast else None)
    if warm_seed is not None:
        simulate_summary_batch(*batch(warm_seed, scene, ic, lanes, basis), cfg
                               ).apogee_altitude.cpu()
    t0 = time.time()
    summaries, apos = [], []
    for seed in seeds:
        r = simulate_summary_batch(*batch(seed, scene, ic, lanes, basis), cfg)
        apos.append(r.apogee_altitude.cpu().numpy())  # the readback: the call is done
        summaries.append(r)
    wall = time.time() - t0
    apo = np.concatenate(apos)
    steps = max(int(r.n_steps.max()) for r in summaries)
    return {
        "total_flights": int(apo.shape[0]),
        "steps": steps,
        "wall_s_incl_sampling": wall,
        "traj_per_s": apo.shape[0] / wall,
        "finite_frac": float(np.isfinite(apo).mean()),
        "apogee_mean_m": float(np.nanmean(apo)),
        "mode": "rk2 + wind/step + bf16 + modes24" if fast else "parity",
        "chips": 1,
        "device": device_name(dev),
    }, summaries


def main(argv=None) -> dict:
    a = parse_args("million_flights", "1,048,576 dispersed 1k-step flights on one card",
                   "--fast", "rk2 + per-step wind + bf16 tables on 24 wind modes", argv)
    result, _ = run(a.fast, a.device)
    print_result(result, card_or_cpu(a.device))
    return result


if __name__ == "__main__":
    main()
