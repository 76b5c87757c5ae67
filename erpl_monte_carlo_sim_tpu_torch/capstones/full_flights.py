"""1,048,576 wind-dispersed flights to landing on one card, with the
two-level bias correction of their means (``scripts/full_flights.py`` of
the JAX package).

Four slabs of 262,144 lanes under ``PRNGKey(1..4)``, after one warm slab
under ``PRNGKey(0)`` before the clock starts (on a card it also builds the
kernel). Each slab is drawn by ``mc.sample_dispersions``, flown to landing
by ``engine.simulate_summary_batch`` (on a card the flight kernel) under
the stabilized, tiered configuration (``energy_consistent_aero``,
``descent_dt_scale=16``, ``ascent_q_threshold=8000``; ``--rk2`` adds the
midpoint integrator), filtered by ``mc.outlier_mask`` and read back.
Then ``mc.two_level_block`` flies 4,096 coupled lanes under that
configuration and its parity twin (seed 99: the JAX package's
``fold_in(PRNGKey(99), 0x2B1A5C0)`` lanes), and the JSON gives each
headline mean raw and corrected by the measured bias.

Run:  python -m erpl_monte_carlo_sim_tpu_torch.capstones.full_flights [--rk2]
      [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from .. import random
from ..engine import InitialConditions, SimConfig, simulate_summary_batch
from ..mc import outlier_mask, sample_dispersions, two_level_block
from ..models import liquid_motor, nominal_scene
from . import card_or_cpu, device_name, parse_args, print_result

__all__ = ["SLAB", "N_SLABS", "WARM_SEED", "TWO_LEVEL_LANES", "TWO_LEVEL_SEED", "config",
           "corrected", "run", "main"]

SLAB = 262_144
N_SLABS = 4             # 4 x 262,144 = 1,048,576 flights, slab k under PRNGKey(k)
WARM_SEED = 0
TWO_LEVEL_LANES = 4096
TWO_LEVEL_SEED = 99
MAX_TIME = SimConfig().max_time


def config(rk2: bool, max_time: float = MAX_TIME) -> SimConfig:
    return SimConfig(energy_consistent_aero=True,  # stabilized: no wind-divergence outliers
                     descent_dt_scale=16,          # coarse dt in quiet phases only
                     ascent_q_threshold=8000.0,    # and in the quiet coast ascent
                     integrator="rk2" if rk2 else "rk4", max_time=max_time)


def corrected(tl: dict, metric: str, values: np.ndarray, valid: np.ndarray) -> dict:
    """The script's ``corrected()`` block of one metric: the valid lanes'
    mean raw and plus the two-level bias, the bias's stderr and the mean's
    own sampling stderr."""
    b = tl[metric]
    raw = values[valid].mean()
    samp_se = values[valid].std() / np.sqrt(max(int(valid.sum()), 1))
    return {
        "raw_mean": float(raw),
        "corrected_mean": float(raw + b["bias"]),
        "bias": b["bias"],
        "bias_stderr": b["bias_stderr"],
        "sampling_stderr": float(samp_se),
    }


def run(rk2: bool = False, device="cuda", *, slab: int = SLAB, n_slabs: int = N_SLABS,
        warm_seed=WARM_SEED, max_time: float = MAX_TIME,
        two_level_lanes: int = TWO_LEVEL_LANES, two_level_seed: int = TWO_LEVEL_SEED):
    """The script's run: ``n_slabs`` slabs of ``slab`` lanes, slab k under
    ``PRNGKey(k)`` (k from 1), timed from the first draw to the last
    readback, after a warm slab under ``warm_seed`` (None: no warm slab);
    then the two-level block of ``two_level_lanes`` lanes. Returns the JSON
    result and the per-lane arrays (``apogee_altitude``, ``range``,
    ``flight_time``, ``valid``) with the two-level block."""
    dev = card_or_cpu(device)
    cfg = config(rk2, max_time)
    scene = nominal_scene(liquid_motor(dev))
    ic = InitialConditions.vertical_launch(dev)

    def slab_lanes(seed):
        return sample_dispersions(random.prng_key(seed, dev), scene, ic, n=slab)[:2]

    if warm_seed is not None:
        simulate_summary_batch(*slab_lanes(warm_seed), cfg).apogee_altitude.cpu()
    t0 = time.time()
    parts = {"apogee_altitude": [], "range": [], "flight_time": [], "valid": []}
    steps = []
    for seed in range(1, n_slabs + 1):
        r = simulate_summary_batch(*slab_lanes(seed), cfg)
        m, _ = outlier_mask(r)
        for k in ("apogee_altitude", "range", "flight_time"):
            parts[k].append(getattr(r, k).cpu().numpy())
        parts["valid"].append(m.cpu().numpy())
        steps.append(r.n_steps.max())
    wall = time.time() - t0
    lanes = {k: np.concatenate(v) for k, v in parts.items()}
    apo, rng, ft, valid = (lanes[k] for k in ("apogee_altitude", "range", "flight_time", "valid"))

    # The fast flags carry a small deterministic integration bias, and at
    # n = 1M the sampling stderr is far below it: a small coupled batch (the
    # same draws, fast and parity) measures it, and the headline means are
    # corrected by it.
    tl = two_level_block(scene, ic, cfg, two_level_lanes, seed=two_level_seed)
    lanes["two_level"] = tl
    return {
        "total_flights": int(apo.shape[0]),
        "wall_s_incl_sampling": wall,
        "full_traj_per_s": apo.shape[0] / wall,
        "max_lane_steps": max(int(s) for s in steps),
        "valid_frac": float(valid.mean()),
        "apogee_mean_m": float(apo[valid].mean()),
        "apogee_std_m": float(apo[valid].std()),
        "range_mean_m": float(rng[valid].mean()),
        "flight_time_mean_s": float(ft[valid].mean()),
        "two_level": {
            "apogee_altitude": corrected(tl, "apogee_altitude", apo, valid),
            "range": corrected(tl, "range", rng, valid),
            "flight_time": corrected(tl, "flight_time", ft, valid),
            "n_coupled": tl["n_coupled"],
            "wall_s": tl["wall_s"],
        },
        "mode": "stabilized aero + tiered dt (descent_dt_scale=16, q_thresh=8000)"
                + (" + rk2" if rk2 else ""),
        "chips": 1,
        "device": device_name(dev),
    }, lanes


def main(argv=None) -> dict:
    a = parse_args("full_flights", "1,048,576 stabilized flights to landing on one card",
                   "--rk2", "the midpoint integrator", argv)
    result, _ = run(a.rk2, a.device)
    print_result(result, card_or_cpu(a.device))
    return result


if __name__ == "__main__":
    main()
