"""100,000,000 dispersed flights of the 6 s window on one card through the
analyzer (``scripts/hundred_million_flights.py`` of the JAX package):
sampling, flights, the outlier filter, streaming statistics with the
quantile sketch, and the landing footprint, with host memory of the order
of one slab.

``MonteCarloAnalyzer.run_monte_carlo(n_samples=100,000,000,
lane_slab=262,144, seed=7)`` goes slab by slab (slab k under
``fold_in(PRNGKey(7), k)``; the last of the 382 slabs holds 123,136 lanes),
streams its statistics past 4,194,304 lanes and keeps the first 1,048,576
lanes' metrics. It writes a checkpoint every 16 slabs to
``outputs/hundred_million[_fast].ckpt.npz`` under the working directory,
resumes from it when run again after a kill (bit for bit), and removes it
when the run completes. ``--fast`` flies ``integrator="rk2"``,
``wind_eval_per_step`` and ``wind_table_bf16`` on tables compressed to 24
turbulence modes, and corrects the headline means by a two-level block of
4,096 coupled lanes. The JSON adds the process's peak resident memory.

Run:  python -m erpl_monte_carlo_sim_tpu_torch.capstones.hundred_million_flights [--fast]
      [--device cpu]
"""

from __future__ import annotations

import resource
import time

from ..engine import InitialConditions, SimConfig
from ..mc import MonteCarloAnalyzer
from ..models import liquid_motor, nominal_scene
from . import card_or_cpu, device_name, parse_args, print_result

__all__ = ["N", "SLAB", "SEED", "WINDOW", "STEPS", "FAST_FLAGS", "MODES", "TWO_LEVEL_LANES",
           "CHECKPOINT_EVERY", "STREAM_THRESHOLD", "checkpoint_path_of", "run", "main"]

N = 100_000_000
SLAB = 262_144
SEED = 7
WINDOW = 6.0
STEPS = 1050            # the window's largest lane step count over million_flights' lanes
FAST_FLAGS = dict(integrator="rk2", wind_eval_per_step=True, wind_table_bf16=True)
MODES = 24
TWO_LEVEL_LANES = 4096
CHECKPOINT_EVERY = 16   # slabs between checkpoints
STREAM_THRESHOLD = 4_194_304  # lanes past which the statistics stream (the analyzer's default)


def checkpoint_path_of(fast: bool) -> str:
    return ("outputs/hundred_million_fast.ckpt.npz" if fast
            else "outputs/hundred_million.ckpt.npz")


def run(fast: bool = False, device="cuda", *, n_samples: int = N, lane_slab: int = SLAB,
        seed: int = SEED, max_time: float = WINDOW, two_level_lanes: int = TWO_LEVEL_LANES,
        stats_stream_threshold: int = STREAM_THRESHOLD, checkpoint_path=None,
        checkpoint_every: int = CHECKPOINT_EVERY):
    """The script's run, timed from the analyzer's call to its return (its
    statistics are on the host by then). ``checkpoint_path`` defaults to
    ``checkpoint_path_of(fast)``. Returns the JSON result and the
    analysis."""
    dev = card_or_cpu(device)
    cfg = SimConfig(max_time=max_time, **(FAST_FLAGS if fast else {}))
    fast_options = dict(wind_table_modes=MODES, two_level_lanes=two_level_lanes) if fast else {}
    mc = MonteCarloAnalyzer(scene=nominal_scene(liquid_motor(dev)), sim_config=cfg,
                            stats_stream_threshold=stats_stream_threshold, **fast_options)
    ic = InitialConditions.vertical_launch(dev)
    t0 = time.time()
    a = mc.run_monte_carlo(ic, n_samples=n_samples, lane_slab=lane_slab, seed=seed,
                           checkpoint_path=checkpoint_path or checkpoint_path_of(fast),
                           checkpoint_every=checkpoint_every)
    wall = time.time() - t0
    return {
        "total_flights": a["n_total"],
        "valid": a["n_samples"],
        "outliers": a["n_outliers"],
        "steps": STEPS if max_time == WINDOW else None,
        "wall_s": wall,
        "traj_per_s": a["n_total"] / wall,
        "apogee_mean_m": a["apogee_altitude"]["mean"],
        "apogee_std_m": a["apogee_altitude"]["std"],
        # percentiles are [5, 25, 50, 75, 95] (mc.stats.PERCENTILES)
        "apogee_p50_m": a["apogee_altitude"]["percentiles"][2],
        "metrics_is_sample": a["metrics_is_sample"],
        "landing_footprint": a["landing_footprint"],
        "host_peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "two_level": a.get("two_level"),
        "mode": "rk2 + wind/step + bf16 + modes24 + two-level" if fast else "parity",
        "chips": 1,
        "device": device_name(dev),
    }, a


def main(argv=None) -> dict:
    a = parse_args("hundred_million_flights",
                   "100,000,000 dispersed 1k-step flights through the analyzer on one card",
                   "--fast", "rk2 + per-step wind + bf16 on 24 wind modes, two-level corrected",
                   argv)
    result, _ = run(a.fast, a.device)
    print_result(result, card_or_cpu(a.device))
    return result


if __name__ == "__main__":
    main()
