"""Entry ``gonogo``: a range-safety officer's go/no-go on a forecast, one
candidate a request through the port's launch-window sweep
(``cli.launch_window.launch_window_sweep`` for one speed and one direction),
the candidates of the mix taken in turn, each request under its own seed.

Mix parameters: ``n`` (lanes a candidate), ``range_limit``, ``p_limit``,
``speeds`` and ``directions_deg`` (the candidates, speed-major), and
``dispersions`` (what the sweep's default dispersions change: the uniform
mean-wind offset held at zero, so each candidate's mean wind is its
forecast profile).

The check of one request: the candidate's drawn lanes against the
reference's draw around the same forecast profile, every one of its flights
flown again by the plain flight, and its row (counts, moments, the range's
95th percentile, the footprint's mean and CEP, the exceedance with its
Wilson interval, the verdict) worked out again from its own lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_bench import check as C
from gpu_bench import program
from gpu_bench.reference import pipeline as P
from gpu_bench.reference import stats as S

__all__ = ["setup", "run", "work", "check"]


@dataclasses.dataclass
class State:
    sweep: object
    kw: dict
    candidates: list
    seen: list
    count: int = 0


def setup(bench) -> State:
    from erpl_monte_carlo_sim_tpu_torch.cli import launch_window
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer

    seen = []

    class Kept(MonteCarloAnalyzer):
        """The sweep's analyzer, keeping each analysis it returns so that
        the check can read the candidate's lanes."""

        def run_monte_carlo(self, *args, **kw):
            a = super().run_monte_carlo(*args, **kw)
            seen.append(a)
            return a

    launch_window.MonteCarloAnalyzer = Kept
    cfg, mix = bench.config, bench.mix
    kw = dict(n=int(mix["n"]), range_limit=float(mix["range_limit"]),
              p_limit=float(mix["p_limit"]),
              scene=program.scene(cfg, bench.device, bench.dtype),
              sim_config=program.sim_config(cfg),
              uncertainty_params=program.uncertainty(cfg, mix.get("dispersions")),
              wind_grid_points=int(cfg["wind_grid"]["points"]),
              wind_grid_top=float(cfg["wind_grid"]["top"]))
    cands = [(float(s), float(d)) for s in mix["speeds"] for d in mix["directions_deg"]]
    return State(launch_window.launch_window_sweep, kw, cands, seen)


def run(state: State, seed: int) -> tuple:
    """``(flights, (speed, direction, row, lanes, sample))``: the next
    candidate's go/no-go row, on the host."""
    speed, direction = state.candidates[state.count % len(state.candidates)]
    state.count += 1
    state.seen.clear()
    sweep = state.sweep([speed], [direction], seed=seed, **state.kw)
    a = state.seen.pop()
    sample = {k: np.asarray(getattr(a["sample"], k)) for k in P.SAMPLE_FIELDS}
    row = sweep["candidates"][0]
    return state.kw["n"], (speed, direction, row, program.lanes(a["summary"]), sample)


def work(state: State, result) -> None:
    return None


def _profile(config: dict, speed: float, direction_deg: float, dtype):
    """The candidate's forecast: a power-law mean wind blowing toward
    ``direction_deg`` on the configuration's grid, on the host in float64
    from the model's exponent as the lanes' dtype holds it."""
    g = config["wind_grid"]
    alts = np.linspace(0.0, float(g["top"]), int(g["points"]))
    expo = float(torch.tensor(config["scene"]["wind_model"]["power_law_exponent"],
                              dtype=torch.float64).to(dtype))
    mag = speed * (np.maximum(alts, 1e-3) / 10.0) ** expo
    rad = np.deg2rad(direction_deg)
    return alts, np.stack([mag * np.cos(rad), mag * np.sin(rad), np.zeros_like(mag)], axis=1)


def _row_numbers(row: dict) -> tuple:
    num = {"apogee_altitude.mean": row["apogee_altitude"]["mean"],
           "apogee_altitude.std": row["apogee_altitude"]["std"],
           "range.mean": row["range"]["mean"], "range.std": row["range"]["std"],
           "range.p95": row["range_p95"],
           "footprint.mean_x": row["landing_footprint"]["mean_m"][0],
           "footprint.mean_y": row["landing_footprint"]["mean_m"][1],
           "footprint.cep": row["landing_footprint"]["cep_m"]}
    ex = row["p_range_exceed"]
    num["p_range_exceed"] = ex["probability"]
    num["p_range_exceed.ci_lo"], num["p_range_exceed.ci_hi"] = ex["ci95"]
    exact = {"n_valid": np.array([row["n_valid"]]), "n_outliers": np.array([row["n_outliers"]]),
             "n_exceed": np.array([ex["n_exceed"]]), "go": np.array([int(bool(row["go"]))])}
    return num, exact


def check(bench, result, seed: int, rng: np.random.Generator, compute=None) -> dict:
    """``check``'s numbers of one request; with ``compute`` the reference in
    that lower dtype takes the port's place (the control)."""
    speed, direction, row, prog_lanes, prog_sample = result
    dev, dtype, cfg, mix = bench.device, bench.dtype, bench.config, bench.mix
    n = int(mix["n"])
    base = _profile(cfg, speed, direction, dtype)
    over = mix.get("dispersions")
    scene_b, ic_b, sample = P.draw(cfg, P.key_of(seed), n, dev, dtype, base_profile=base,
                                   params_override=over)
    ref_sample = P.sample_host(sample)
    ids = ref_sample.pop("random_seed")
    if compute is not None:
        _, _, ctl = P.draw(cfg, P.key_of(seed), n, dev, dtype, base_profile=base,
                           params_override=over, compute=compute)
        prog_sample = P.sample_host(ctl)
    out = {"draw_gap": C.draw_gap({k: v for k, v in prog_sample.items() if k != "random_seed"},
                                  ref_sample)}
    idx = C.check_lanes(rng, n, int(mix.get("check_lanes", n)),
                        int(np.argmax(prog_lanes["n_steps"])))
    sel = torch.as_tensor(idx, device=dev)
    ref_lanes = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=sel)
    got = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=sel, compute=compute) \
        if compute is not None else {k: v[idx] for k, v in prog_lanes.items()}
    out["lanes_off"], out["lane_gap"] = C.lane_compare(got, ref_lanes)
    rl, pl = float(mix["range_limit"]), float(mix["p_limit"])
    num, exact = S.gonogo_numbers(prog_lanes, rl, pl)
    if compute is not None:
        pnum, pexact = S.gonogo_numbers(prog_lanes, rl, pl, dtype=compute)
    else:
        pnum, pexact = _row_numbers(row)
        pexact["sample.random_seed"] = np.asarray(prog_sample["random_seed"], np.int64)
        exact["sample.random_seed"] = ids
    out["stats_gap"] = C.numbers_gap(pnum, num)
    out["exact_off"] = C.exact_off(pexact, exact)
    return out
