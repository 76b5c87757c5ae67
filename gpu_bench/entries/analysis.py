"""Entry ``analysis``: one analyst running ``MonteCarloAnalyzer.
run_monte_carlo(n_samples)`` back to back, each analysis under its own seed.

Mix parameters: ``n_samples`` (the lanes of an analysis), ``check_lanes``
(how many of its lanes the check flies again), and optionally ``lane_slab``
(a run of more lanes goes slab by slab, the analysis then holding per-lane
``metrics`` in place of ``summary``).

The check of one analysis of the window (``check``): every drawn lane
against the reference's draw (single-call runs, which return their sample),
``check_lanes`` lanes drawn from the seed and the longest-running lane flown
again by the plain flight, and the statistics worked out again from the
analysis's own lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_bench import check as C
from gpu_bench import program
from gpu_bench.reference import pipeline as P
from gpu_bench.reference import random as R
from gpu_bench.reference import stats as S

__all__ = ["setup", "run", "work", "check"]

_METRICS = ("apogee_altitude", "range", "flight_time")


@dataclasses.dataclass
class State:
    mc: object
    ic: object
    n: int
    slab: int


def setup(bench) -> State:
    cfg = bench.config
    mc = program.analyzer(cfg, bench.device, bench.dtype)
    ic = program.initial_conditions(cfg, bench.device, bench.dtype)
    slab = int(bench.mix.get("lane_slab", cfg["max_lanes_per_call"]))
    return State(mc, ic, int(bench.mix["n_samples"]), slab)


def run(state: State, seed: int) -> tuple:
    """``(flights, analysis)``: one analysis, its statistics on the host."""
    a = state.mc.run_monte_carlo(state.ic, n_samples=state.n, seed=seed, lane_slab=state.slab)
    return state.n, a


def work(state: State, a: dict):
    """The flight kernel's work in an analysis: main-loop and rail steps
    summed over its lanes, and the lanes; None where the analysis keeps no
    per-lane summary (a slabbed run)."""
    s = a.get("summary")
    if s is None:
        return None
    rail_dt = state.mc.sim_config.rail_dt
    return {"main_steps": int(np.asarray(s.n_steps, np.int64).sum()),
            "rail_steps": int(np.round(np.asarray(s.rail.rail_exit_time, np.float64)
                                       / rail_dt).sum()),
            "lanes": int(np.size(s.n_steps))}


def _numbers(a: dict) -> tuple:
    """The port's analysis as the reference's ``(numbers, exact)`` names."""
    num = {}
    for k in _METRICS:
        st = a[k]
        for f in ("mean", "std", "min", "max"):
            num[f"{k}.{f}"] = st[f]
        for q, v in zip(S.PERCENTILES, st["percentiles"]):
            num[f"{k}.p{q:g}"] = v
        for q, (lo, hi) in zip(S.PERCENTILES, st.get("percentile_ci", [])):
            num[f"{k}.p{q:g}.ci_lo"], num[f"{k}.p{q:g}.ci_hi"] = lo, hi
    fp = a.get("landing_footprint")
    if fp is not None:
        num["footprint.n"] = fp["n"]
        if fp["n"]:
            num["footprint.mean_x"], num["footprint.mean_y"] = fp["mean_m"]
            (cxx, cxy), (_, cyy) = fp["cov_m2"]
            num["footprint.cov_xx"], num["footprint.cov_yy"], num["footprint.cov_xy"] = \
                cxx, cyy, cxy
            for tag in ("95", "99"):
                num[f"footprint.ellipse{tag}.major"] = fp[f"ellipse{tag}"]["semi_major_m"]
                num[f"footprint.ellipse{tag}.minor"] = fp[f"ellipse{tag}"]["semi_minor_m"]
            num["footprint.cep"] = fp["cep_m"]
    for name, r in (a.get("parameter_ranges_observed") or {}).items():
        lo, hi = np.atleast_1d(r["min"]), np.atleast_1d(r["max"])
        for j in range(lo.size):
            num[f"ranges.{name}.{j}.min"], num[f"ranges.{name}.{j}.max"] = lo[j], hi[j]
    exact = {"n_samples": np.array([a["n_samples"]]), "n_outliers": np.array([a["n_outliers"]])}
    if a.get("reasons") is not None:
        exact["reasons"] = np.asarray(a["reasons"], np.int64)
    for tag in ("results", "outliers"):
        recs = a.get(tag) or []
        exact[f"{tag}.simulation_id"] = np.array([r["simulation_id"] for r in recs], np.int64)
        for k in S.RECORD_FIELDS:
            exact[f"{tag}.{k}"] = np.array([r[k] for r in recs], np.float64)
    return num, exact


def _prog_sample(a: dict) -> dict:
    return {k: np.asarray(getattr(a["sample"], k)) for k in P.SAMPLE_FIELDS}


def check(bench, a: dict, seed: int, rng: np.random.Generator, compute=None) -> dict:
    """The numbers of ``check``'s module docstring for the analysis ``a``
    drawn under ``seed``; with ``compute`` (a lower dtype) the reference in
    that dtype takes the port's place (the control)."""
    if a.get("summary") is None:
        return _check_slabbed(bench, a, seed, rng, compute)
    dev, dtype, cfg = bench.device, bench.dtype, bench.config
    n = int(bench.mix["n_samples"])
    prog_lanes = program.lanes(a["summary"])
    prog_sample = _prog_sample(a)
    scene_b, ic_b, sample = P.draw(cfg, P.key_of(seed), n, dev, dtype)
    ref_sample = P.sample_host(sample)
    del sample
    out = {}
    if compute is not None:
        _, _, ctl = P.draw(cfg, P.key_of(seed), n, dev, dtype, compute=compute)
        prog_sample = P.sample_host(ctl)
        del ctl
    ids = ref_sample.pop("random_seed")
    out["draw_gap"] = C.draw_gap({k: v for k, v in prog_sample.items() if k != "random_seed"},
                                 ref_sample)
    idx = C.check_lanes(rng, n, int(bench.mix["check_lanes"]),
                        int(np.argmax(prog_lanes["n_steps"])))
    ref_lanes = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=torch.as_tensor(idx, device=dev))
    if compute is not None:
        got = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=torch.as_tensor(idx, device=dev),
                    compute=compute)
    else:
        got = {k: v[idx] for k, v in prog_lanes.items()}
    del scene_b, ic_b
    out["lanes_off"], out["lane_gap"] = C.lane_compare(got, ref_lanes)
    ref_sample["random_seed"] = ids
    num, exact = S.analysis_numbers(prog_lanes, prog_sample | {"random_seed": ids})
    if compute is not None:
        pnum, pexact = S.analysis_numbers(prog_lanes, prog_sample | {"random_seed": ids},
                                          dtype=compute)
    else:
        pnum, pexact = _numbers(a)
        pexact["sample.random_seed"] = np.asarray(prog_sample["random_seed"], np.int64)
        exact["sample.random_seed"] = ids
    out["stats_gap"] = C.numbers_gap(pnum, num)
    out["exact_off"] = C.exact_off(pexact, exact)
    return out


def _check_slabbed(bench, a: dict, seed: int, rng: np.random.Generator, compute=None) -> dict:
    """A slabbed analysis keeps each lane's headline metrics, not its
    sample: ``check_lanes`` of its kept lanes flown again (slab ``k`` drawn
    under ``fold_in(PRNGKey(seed), k)``), and, where the run kept every lane,
    the moments and percentiles worked out again from its metrics and mask."""
    dev, dtype, cfg = bench.device, bench.dtype, bench.config
    slab = int(bench.mix.get("lane_slab", cfg["max_lanes_per_call"]))
    metrics = {k: np.asarray(v) for k, v in a["metrics"].items() if k in _METRICS}
    valid = np.asarray(a["valid_mask"], bool)
    kept = valid.size
    idx = C.check_lanes(rng, kept, int(bench.mix["check_lanes"]), 0)
    got, ref = {k: [] for k in _METRICS}, {k: [] for k in _METRICS}
    for k in np.unique(idx // slab):
        lanes = idx[idx // slab == k]
        key = R.fold_in(P.key_of(seed, dev), int(k))
        scene_b, ic_b, _ = P.draw(cfg, key, slab, dev, dtype)
        sel = torch.as_tensor(lanes - k * slab, device=dev)
        r = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=sel)
        g = P.fly(scene_b, ic_b, P.make_sim_config(cfg), idx=sel, compute=compute) \
            if compute is not None else {m: metrics[m][lanes] for m in _METRICS}
        for m in _METRICS:
            ref[m].append(r[m])
            got[m].append(g[m])
    out = {}
    out["lanes_off"], out["lane_gap"] = C.lane_compare(
        {m: np.concatenate(v) for m, v in got.items()},
        {m: np.concatenate(v) for m, v in ref.items()})
    if not a.get("metrics_is_sample"):
        num = {}
        for m in _METRICS:
            v = torch.as_tensor(metrics[m], dtype=torch.float64)
            S._moments(v[torch.as_tensor(valid) & torch.isfinite(v)], m, num)
        pnum = _numbers(a)[0] if compute is None else {}
        if compute is not None:
            for m in _METRICS:
                v = torch.as_tensor(metrics[m]).to(compute)
                S._moments(v[torch.as_tensor(valid) & torch.isfinite(v)], m, pnum)
        out["stats_gap"] = C.numbers_gap({k: v for k, v in pnum.items() if k in num}, num)
    out["exact_off"] = C.exact_off({"n_samples": np.array([a["n_samples"]])},
                                   {"n_samples": np.array([valid.sum()])})
    return out
