"""PyTorch port, the slabbed Monte Carlo run (``MonteCarloAnalyzer._run_slabbed``)
against the JAX analyzer's on the same lanes.

Both analyzers run N=80 lanes in slabs of 32 (a ragged last slab of 16) in
float64 on a 1.5 s window, with ``min_apogee`` near the window's median
apogee so that every slab holds valid lanes and outliers, and records of
both kinds fill past the first slab. The JAX slabs are drawn from
``fold_in(PRNGKey(seed), k)`` as its loop draws them and reach the port
through its one draw seam (``mc.analyzer._draw_slab``) and
``sample_from_numpy``. Each run goes once with exact host statistics and
once streaming (``stats_stream_threshold=40, metrics_sample_cap=24``: the
sketch takes over mid-run and the prefix is capped). Bars: metrics, stats
blocks, footprint, records and convergence rows at rtol 1e-9; masks, reason
bits, counts, lane ids and parameter ranges exact. The port's own run from
the seed (no seam: slab k drawn under ``fold_in(PRNGKey(seed), k)`` by the
port) is the JAX analysis too: masks exact, metrics and statistics within
rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import exceedance_from_analysis as jax_exceedance
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import (MonteCarloAnalyzer, OutlierBounds,
                                               exceedance_from_analysis)
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)
from test_torch_analyzer import keyset

torch.set_num_threads(1)

N, SLAB, SEED = 80, 32, 5
WINDOW = 1.5          # rail exit and about 130 steps; apogee 57-74 m
MIN_APOGEE = 64.2     # near the window's median apogee: 41 valid lanes of 80
LIMIT = 20            # records of each kind: both lists fill in the second slab
RTOL = 1e-9
STREAMING = {"stats_stream_threshold": 40, "metrics_sample_cap": 24}
JSCENE = jax_nominal(jax_liquid())
JIC = JaxIC.vertical_launch()


def jax_slab(analyzer, ic, k, slab, seed, base_wind):
    """The port's draw seam fed with the JAX analyzer's slab ``k``."""
    scene_b, ic_b, sample = jax_sample(jax.random.fold_in(jax.random.PRNGKey(seed), k),
                                       JSCENE, JIC, n=slab)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


@pytest.fixture(scope="module", params=["exact", "streaming"])
def both(request):
    knobs = STREAMING if request.param == "streaming" else {}
    ref = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW),
                      bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False,
                      **knobs).run_monte_carlo(JIC, n_samples=N, lane_slab=SLAB, seed=SEED,
                                               materialize_results=LIMIT)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE), **knobs)
    run = dict(n_samples=N, lane_slab=SLAB, seed=SEED, materialize_results=LIMIT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        got = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), **run)
    FROM_SEED[request.param] = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"),
                                                  **run)
    return request.param, got, ref


FROM_SEED = {}  # the port's run drawn from the seed, by kind


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, atol=0.0, err_msg=what)


def test_schema_and_counts_match_jax(both):
    kind, got, ref = both
    assert keyset(got) == keyset(ref)
    for k in ("n_samples", "n_outliers", "n_total", "n_failed", "metrics_is_sample"):
        assert got[k] == ref[k], k
    assert got["n_total"] == N and 0 < got["n_samples"] < N
    assert (got["streams"] is None) == (kind == "exact")
    if kind == "streaming":  # the sketch took over in the last slab
        assert not got["streams"]["apogee_altitude"].is_exact
        assert not ref["streams"]["apogee_altitude"].is_exact
    np.testing.assert_array_equal(got["valid_mask"], ref["valid_mask"])
    np.testing.assert_array_equal(got["reasons"], ref["reasons"])
    assert got["valid_mask"].size == (STREAMING["metrics_sample_cap"] if kind == "streaming"
                                      else N)


def test_metrics_and_stats_blocks_match_jax(both):
    _, got, ref = both
    assert got["metrics"].keys() == ref["metrics"].keys()
    for k in ref["metrics"]:
        close(got["metrics"][k], ref["metrics"][k], f"metrics.{k}")
    close(got["landing_samples"], ref["landing_samples"], "landing_samples")
    for metric in ("apogee_altitude", "range", "flight_time"):
        a, b = got[metric], ref[metric]
        assert a.keys() == b.keys(), metric
        for k in ("mean", "std", "min", "max", "percentiles", "percentile_ci"):
            close(a[k], b[k], f"{metric}.{k}")


def test_from_seed_is_the_jax_analysis(both):
    kind, _, ref = both
    mine = FROM_SEED[kind]
    np.testing.assert_array_equal(mine["valid_mask"], ref["valid_mask"])
    np.testing.assert_array_equal(mine["reasons"], ref["reasons"])
    assert mine["n_samples"] == ref["n_samples"]
    for k in ref["metrics"]:
        np.testing.assert_allclose(mine["metrics"][k], ref["metrics"][k], rtol=1e-6,
                                   err_msg=k)
    for metric in ("apogee_altitude", "range", "flight_time"):
        for k in ("mean", "std", "min", "max", "percentiles"):
            np.testing.assert_allclose(mine[metric][k], ref[metric][k], rtol=1e-6,
                                       err_msg=f"{metric}.{k}")


def test_every_slab_holds_valid_lanes_and_outliers(both):
    """The bounds split each slab, the ragged last one included."""
    _, got, ref = both
    done = [row["n_done"] for row in got["convergence"]]
    valid = [row["n_valid"] for row in got["convergence"]]
    assert done == [32, 64, 80]
    per_slab = np.diff([0] + valid)
    assert (per_slab > 0).all() and (per_slab < np.diff([0] + done)).all()


def test_footprint_and_ranges_match_jax(both):
    _, got, ref = both
    a, b = got["landing_footprint"], ref["landing_footprint"]
    assert a["n"] == b["n"] and a["cep_method"] == b["cep_method"] == "gaussian"
    for k in ("mean_m", "cov_m2", "orientation_deg", "cep_m"):
        close(a[k], b[k], k)
    for k in ("ellipse95", "ellipse99"):
        close(list(a[k].values()), list(b[k].values()), k)
    assert got["parameter_ranges_observed"] == ref["parameter_ranges_observed"]
    ids = got["parameter_ranges_observed"]["random_seed"]
    assert 0 <= ids["min"] and ids["max"] < N  # no padding lane reached it


def test_records_match_jax(both):
    _, got, ref = both
    for kind in ("results", "outliers"):
        a, b = got[kind], ref[kind]
        assert len(a) == len(b) == LIMIT, kind
        assert [r["simulation_id"] for r in a] == [r["simulation_id"] for r in b]
        assert max(r["simulation_id"] for r in a) >= SLAB  # ids are global
        for ra, rb in zip(a, b):
            assert ra["parameters"] == rb["parameters"]
            assert ra["parachute_deployed"] == rb["parachute_deployed"]
            assert ra.get("outlier_reasons") == rb.get("outlier_reasons")
            close([ra[k] for k in ("apogee_altitude", "apogee_time", "range", "flight_time",
                                   "max_speed", "rail_exit_speed", "rail_exit_time")]
                  + ra["landing_position"],
                  [rb[k] for k in ("apogee_altitude", "apogee_time", "range", "flight_time",
                                   "max_speed", "rail_exit_speed", "rail_exit_time")]
                  + rb["landing_position"], f"{kind} {ra['simulation_id']}")


def test_convergence_rows_match_jax(both):
    _, got, ref = both
    assert len(got["convergence"]) == len(ref["convergence"]) == 3
    for ra, rb in zip(got["convergence"], ref["convergence"]):
        assert (ra["n_done"], ra["n_valid"]) == (rb["n_done"], rb["n_valid"])
        for metric in ("apogee_altitude", "range", "flight_time"):
            close([ra[metric]["mean"], ra[metric]["stderr"]],
                  [rb[metric]["mean"], rb[metric]["stderr"]], metric)


def test_exceedance_from_analysis_matches_jax(both):
    """The answer comes from the same layout in both: the kept lanes, or
    the stream (exact still at 40 lanes, then the sketch)."""
    _, got, ref = both
    ts = np.percentile(got["metrics"]["apogee_altitude"], [10, 50, 90])
    a = exceedance_from_analysis(got, "apogee_altitude", ts)
    b = jax_exceedance(ref, "apogee_altitude", ts)
    assert [r["method"] for r in a] == [r["method"] for r in b]
    for ra, rb in zip(a, b):
        close(ra["probability"], rb["probability"], "probability")
        assert ra["n"] == rb["n"]


# the sampling variants' slab blocks: a Sobol run over a three-member
# forecast ensemble (qmc_error from the slab means, the ensemble block, the
# prefix's member column; the importance weights' slab accumulator is held
# by tests/test_torch_slab_checkpoint.py and its block by
# tests/test_torch_sampling_variants.py)
ENSEMBLE = np.stack([np.zeros((100, 3)), np.full((100, 3), 3.0), np.full((100, 3), -3.0)])
VARIANTS = {"sobol_ensemble": {"sampler": "sobol", "sobol_wind_modes": 2}}


def jax_variant_slab(analyzer, ic, k, slab, seed, base_wind):
    """The port's draw seam fed with the JAX analyzer's slab ``k`` under the
    analyzer's sampling options."""
    scene_b, ic_b, sample = jax_sample(
        jax.random.fold_in(jax.random.PRNGKey(seed), k), JSCENE, JIC, n=slab,
        base_wind=base_wind, sampler=analyzer.sampler,
        sobol_wind_modes=analyzer.sobol_wind_modes)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant_runs(request):
    knobs = VARIANTS[request.param]
    ref_mc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW),
                         bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False,
                         **knobs)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE), **knobs)
    grid = np.linspace(0.0, 25000.0, 100)
    ref_mc.base_altitude_profile = mc.base_altitude_profile = grid
    ref_mc.base_wind_profile = mc.base_wind_profile = ENSEMBLE
    ref = ref_mc.run_monte_carlo(JIC, n_samples=N, lane_slab=SLAB, seed=SEED,
                                 materialize_results=LIMIT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_slab", jax_variant_slab)
        got = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=N,
                                 lane_slab=SLAB, seed=SEED, materialize_results=LIMIT)
    return request.param, got, ref


def test_variant_blocks_match_jax(variant_runs):
    _, got, ref = variant_runs
    assert keyset(got) == keyset(ref)
    np.testing.assert_array_equal(got["valid_mask"], ref["valid_mask"])
    for k in ("apogee_altitude", "range", "flight_time"):
        close(got["metrics"][k], ref["metrics"][k], k)
    for k, v in ref["qmc_error"].items():
        assert len(got["qmc_error"][k]["block_means"]) == 3
        close(got["qmc_error"][k]["block_means"], v["block_means"], k)
        close(got["qmc_error"][k]["mean_stderr"], v["mean_stderr"], k)
    np.testing.assert_array_equal(got["wind_members"], ref["wind_members"])
    for row, rrow in zip(got["ensemble"]["members"], ref["ensemble"]["members"]):
        assert (row["n_drawn"], row["n_valid"]) == (rrow["n_drawn"], rrow["n_valid"])
        for k in ("apogee_altitude", "range", "flight_time"):
            close([row[k]["mean"], row[k]["std"]], [rrow[k]["mean"], rrow[k]["std"]], k)
