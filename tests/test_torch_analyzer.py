"""PyTorch port, ``MonteCarloAnalyzer.run_monte_carlo`` (single-call branch)
on the CPU against the JAX analyzer on the same configuration and seed. Both
draw under ``PRNGKey(seed)``, so the analyses agree lane for lane: the same
schema, the valid mask exact, every summary leaf and the statistics within
rtol 1e-6 (and the means within 4 combined standard errors, as any two
samples of the distribution would be). The JAX analysis is also the golden
chip_smoke.py phase 17c holds the card's analysis to; it must equal the
committed file."""

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from chip_smoke import ANALYSIS_GOLDEN, ANALYSIS_LANES, analysis_arrays, analysis_error
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.ops import prng

torch.set_num_threads(1)

N = ANALYSIS_LANES
WINDOW = SimConfig(max_time=6.0)


@pytest.fixture(scope="module")
def analyses():
    mine = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=WINDOW).run_monte_carlo(
        InitialConditions.vertical_launch("cpu"), n_samples=N, seed=0)
    ref = JaxAnalyzer(scene=jax_nominal(jax_liquid()), sim_config=JaxConfig(max_time=6.0),
                      persistent_cache=False).run_monte_carlo(
        JaxIC.vertical_launch(), n_samples=N, seed=0)
    return mine, ref


def keyset(obj):
    """The nested key structure of an analysis: dict keys, dataclass
    field names, and the structure of a list's first element."""
    if isinstance(obj, dict):
        return {k: keyset(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: keyset(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [keyset(obj[0])]
    return None


def test_analysis_keys_match_jax(analyses):
    mine, ref = analyses
    assert keyset(mine) == keyset(ref)
    assert mine["summary"].apogee_altitude.shape == (N,)
    assert mine["summary"].landing_position.shape == (N, 3)
    assert mine["valid_mask"].dtype == bool and mine["reasons"].dtype == np.int32


@pytest.mark.parametrize("metric", ["apogee_altitude", "range", "flight_time"])
def test_means_agree_with_jax(analyses, metric):
    mine, ref = analyses
    a, b = mine[metric], ref[metric]
    se = math.sqrt(a["std"] ** 2 / mine["n_samples"] + b["std"] ** 2 / ref["n_samples"])
    assert abs(a["mean"] - b["mean"]) <= 4 * se + 1e-9, (a["mean"], b["mean"], se)
    assert len(a["percentiles"]) == 5 and len(a["percentile_ci"]) == 5


def test_lanes_match_jax(analyses):
    """The seed draws the JAX package's lanes: the valid mask and reasons
    exact, every summary leaf and the statistics within rtol 1e-6."""
    mine, ref = analyses
    np.testing.assert_array_equal(mine["valid_mask"], ref["valid_mask"])
    np.testing.assert_array_equal(mine["reasons"], ref["reasons"])
    assert 0 < mine["n_samples"] <= N and mine["n_outliers"] == ref["n_outliers"]
    analysis_error(analysis_arrays(mine), analysis_arrays(ref))
    np.testing.assert_allclose(mine["sample"].motor_thrust_multiplier,
                               ref["sample"].motor_thrust_multiplier, rtol=1e-12)


def test_card_golden_is_live_jax(analyses):
    """chip_smoke.py phase 17c's golden is the JAX analysis of this
    configuration, as JAX computes it now."""
    _, ref = analyses
    live = analysis_arrays(ref)
    with np.load(ANALYSIS_GOLDEN) as z:
        assert sorted(z.files) == sorted(live)
        for k in live:
            np.testing.assert_array_equal(z[k], live[k], err_msg=k)


def test_reproducible_for_a_seed_and_not_across_seeds():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=3.0))
    ic = InitialConditions.vertical_launch("cpu")
    a = mc.run_monte_carlo(ic, n_samples=16, seed=3)
    b = mc.run_monte_carlo(ic, n_samples=16, seed=3)
    c = mc.run_monte_carlo(ic, n_samples=16, seed=4)
    np.testing.assert_array_equal(a["summary"].apogee_altitude, b["summary"].apogee_altitude)
    assert a["apogee_altitude"] == b["apogee_altitude"] and a["n_samples"] > 0
    assert not np.array_equal(a["summary"].apogee_altitude, c["summary"].apogee_altitude)
    assert len(a["results"]) + len(a["outliers"]) == 16


def test_rejects_unknown_ic_keys():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"))
    with pytest.raises(ValueError, match="unknown initial_conditions"):
        mc.run_monte_carlo({"posiiton": (0, 0, 0)}, n_samples=4)


@pytest.mark.parametrize("option,block", [
    ({"control_variates": True}, "control_variates"),
    ({"control_variates": True, "cv_wind_modes": 2, "cv_wind_speed": 2}, "control_variates"),
    ({"two_level_lanes": 8, "sim_config": SimConfig(max_time=0.2, integrator="rk2")},
     "two_level"),
], ids=["control_variates", "cv_wind", "two_level_lanes"])
def test_estimator_constructor_options_run(option, block):
    """The estimators' options run on the analyzer's device and add their
    blocks (held to the JAX analyzer's in tests/test_torch_cv.py and
    tests/test_torch_two_level.py)."""
    option = {"sim_config": SimConfig(max_time=0.2), **option}
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), wind_grid_points=10, **option)
    a = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=8, seed=2)
    assert a[block]["n" if block == "control_variates" else "n_lanes"] == 8
    if block == "control_variates":
        names = a[block]["controls"]
        assert len(names) == len(set(names)) and any("turb" in n for n in names) == (
            "cv_wind_modes" in option)
        assert a[block]["insufficient_samples"]  # 8 lanes cannot fit the controls
    else:
        assert a[block]["config_delta"] == {"integrator": ["rk2", "rk4"]}


@pytest.mark.parametrize("option,block", [
    ({"sampler": "sobol", "sobol_scrambles": 2, "sobol_wind_modes": 2}, "qmc_error"),
    ({"antithetic": True}, None),
    ({"importance_shift": {"mass": 1.0}}, "importance"),
], ids=["sobol", "antithetic", "importance"])
def test_sampling_constructor_options_run(option, block):
    """The sampling options run on the analyzer's device and add their
    blocks; the lanes are the sampler's under the same options and seed."""
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions

    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.2),
                            **option)
    ic = InitialConditions.vertical_launch("cpu")
    a = mc.run_monte_carlo(ic, n_samples=8, seed=2)
    assert block is None or block in a
    _, _, want = sample_dispersions(prng.prng_key(2), mc.scene, ic, n=8, **option)
    np.testing.assert_array_equal(a["sample"].mass_multiplier, want.mass_multiplier.numpy())
    if option.get("antithetic"):
        np.testing.assert_array_equal(a["sample"].wind_speed[4:],
                                      5.0 - a["sample"].wind_speed[:4])


def test_sampling_constructor_checks_match_jax():
    with pytest.raises(ValueError, match="importance_shift requires sampler='prng'"):
        MonteCarloAnalyzer(motor=liquid_motor("cpu"), sampler="sobol",
                           importance_shift={"mass": 1.0})
    with pytest.raises(ValueError, match="importance_shift requires sampler='prng'"):
        MonteCarloAnalyzer(motor=liquid_motor("cpu"), antithetic=True,
                           importance_shift={"mass": 1.0})
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), importance_shift={"mass": 1.0},
                            stats_stream_threshold=4, sim_config=SimConfig(max_time=0.1))
    with pytest.raises(ValueError, match="per-lane weights"):
        mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=8, lane_slab=4)


@pytest.mark.parametrize("flags", [
    {"integrator": "rk2"}, {"descent_dt_scale": 8}, {"speed_guard": 3000.0},
    {"wind_eval_per_step": True}, {"wind_table_bf16": True},
    {"energy_consistent_aero": True}, {"ascent_q_threshold": 5000.0},
    {"terminate_nonfinite": False},
], ids=lambda f: next(iter(f)))
def test_sim_config_flags_reach_the_flights(flags):
    """The analyzer takes every SimConfig opt-in and flies its lanes with
    it: its summary is simulate_summary_batch's under the same config on
    the lanes the same seed draws."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

    cfg = SimConfig(max_time=1.2, **flags)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=cfg)
    ic = InitialConditions.vertical_launch("cpu")
    a = mc.run_monte_carlo(ic, n_samples=4, seed=5)
    scene_b, ic_b, _ = sample_dispersions(prng.prng_key(5), mc.scene, ic, n=4)
    want = to_numpy(simulate_summary_batch(scene_b, ic_b, cfg))
    np.testing.assert_array_equal(a["summary"].apogee_altitude, want.apogee_altitude)
    np.testing.assert_array_equal(a["summary"].n_steps, want.n_steps)
    assert (want.n_steps > 0).all()


def _ensemble_run(**kw):
    """A two-member forecast ensemble: a malformed one raises as the JAX
    package does, a well-formed one runs with its ensemble block and each
    lane's member."""
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.1),
                            bounds=OutlierBounds(min_apogee=0.0))
    ic = InitialConditions.vertical_launch("cpu")
    mc.base_altitude_profile = torch.linspace(0.0, 25000.0, 10, dtype=torch.float64)
    mc.base_wind_profile = torch.zeros((2, 9, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="base_wind must be"):
        mc.run_monte_carlo(ic, n_samples=4, **kw)
    mc.base_wind_profile = torch.stack([torch.zeros(10, 3), torch.full((10, 3), 4.0)]).double()
    a = mc.run_monte_carlo(ic, n_samples=8, **kw)
    assert a["ensemble"]["n_members"] == 2
    assert sum(r["n_drawn"] for r in a["ensemble"]["members"]) == 8
    assert a["wind_members"].shape == (8,) and set(a["wind_members"]) <= {0, 1}
    return a


def test_forecast_ensemble_raises():
    a = _ensemble_run()
    np.testing.assert_array_equal(a["wind_members"], a["sample"].wind_member)


def test_forecast_ensemble_raises_on_the_slabbed_path():
    a = _ensemble_run(lane_slab=2)
    assert a["summary"] is None and a["n_total"] == 8


if __name__ == "__main__" and sys.argv[1:] == ["--write-golden"]:
    # regenerate phase 17c's golden: python tests/test_torch_analyzer.py
    # --write-golden (from the repository's root, with JAX_ENABLE_X64=1)
    import jax

    jax.config.update("jax_enable_x64", True)
    np.savez(ANALYSIS_GOLDEN, **analysis_arrays(JaxAnalyzer(
        scene=jax_nominal(jax_liquid()), sim_config=JaxConfig(max_time=6.0),
        persistent_cache=False).run_monte_carlo(JaxIC.vertical_launch(), n_samples=N, seed=0)))
