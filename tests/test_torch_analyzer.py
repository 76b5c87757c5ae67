"""PyTorch port, ``MonteCarloAnalyzer.run_monte_carlo`` (single-call branch)
on the CPU against the JAX analyzer on the same configuration. The two
samplers draw different lanes from the same seed, so the analyses agree in
schema and in distribution: means within 4 combined standard errors."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

torch.set_num_threads(1)

N = 256
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


@pytest.mark.parametrize("option,item", [
    ({"sampler": "sobol"}, "P12"),
    ({"antithetic": True}, "P12"),
    ({"importance_shift": {"mass": 1.0}}, "P12"),
    ({"control_variates": True}, "P13"),
    ({"two_level_lanes": 64}, "P13"),
    ({"wind_table_modes": 24}, "P8"),
    ({"mesh": object()}, "P16"),
])
def test_unported_constructor_options_raise(option, item):
    with pytest.raises(NotImplementedError, match=item):
        MonteCarloAnalyzer(motor=liquid_motor("cpu"), **option)


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
    scene_b, ic_b, _ = sample_dispersions(torch.Generator().manual_seed(5), mc.scene, ic, n=4)
    want = to_numpy(simulate_summary_batch(scene_b, ic_b, cfg))
    np.testing.assert_array_equal(a["summary"].apogee_altitude, want.apogee_altitude)
    np.testing.assert_array_equal(a["summary"].n_steps, want.n_steps)
    assert (want.n_steps > 0).all()


@pytest.mark.parametrize("kwargs,item", [
    ({"n_samples": 8, "chunk_steps": 100}, "Left out of the port"),
])
def test_unported_run_options_raise(kwargs, item):
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"))
    with pytest.raises(NotImplementedError, match=item):
        mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), **kwargs)


def test_forecast_ensemble_raises():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.1))
    mc.base_altitude_profile = torch.linspace(0.0, 25000.0, 10, dtype=torch.float64)
    mc.base_wind_profile = torch.zeros((2, 10, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="P12"):
        mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=4)


def test_forecast_ensemble_raises_on_the_slabbed_path():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.1))
    mc.base_altitude_profile = torch.linspace(0.0, 25000.0, 10, dtype=torch.float64)
    mc.base_wind_profile = torch.zeros((2, 10, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="P12"):
        mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=4, lane_slab=2)
