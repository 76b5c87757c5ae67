"""PyTorch port, the two-level bias correction (``mc/two_level.py`` and the
analyzer's ``two_level`` block) against the JAX package on the CPU, float64.

``parity_twin`` resets the same fields. The analyzer's ``two_level_block``
flies the JAX package's correction lanes (``fold_in(PRNGKey(seed),
0x2B1A5C0)``, fed through the port's ``_draw_correction`` seam) under
``integrator="rk2"`` and its RK4 twin on a 1.2 s window (64 lanes, the
outlier bound near the median apogee), held to JAX's ``two_level_block``:
counts exact; the bias, its stderr and the largest delta at rtol 1e-6 (each
a difference of two legs that agree with JAX's to about 1e-12 of their
size, and rk2's apogee bias is about 2e-6 m), the parity spread at rtol
1e-9. The analyzer's block, single call and two slabs (the main lanes fed
through ``_draw_single`` / ``_draw_slab``), adds the corrected means and
stderrs at rtol 1e-9. The constructor's checks raise JAX's messages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
import erpl_monte_carlo_sim_tpu_torch.mc.two_level as two_level_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.mc import two_level as JTL
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.mc import two_level as TTL
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)

torch.set_num_threads(1)

N, SEED, KNOTS = 64, 4, 10
WINDOW = 1.2
MIN_APOGEE = 45.0
FAST = dict(max_time=WINDOW, integrator="rk2")
JSCENE, JIC = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
IC = InitialConditions.vertical_launch("cpu")
METRICS = ("apogee_altitude", "range", "flight_time")


def as_port(scene_b, ic_b, sample):
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def jax_correction(scene, ic, params, n, seed, base_wind, wind_grid_points, wind_grid_top):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), JTL._KEY_SALT)
    return as_port(*jax_sample(key, JSCENE, JIC, n=n, base_wind=base_wind,
                               wind_grid_points=wind_grid_points, wind_grid_top=wind_grid_top))


def jax_single(analyzer, ic, n, seed, base_wind):
    return as_port(*jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, n=n,
                               wind_grid_points=KNOTS))


def jax_slab(analyzer, ic, k, slab, seed, base_wind):
    return as_port(*jax_sample(jax.random.fold_in(jax.random.PRNGKey(seed), k), JSCENE, JIC,
                               n=slab, wind_grid_points=KNOTS))


@pytest.mark.parametrize("cfg", [
    dict(integrator="rk2", max_time=3.0), dict(descent_dt_scale=16, ascent_q_threshold=8000.0,
                                               energy_consistent_aero=True),
    dict(wind_eval_per_step=True, wind_table_bf16=True, speed_guard=50.0), {}],
    ids=["rk2", "full_flights", "wind", "parity"])
def test_parity_twin_matches_jax(cfg):
    assert TTL.FAST_FIELDS == JTL.FAST_FIELDS and TTL.METRICS == JTL.METRICS
    assert TTL.CORRECTION_SLAB == JTL._KEY_SALT
    got, ref = TTL.parity_twin(SimConfig(**cfg)), JTL.parity_twin(JaxConfig(**cfg))
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} == \
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(got)}
    assert (got == SimConfig(**cfg)) == (not cfg.keys() & set(TTL.FAST_FIELDS))


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's block, and the analyzers' single-call and
    slabbed analyses, on the same lanes."""
    bounds, jbounds = OutlierBounds(min_apogee=MIN_APOGEE), JaxBounds(min_apogee=MIN_APOGEE)
    ref_block = JTL.two_level_block(JSCENE, JIC, JaxConfig(**FAST), N, jax.random.PRNGKey(SEED),
                                    bounds=jbounds, wind_grid_points=KNOTS)
    jmc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(**FAST), bounds=jbounds,
                      persistent_cache=False, two_level_lanes=N, wind_grid_points=KNOTS)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(**FAST),
                            bounds=bounds, two_level_lanes=N, wind_grid_points=KNOTS)
    out = {"single": [jmc.run_monte_carlo(JIC, n_samples=N, seed=SEED)],
           "slabbed": [jmc.run_monte_carlo(JIC, n_samples=2 * N, lane_slab=N, seed=SEED)]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(two_level_mod, "_draw_correction", jax_correction)
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        out["single"].append(mc.run_monte_carlo(IC, n_samples=N, seed=SEED))
        out["slabbed"].append(mc.run_monte_carlo(IC, n_samples=2 * N, lane_slab=N, seed=SEED))
    # the analyzer's block is two_level_block's on the fed lanes, plus the
    # corrected means
    block = {k: v for k, v in out["single"][1]["two_level"].items() if k != "stderr_note"}
    for m in METRICS:
        block[m] = {k: v for k, v in block[m].items() if not k.startswith("corrected")}
    out["block"] = (ref_block, block)
    return out


def same_block(got, ref):
    for k in ("n_lanes", "n_coupled", "mismatched_validity", "config_delta"):
        assert got[k] == ref[k], k
    assert 0 < got["n_coupled"] < got["n_lanes"]
    assert got["wall_s_legs"].keys() == ref["wall_s_legs"].keys() == {"fast", "parity"}
    for m in METRICS:
        assert got[m].keys() == ref[m].keys()
        np.testing.assert_allclose(got[m]["population_sigma"], ref[m]["population_sigma"],
                                   rtol=1e-9, err_msg=m)
        for k in ("bias", "bias_stderr", "abs_max_delta"):
            np.testing.assert_allclose(got[m][k], ref[m][k], rtol=1e-6, atol=1e-12,
                                       err_msg=f"{m}.{k}")
    assert abs(got["apogee_altitude"]["bias"]) > 0.0  # the window fixes the flight time


def test_two_level_block_matches_jax(runs):
    ref, got = runs["block"]
    same_block(got, ref)
    assert got["config_delta"] == {"integrator": ["rk2", "rk4"]}
    # rk2's apogee bias is resolved: far above its stderr
    assert abs(got["apogee_altitude"]["bias"]) > 4 * got["apogee_altitude"]["bias_stderr"]


@pytest.mark.parametrize("layout", ["single", "slabbed"])
def test_analyzer_two_level_block_matches_jax(runs, layout):
    ref, got = runs[layout]
    same_block(got["two_level"], ref["two_level"])
    assert "stderr_note" not in got["two_level"]
    for m in METRICS:
        blk, rblk = got["two_level"][m], ref["two_level"][m]
        for k in ("corrected_mean", "corrected_stderr"):
            np.testing.assert_allclose(blk[k], rblk[k], rtol=1e-9, err_msg=f"{m}.{k}")
        np.testing.assert_allclose(blk["corrected_mean"] - got[m]["mean"], blk["bias"],
                                   rtol=1e-6)


def test_two_level_on_non_iid_lanes_drops_the_stderr():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.3,
                                                                            integrator="rk2"),
                            antithetic=True, two_level_lanes=4, wind_grid_points=KNOTS)
    blk = mc.run_monte_carlo(IC, n_samples=8, seed=0)["two_level"]
    assert "antithetic=True" in blk["stderr_note"]
    assert all(blk[m]["corrected_stderr"] is None for m in METRICS)
    # a fast_transform alone makes a parity config a fast path: the identity
    # transform measures no bias
    ident = TTL.two_level_block(mc.scene, IC, SimConfig(max_time=0.3), 4,
                                bounds=OutlierBounds(min_apogee=5.0),
                                fast_transform=lambda s: s)
    assert ident["config_delta"] == {} and ident["n_coupled"] == 4
    assert all(ident[m]["abs_max_delta"] == 0.0 for m in METRICS)
    with pytest.raises(ValueError, match="already exact parity"):
        TTL.two_level_block(mc.scene, IC, SimConfig(), 4)


@pytest.mark.parametrize("kw", [
    {"two_level_lanes": -1}, {"two_level_lanes": 8},
    {"two_level_lanes": 8, "sim_config": "rk2", "importance_shift": {"mass": 1.0}},
    {"cv_wind_modes": -1}, {"cv_wind_modes": 2}, {"cv_wind_speed": -1},
    {"cv_wind_speed": 3}, {"control_variates": True, "importance_shift": {"mass": 1.0}},
], ids=["lanes<0", "parity", "importance", "modes<0", "modes-no-cv", "speed<0",
        "speed-no-cv", "cv-importance"])
def test_constructor_checks_match_jax(kw):
    kw = dict(kw)
    rk2 = kw.pop("sim_config", None) == "rk2"
    with pytest.raises(ValueError) as ref:
        JaxAnalyzer(scene=JSCENE, persistent_cache=False,
                    sim_config=JaxConfig(integrator="rk2") if rk2 else JaxConfig(), **kw)
    with pytest.raises(ValueError) as got:
        MonteCarloAnalyzer(motor=liquid_motor("cpu"),
                           sim_config=SimConfig(integrator="rk2") if rk2 else SimConfig(), **kw)
    assert str(got.value) == str(ref.value)


def test_correction_batch_is_the_jax_key():
    """The correction batch's lanes are the JAX package's: drawn under
    ``fold_in(PRNGKey(seed), _KEY_SALT)``."""
    assert TTL.CORRECTION_SLAB == JTL._KEY_SALT
    scene = liquid_motor("cpu")
    from erpl_monte_carlo_sim_tpu_torch.models import nominal_scene

    _, _, got = TTL._draw_correction(nominal_scene(scene), IC, TTL.UncertaintyParams(), 8, 4,
                                     None, 100, 25000.0)
    _, _, want = jax_sample(jax.random.fold_in(jax.random.PRNGKey(4), JTL._KEY_SALT),
                            jax_nominal(jax_liquid()), JaxIC.vertical_launch(), n=8)
    np.testing.assert_array_equal(got.wind_speed.numpy(), np.asarray(want.wind_speed))
    for f in ("initial_attitude_offset", "mass_multiplier", "density_multiplier"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-12, err_msg=f)
