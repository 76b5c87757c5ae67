"""PyTorch port, mode-compressed wind (``models.wind.WindModes``, the modes
route of ``engine/batch.py`` and the analyzer's ``wind_table_modes``)
against the JAX package on the CPU, float64.

Bars:
- the basis: ``wind_mode_basis`` is the same host NumPy in both packages, so
  it equals JAX's exactly; ``compress_wind``'s scores within 1e-12 of their
  scale (a product formed in another order), and at full rank the expanded
  scores give the table back within N x 1e-12 of it;
- the eager modes query (the plain version): every summary leaf lane for
  lane against JAX's ``simulate_summary_batch`` on the same compressed
  tables at rtol 1e-9 (16 lanes, 1.2 s window on a 500 m grid, K=16 and K=N, and K=16 with
  ``wind_table_bf16``, which rounds the scores and keeps the basis);
  ``n_steps`` exact;
- the card's route, the ``expanded`` tables flown by the plain version on
  the CPU, against the modes query at rtol 1e-12 (by linearity the same
  function, up to the order of rounding);
- the analyzer with ``wind_table_modes=8`` (the JAX sampler's lanes fed
  through ``_draw_single`` / ``_draw_slab`` / ``_draw_correction``), single
  call and two slabs, its summaries, metrics and two-level block against
  JAX's at rtol 1e-9 (the block's bias at rtol 1e-6, a difference of two
  legs); re-simulated lanes equal the run's summaries bit for bit (the
  compressed tables the run flew, not the realized ones: the JAX package
  re-simulates on realized tables, ROADMAP F2c), and so within 1e-9 of
  JAX's run.
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
from erpl_monte_carlo_sim_tpu.engine import simulate_summary_batch as jax_summary
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.mc import two_level as JTL
from erpl_monte_carlo_sim_tpu.models import WindField as JaxWindField
from erpl_monte_carlo_sim_tpu.models import compress_wind as jax_compress
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import wind_mode_basis as jax_basis
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.models import (WindField, WindModes, compress_wind,
                                                   expand_modes, liquid_motor, nominal_scene,
                                                   wind_mode_basis)
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy, to_numpy)

torch.set_num_threads(1)

# a 40-knot grid to 500 m: a short window's flight crosses knots where a
# truncated basis moves the table
KNOTS, TOP = 40, 500.0
WINDOW = 1.2
JSCENE, JIC = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
IC = InitialConditions.vertical_launch("cpu")
METRICS = ("apogee_altitude", "range", "flight_time")


def as_port(scene_b, ic_b, sample=None):
    out = (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"))
    return out if sample is None else out + (sample_from_numpy(sample, "cpu"),)


def close_summaries(got, ref, rtol):
    got, ref = to_numpy(got), ref
    for f in ("apogee_altitude", "apogee_time", "range", "flight_time", "max_speed",
              "landing_position", "final_velocity"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(ref, f)), rtol=rtol,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(got.n_steps, np.asarray(ref.n_steps))
    np.testing.assert_array_equal(got.parachute_deployed, np.asarray(ref.parachute_deployed))


@pytest.mark.parametrize("k,extra", [(1, None), (24, None), (KNOTS, None), (1, "forecast"),
                                     (2, "ensemble")])
def test_basis_is_jax(k, extra):
    grid = np.linspace(0.0, 25000.0, KNOTS)
    rng = np.random.default_rng(7)
    prof = None
    if extra == "forecast":
        prof = np.stack([5.0 * np.sin(grid / 4000.0) + 2.0,
                         rng.normal(size=KNOTS).cumsum() * 0.3, np.zeros(KNOTS)], axis=1)
    elif extra == "ensemble":
        prof = rng.normal(size=(2, KNOTS, 3)).cumsum(axis=1)
    scene = nominal_scene(liquid_motor("cpu"))
    got = wind_mode_basis(scene.wind_model, grid, k, extra_profiles=prof)
    ref = jax_basis(JSCENE.wind_model, grid, k, extra_profiles=prof)
    assert got.dtype == np.float64 and np.array_equal(got, ref)
    np.testing.assert_allclose(got.T @ got, np.eye(got.shape[1]), atol=1e-10)


def test_compress_wind_is_jax_and_refuses_a_shared_table():
    scene_b, _ = as_port(*jax_sample(jax.random.PRNGKey(0), JSCENE, JIC, n=8,
                                     wind_grid_points=KNOTS)[:2])
    q = wind_mode_basis(scene_b.wind_model, scene_b.wind.altitudes.numpy(), 16)
    got = compress_wind(scene_b.wind, q)
    ref = jax_compress(JaxWindField(altitudes=scene_b.wind.altitudes.numpy(),
                                    wind=scene_b.wind.wind.numpy()), q)
    scale = float(np.abs(np.asarray(ref.scores)).max())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=0,
                               atol=1e-12 * scale)
    assert torch.equal(got.basis, torch.as_tensor(q))
    # at full rank the expansion gives the table back
    full = compress_wind(scene_b.wind, wind_mode_basis(scene_b.wind_model,
                                                       scene_b.wind.altitudes.numpy(), KNOTS))
    np.testing.assert_allclose(expand_modes(full.basis, full.scores).numpy(),
                               scene_b.wind.wind.numpy(), rtol=0, atol=1e-12 * KNOTS * scale)
    with pytest.raises(ValueError, match="per-lane"):
        compress_wind(WindField.zero("cpu", torch.float64), np.eye(2))


MODES_CASES = {"k16": (16, {}), "full": (KNOTS, {}), "k16-bf16": (16, {"wind_table_bf16": True})}


@pytest.fixture(scope="module")
def modes_batch():
    scene_b, ic_b = jax_sample(jax.random.PRNGKey(3), JSCENE, JIC, n=16,
                               wind_grid_points=KNOTS, wind_grid_top=TOP)[:2]
    return scene_b, ic_b


def _compressed(modes_batch, k):
    scene_b, ic_b = modes_batch
    q = jax_basis(JSCENE.wind_model, np.asarray(scene_b.wind.altitudes), k)
    comp = scene_b.replace(wind=jax_compress(scene_b.wind, q))
    return comp, ic_b


@pytest.mark.parametrize("case", list(MODES_CASES))
def test_modes_summaries_are_jax(modes_batch, case):
    k, flags = MODES_CASES[case]
    comp, ic_b = _compressed(modes_batch, k)
    ref = jax_summary(comp, ic_b, JaxConfig(max_time=WINDOW, **flags))
    scene, ic = as_port(comp, ic_b)
    assert isinstance(scene.wind, WindModes)
    got = simulate_summary_batch(scene, ic, SimConfig(max_time=WINDOW, **flags))
    close_summaries(got, ref, 1e-9)
    if k < KNOTS:  # the truncation moved the flights
        table = simulate_summary_batch(*as_port(*modes_batch), SimConfig(max_time=WINDOW))
        assert not torch.equal(table.apogee_altitude, got.apogee_altitude)


@pytest.mark.parametrize("case", list(MODES_CASES))
def test_expanded_route_is_the_modes_query(modes_batch, case):
    """The card's route (``expanded``: scores rounded to bfloat16 first
    under ``wind_table_bf16``, which is then cleared) flown by the plain
    version, against the plain modes query."""
    k, flags = MODES_CASES[case]
    cfg = SimConfig(max_time=WINDOW, **flags)
    scene_nw, grid, modes, ics = prepare_batch(*as_port(*_compressed(modes_batch, k)))
    table, cfg_k = fs.expanded(modes, cfg)
    assert table.shape == (16, KNOTS, 3) and table.dtype == torch.float64
    assert not cfg_k.wind_table_bf16
    ref = fs.flight_summary_reference(scene_nw, grid, modes, ics, cfg)
    got = fs.flight_summary_reference(scene_nw, grid, table, ics, cfg_k)
    for key, v in ref.items():
        if v.is_floating_point():
            np.testing.assert_allclose(got[key].numpy(), v.numpy(), rtol=1e-12, atol=1e-9,
                                       err_msg=key)
        else:
            assert torch.equal(got[key], v), key
    # the expansion is each lane's own: a lane alone expands to the same bits
    one = fs.expanded(dataclasses.replace(modes, scores=modes.scores[5:6]), cfg)[0]
    assert torch.equal(one[0], table[5])


N, SEED, K = 32, 5, 8
CFG = dict(max_time=WINDOW)
MIN_APOGEE = 45.0


def jax_single(analyzer, ic, n, seed, base_wind):
    return as_port(*jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, n=n,
                               wind_grid_points=KNOTS, wind_grid_top=TOP))


def jax_slab(analyzer, ic, k, slab, seed, base_wind):
    return as_port(*jax_sample(jax.random.fold_in(jax.random.PRNGKey(seed), k), JSCENE, JIC,
                               n=slab, wind_grid_points=KNOTS, wind_grid_top=TOP))


def jax_correction(scene, ic, params, n, seed, base_wind, wind_grid_points, wind_grid_top):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), JTL._KEY_SALT)
    return as_port(*jax_sample(key, JSCENE, JIC, n=n, base_wind=base_wind,
                               wind_grid_points=wind_grid_points, wind_grid_top=wind_grid_top))


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's analyses with ``wind_table_modes``: a single call
    (with the two-level block, whose fast leg flies compressed) and two
    slabs, on the same lanes."""
    jmc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(**CFG), wind_table_modes=K,
                      two_level_lanes=N, bounds=JaxBounds(min_apogee=MIN_APOGEE),
                      wind_grid_points=KNOTS, wind_grid_top=TOP, persistent_cache=False)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(**CFG),
                            wind_table_modes=K, two_level_lanes=N,
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE), wind_grid_points=KNOTS,
                            wind_grid_top=TOP)
    out = {"single": [jmc.run_monte_carlo(JIC, n_samples=N, seed=SEED)],
           "slabbed": [jmc.run_monte_carlo(JIC, n_samples=2 * N, lane_slab=N, seed=SEED)]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(two_level_mod, "_draw_correction", jax_correction)
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        out["single"].append(mc.run_monte_carlo(IC, n_samples=N, seed=SEED))
        ids = [1, 7, 20, 31]
        out["single_resim"] = mc.resimulate_trajectories(ids)[0], ids
        out["single_lanes"] = mc.lane_scenes(ids)
        out["slabbed"].append(mc.run_monte_carlo(IC, n_samples=2 * N, lane_slab=N, seed=SEED))
        ids = [3, N - 1, N + 4, 2 * N - 2]
        out["slabbed_resim"] = mc.resimulate_trajectories(ids)[0], ids
    return out


def test_analyzer_single_call_is_jax(runs):
    ref, got = runs["single"]
    close_summaries(got["summary"], ref["summary"], 1e-9)
    assert got["n_samples"] == ref["n_samples"] and 0 < got["n_samples"] < N
    for m in METRICS:
        for s in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(got[m][s], ref[m][s], rtol=1e-9, err_msg=f"{m}.{s}")


def test_analyzer_slabbed_is_jax(runs):
    ref, got = runs["slabbed"]
    for m in METRICS:
        np.testing.assert_allclose(got["metrics"][m], ref["metrics"][m], rtol=1e-9, err_msg=m)
    np.testing.assert_array_equal(got["valid_mask"], ref["valid_mask"])
    assert got["n_samples"] == ref["n_samples"]


def test_two_level_fast_leg_flies_compressed(runs):
    ref, got = (r["two_level"] for r in runs["single"])
    assert got["config_delta"] == ref["config_delta"] == {}
    for k in ("n_lanes", "n_coupled", "mismatched_validity"):
        assert got[k] == ref[k], k
    for m in METRICS:
        for k in ("bias", "bias_stderr", "abs_max_delta"):
            np.testing.assert_allclose(got[m][k], ref[m][k], rtol=1e-6, atol=1e-12,
                                       err_msg=f"{m}.{k}")
        for k in ("population_sigma", "corrected_mean"):
            np.testing.assert_allclose(got[m][k], ref[m][k], rtol=1e-9, err_msg=f"{m}.{k}")
    # a K=8 truncation moves lanes: the fast leg did not fly realized tables
    assert got["apogee_altitude"]["abs_max_delta"] > 0.0


@pytest.mark.parametrize("layout", ["single", "slabbed"])
def test_resimulation_flies_the_compressed_tables(runs, layout):
    summary, ids = runs[f"{layout}_resim"]
    ref, got = runs[layout]
    if layout == "single":
        run_metrics = {m: getattr(got["summary"], m) for m in METRICS}
        jax_metrics = {m: np.asarray(getattr(ref["summary"], m)) for m in METRICS}
    else:
        run_metrics, jax_metrics = got["metrics"], ref["metrics"]
    for m in METRICS:
        np.testing.assert_array_equal(getattr(summary, m).numpy(), run_metrics[m][ids],
                                      err_msg=m)
        np.testing.assert_allclose(getattr(summary, m).numpy(), jax_metrics[m][ids],
                                   rtol=1e-9, err_msg=m)


def test_lane_scenes_keep_the_realized_tables(runs):
    scenes = runs["single_lanes"]
    scene_b, _ = jax_single(None, None, N, SEED, None)[:2]
    for lane, i in zip(scenes, [1, 7, 20, 31]):
        assert isinstance(lane.wind, WindField)
        assert torch.equal(lane.wind.wind, scene_b.wind.wind[i])


def test_analyzer_checks_are_jax():
    with pytest.raises(ValueError) as ref:
        JaxAnalyzer(scene=JSCENE, wind_table_modes=0, persistent_cache=False)
    with pytest.raises(ValueError) as got:
        MonteCarloAnalyzer(motor=liquid_motor("cpu"), wind_table_modes=0)
    assert str(got.value) == str(ref.value)
    # modes alone are a fast path for the two-level correction
    MonteCarloAnalyzer(motor=liquid_motor("cpu"), wind_table_modes=8, two_level_lanes=4)
