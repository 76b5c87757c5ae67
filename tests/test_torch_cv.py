"""PyTorch port, the control variates (``mc/cv.py`` and the analyzer's
``control_variates`` block) against the JAX package on the CPU, float64.

The host helpers (``control_names``, the turbulence-mode projector, the
Rice and quadrature means of the wind-speed controls and their leaves) equal
JAX's to 1e-12. ``cv_slab_moments`` takes JAX-drawn lanes (10-knot grid, a
forecast's wind) with made-up summaries that hold invalid,
non-finite and padding lanes; its moments equal JAX's to 1e-12 relative to
each matrix's scale. ``CVMoments`` merges slabs into the whole's moments and
``finalize_cv`` solves as JAX does. The analyzer's block runs on the same
lanes in both packages (the JAX draws fed through ``_draw_single`` /
``_draw_slab``; 256 lanes on a 1.2 s window, the outlier bound near the
median apogee so the ratio form matters): single call, two slabs, and two
slabs killed after the first and resumed: means, stderrs and variance
reductions at rtol 1e-9, the fitted ``beta`` (the solve of 50 controls on 256
lanes amplifies the flights' last digits) at 1e-5 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from chip_smoke import same_analysis
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import cv as JCV
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.mc import cv as TCV
from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import UncertaintyParams
from erpl_monte_carlo_sim_tpu_torch.models import (WindModelParams, liquid_motor, nominal_scene,
                                                   solid_motor)
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)

torch.set_num_threads(1)

N, SEED, KNOTS = 256, 3, 10
GRID = np.linspace(0.0, 25000.0, KNOTS)
FORECAST = np.cumsum(np.random.default_rng(5).normal(size=(KNOTS, 3)), axis=0)
WINDOW = 1.2
MIN_APOGEE = 45.0  # near the window's median apogee
CV = {"control_variates": True, "cv_wind_modes": 2, "cv_wind_speed": 3}
JSCENE, JIC = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
RTOL = 1e-9


def rel_close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-300) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("params,solid,modes,alts", [
    (UncertaintyParams(), False, 0, ()),
    (UncertaintyParams(initial_position=(1.0, 0.0, 2.0), wind_speed_range=(3.0, 3.0)),
     True, 4, (0.0, 12500.0, 25000.0)),
    (UncertaintyParams(wind_direction_range=(1.0, 1.0)), False, 1, (100.0, 100.4, 101.0)),
], ids=["default", "solid-pos-calm-range", "fixed-direction"])
def test_control_names_match_jax(params, solid, modes, alts):
    motor, jmotor = (solid_motor("cpu"), jax_solid()) if solid else (liquid_motor("cpu"),
                                                                      jax_liquid())
    assert TCV.control_names(params, motor, modes, alts) == \
        JCV.control_names(params, jmotor, modes, alts)


@pytest.mark.parametrize("base", [None, FORECAST], ids=["synthesized", "forecast"])
def test_wind_controls_host_side_match_jax(base):
    from erpl_monte_carlo_sim_tpu.models import WindModelParams as JaxWind

    model, jmodel = WindModelParams.create("cpu", torch.float64), JaxWind()
    proj = TCV.wind_mode_projector(model, GRID, 3)
    ref = JCV.wind_mode_projector(jmodel, GRID, 3)
    rel_close(proj, ref, 1e-12, "projector")
    assert TCV.wind_mode_projector(model, GRID, 50).shape == (KNOTS, KNOTS)  # clamps
    np.testing.assert_array_equal(TCV.wind_speed_knots(KNOTS, 4), JCV.wind_speed_knots(KNOTS, 4))
    np.testing.assert_array_equal(TCV.wind_speed_knots(3, 8), JCV.wind_speed_knots(3, 8))
    rel_close(TCV._rice_mean(np.linspace(0.0, 30.0, 7), 1.7),
              JCV._rice_mean(np.linspace(0.0, 30.0, 7), 1.7), 1e-12, "rice")
    idx = TCV.wind_speed_knots(KNOTS, 4)
    for got, want, what in zip(
            TCV.wind_speed_control_means(UncertaintyParams(), model, GRID, idx, base=base),
            JCV.wind_speed_control_means(UncertaintyParams(), jmodel, GRID, idx, base=base),
            ("e_spd", "e_energy", "sigma")):
        rel_close(got, want, 1e-12, what)
    leaves, kept = TCV.wind_speed_ctrl_leaves(UncertaintyParams(), model, GRID, 4, base=base,
                                              dtype=torch.float64)
    jleaves, jkept = JCV.wind_speed_ctrl_leaves(UncertaintyParams(), jmodel, GRID, 4, base=base,
                                                dtype=jnp.float64)
    np.testing.assert_array_equal(kept, jkept)
    for k, v in jleaves.items():
        rel_close(leaves[k].numpy(), np.asarray(v), 1e-12, k)


def port(x):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}


def made_up_summary(n, rng):
    """Summaries with invalid lanes, NaN and infinite metrics, for both
    packages: ``(jax namedtuple, port namespace, valid)``."""
    import collections
    import types

    s = {"apogee_altitude": rng.normal(60.0, 5.0, n), "range": rng.normal(3.0, 1.0, n),
         "flight_time": rng.normal(1.2, 0.01, n), "landing_position": rng.normal(size=(n, 3))}
    s["apogee_altitude"][3] = np.nan
    s["range"][7] = np.inf
    s["landing_position"][11, 1] = np.nan
    valid = rng.random(n) > 0.3
    J = collections.namedtuple("J", list(s))
    return (J(**{k: jnp.asarray(v) for k, v in s.items()}),
            types.SimpleNamespace(**port(s)), valid)


def test_cv_slab_moments_match_jax():
    """A forecast's wind controls (the analyzer's runs below hold the
    synthesized ones), with invalid, non-finite and padding lanes."""
    base_wind = (GRID, FORECAST)
    n = 96
    scene_b, _, sample = jax_sample(jax.random.PRNGKey(SEED), JSCENE, JIC, n=n,
                                    base_wind=base_wind, wind_grid_points=KNOTS)
    tscene_b, tsample = scene_from_numpy(scene_b, "cpu"), sample_from_numpy(sample, "cpu")
    jsum, tsum, valid = made_up_summary(n, np.random.default_rng(1))
    include = np.arange(n) < n - 9  # a ragged slab's padding lanes
    jmc = JaxAnalyzer(scene=JSCENE, persistent_cache=False, wind_grid_points=KNOTS, **CV)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), wind_grid_points=KNOTS, **CV)
    ref = jax.device_get(JCV.cv_slab_moments(
        sample, jsum, jnp.asarray(valid), jnp.asarray(include), jmc.uncertainty_params,
        JSCENE.motor, jmc._cv_wind_ctrl(scene_b, sample, base_wind)))
    got = TCV.cv_slab_moments(
        tsample, tsum, torch.as_tensor(valid), torch.as_tensor(include), mc.uncertainty_params,
        mc.scene.motor, mc._cv_wind_ctrl(tscene_b, tsample, base_wind))
    assert int(got[0]) == int(ref[0]) == n - 9
    for name, a, b in zip(("mz", "mt", "szz", "szt", "stt"), got[1:], ref[1:]):
        assert a.shape == np.shape(b) and np.all(np.isfinite(a)), name
        rel_close(a, b, 1e-12, name)
    assert mc._cv_names() == jmc._cv_names()
    assert len(mc._cv_names()) == got[1].size


def test_cv_moments_merge_and_finalize_match_jax():
    """Slab moments merged (Chan) equal one slab of all the lanes; the port
    and JAX merges and solves agree, the short run takes the plain path."""
    rng = np.random.default_rng(2)
    n, d = 600, 5
    z = rng.normal(size=(n, d))
    t = np.stack([z @ rng.normal(size=d) + rng.normal(size=n) for _ in range(5)]
                 + [np.ones(n)], axis=1)

    def moments(zs, ts):
        mz, mt = zs.mean(0), ts.mean(0)
        zc, tc = zs - mz, ts - mt
        return len(zs), mz, mt, zc.T @ zc, zc.T @ tc, tc.T @ tc

    whole = TCV.CVMoments()
    whole.add(moments(z, t))
    merged, jmerged = TCV.CVMoments(), JCV.CVMoments()
    for part in np.split(np.arange(n), [100, 350, 351]):
        merged.add(moments(z[part], t[part]))
        jmerged.add(moments(z[part], t[part]))
    merged.add((0, *moments(z, t)[1:]))  # an empty slab changes nothing
    assert merged.n == whole.n == n
    for k in ("mz", "mt", "szz", "szt", "stt"):
        rel_close(getattr(merged, k), getattr(whole, k), 1e-12, k)
        np.testing.assert_array_equal(getattr(merged, k), getattr(jmerged, k))
    names = [f"c{i}" for i in range(d)]
    got, ref = TCV.finalize_cv(merged, names), JCV.finalize_cv(jmerged, names)
    assert got == ref
    assert got["apogee_altitude"]["variance_reduction"] > 2.0
    short = TCV.CVMoments()
    short.add(moments(z[:12], t[:12]))
    jshort = JCV.CVMoments()
    jshort.add(moments(z[:12], t[:12]))
    assert TCV.finalize_cv(short, names) == JCV.finalize_cv(jshort, names)
    assert TCV.finalize_cv(short, names)["insufficient_samples"]
    assert TCV.finalize_cv(TCV.CVMoments(), names) == {"n": 0, "controls": names}


def jax_single(analyzer, ic, n, seed, base_wind):
    scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, n=n,
                                       base_wind=base_wind, wind_grid_points=KNOTS)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def jax_slab(analyzer, ic, k, slab, seed, base_wind):
    scene_b, ic_b, sample = jax_sample(jax.random.fold_in(jax.random.PRNGKey(seed), k),
                                       JSCENE, JIC, n=slab, base_wind=base_wind,
                                       wind_grid_points=KNOTS)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def analyzers():
    ref = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW),
                      bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False,
                      wind_grid_points=KNOTS, **CV)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE),
                            wind_grid_points=KNOTS, **CV)
    return ref, mc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's analyses on the same lanes: one call of N, and N
    * 2 in slabs of N, the port's also killed after a slab and resumed."""
    ref_mc, mc = analyzers()
    ic = InitialConditions.vertical_launch("cpu")
    out = {"single": (ref_mc.run_monte_carlo(JIC, n_samples=N, seed=SEED), None),
           "slabbed": (ref_mc.run_monte_carlo(JIC, n_samples=2 * N, lane_slab=N, seed=SEED),
                       None)}
    ckpt = str(tmp_path_factory.mktemp("cv") / "run.ckpt.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        out["single"] = (out["single"][0], mc.run_monte_carlo(ic, n_samples=N, seed=SEED))
        out["single_scene"] = mc._last_batch[0]
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        slabbed = mc.run_monte_carlo(ic, n_samples=2 * N, lane_slab=N, seed=SEED)
        out["slabbed"] = (out["slabbed"][0], slabbed)

        def dying(*a, **kw):
            if a[2] == 1:
                raise RuntimeError("simulated crash")
            return jax_slab(*a, **kw)

        mp.setattr(analyzer_mod, "_draw_slab", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            analyzers()[1].run_monte_carlo(ic, n_samples=2 * N, lane_slab=N, seed=SEED,
                                           checkpoint_path=ckpt, checkpoint_every=1)
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        resumed = analyzers()[1].run_monte_carlo(ic, n_samples=2 * N, lane_slab=N, seed=SEED,
                                                 checkpoint_path=ckpt, checkpoint_every=1)
    same_analysis(resumed, slabbed)
    out["resumed"] = (out["slabbed"][0], resumed)
    return out


@pytest.mark.parametrize("layout", ["single", "slabbed", "resumed"])
def test_analyzer_cv_block_matches_jax(runs, layout):
    ref, got = runs[layout]
    cv, rcv = got["control_variates"], ref["control_variates"]
    assert 0 < got["n_samples"] < got.get("n_total", N)  # both kinds of lane
    assert cv["controls"] == rcv["controls"] and cv["kept_controls"] == rcv["kept_controls"]
    assert cv["n"] == rcv["n"] and "insufficient_samples" not in cv
    np.testing.assert_allclose(cv["n_per_control"], rcv["n_per_control"], rtol=1e-12)
    for m in ("apogee_altitude", "range", "flight_time", "landing_x", "landing_y"):
        for k in ("mean", "stderr", "plain_mean", "plain_stderr", "variance_reduction"):
            np.testing.assert_allclose(cv[m][k], rcv[m][k], rtol=RTOL, err_msg=f"{m}.{k}")
        assert cv[m]["beta"].keys() == rcv[m]["beta"].keys()
        # beta solves a 50-control system on 256 lanes: the flights' last
        # digits come back amplified by its conditioning
        rel_close(list(cv[m]["beta"].values()), list(rcv[m]["beta"].values()), 1e-5, m)
    # the plain mean is the valid lanes' mean; the adjusted one moved off it
    np.testing.assert_allclose(cv["apogee_altitude"]["plain_mean"],
                               got["apogee_altitude"]["mean"], rtol=1e-12)
    assert cv["apogee_altitude"]["variance_reduction"] > 1.0


def test_ratio_form_is_not_the_valid_lanes_regression(runs):
    """The adjusted mean is the ratio of two adjusted means over all lanes;
    a regression over the valid lanes alone gives another number, far
    outside the bar the block is held to."""
    ref, got = runs["single"]
    summary, valid = got["summary"], got["valid_mask"]
    mc = analyzers()[1]
    wind = runs["single_scene"]
    sample = sample_from_numpy(got["sample"], "cpu")
    z = TCV._controls(sample, mc.uncertainty_params, mc.scene.motor,
                      mc._cv_wind_ctrl(wind, sample, None)).numpy()[valid]
    y = summary.apogee_altitude[valid]
    zc = z - z.mean(0)
    beta = np.linalg.lstsq(zc, y - y.mean(), rcond=None)[0]
    naive = y.mean() - beta @ z.mean(0)
    ratio = got["control_variates"]["apogee_altitude"]["mean"]
    assert abs(naive - ratio) > 1e-4 * abs(ratio)
    np.testing.assert_allclose(ratio, ref["control_variates"]["apogee_altitude"]["mean"],
                               rtol=RTOL)
