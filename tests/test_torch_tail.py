"""PyTorch port, the tail estimators (``mc/tail.py``'s GPD fits,
``mc/importance.py``'s ``weighted_tail`` and ``shift_from_gradients``, the
importance branch of ``mc/stats.py``'s ``exceedance_from_analysis``)
against the JAX package on the CPU.

These are host NumPy in both packages, so on the same inputs the results
are JAX's exactly: the fits, the counted and extrapolated rows, and the
bootstrap intervals (the same ``default_rng(seed)`` draws in the same
order), and each check's message. ``tail_from_analysis`` reads every layout
of a port run (one call, slabs, a streaming run's ``tail_reservoirs``; 64
lanes of the liquid motor on a 1.0 s window, float64) as JAX's reads the
same dict. The ``tail_probability`` CLI is tests/test_torch_tail_probability.py's.
"""

import importlib

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.mc import exceedance_from_analysis as jax_exceedance
from erpl_monte_carlo_sim_tpu.mc import importance as JI
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import (MonteCarloAnalyzer, OutlierBounds,
                                               exceedance_from_analysis)
from erpl_monte_carlo_sim_tpu_torch.mc import importance as TI
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

JT = importlib.import_module("erpl_monte_carlo_sim_tpu.mc.tail")
TT = importlib.import_module("erpl_monte_carlo_sim_tpu_torch.mc.tail")

torch.set_num_threads(1)

IC = InitialConditions.vertical_launch("cpu")
WINDOW, BOUNDS = SimConfig(max_time=1.0), OutlierBounds(min_apogee=34.0)


def gpd_sample(xi, sigma, n, seed):
    u = np.random.default_rng(seed).random(n)
    return sigma * np.log1p(-u) * -1.0 if xi == 0 else sigma / xi * ((1 - u) ** -xi - 1.0)


def same(got, ref, path="r"):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            same(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and np.isnan(ref):
        assert np.isnan(got), path
    else:
        assert got == ref, (path, got, ref)


@pytest.mark.parametrize("xi", [0.25, 0.0, -0.3], ids=["heavy", "exponential", "bounded"])
def test_gpd_fit_and_tail_are_jax(xi):
    y = gpd_sample(xi, 2.0, 3000, 1)
    got = TT.fit_gpd_pwm(y)
    assert got == JT.fit_gpd_pwm(y)
    assert abs(got[0] - xi) < 0.1 and abs(got[1] / 2.0 - 1) < 0.1
    values = 100.0 + gpd_sample(xi, 2.0, 2000, 2)
    thresholds = [100.0, 104.0, float(np.max(values)) + 1.0, float(np.max(values)) + 5.0]
    for side, ts in (("upper", thresholds), ("lower", [100.5, 100.01, 99.0])):
        kw = dict(side=side, n_tail=200, n_boot=60, seed=3)
        same(TT.gpd_tail(values, 5000, ts, **kw), JT.gpd_tail(values, 5000, ts, **kw))
    same(TT.gpd_tail(values, 2000, thresholds, n_boot=0),
         JT.gpd_tail(values, 2000, thresholds, n_boot=0))
    x = np.linspace(0.0, 10.0, 7)
    np.testing.assert_array_equal(TT._gpd_sf(x, xi, 2.0), JT._gpd_sf(x, xi, 2.0))


@pytest.mark.parametrize("call", [
    lambda m: m.fit_gpd_pwm(np.ones(5)), lambda m: m.fit_gpd_pwm(np.ones(20)),
    lambda m: m.fit_gpd_pwm(np.r_[np.zeros(19), 5.0]),
    lambda m: m.gpd_tail(np.arange(50.0), 40, [1.0]),
    lambda m: m.gpd_tail(np.arange(50.0), 100, [1.0], side="both"),
    lambda m: m.gpd_tail(np.arange(8.0), 100, [1.0]),
    lambda m: m.tail_from_analysis({"importance": {"x": 1}}, "range", [1.0]),
], ids=["few", "constant", "tied", "n_total", "side", "n_tail", "importance"])
def test_tail_checks_are_jax(call):
    with pytest.raises(ValueError) as ref:
        call(JT)
    with pytest.raises(ValueError) as got:
        call(TT)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def runs():
    """Port runs of the liquid motor on a 1.0 s window, the outlier bound near
    the median apogee: one call, 2 slabs, and 2 slabs streaming past 40
    lanes with a 24-lane prefix."""
    kw = dict(motor=liquid_motor("cpu"), sim_config=WINDOW, bounds=BOUNDS)
    one = MonteCarloAnalyzer(**kw)
    stream = MonteCarloAnalyzer(**kw, stats_stream_threshold=40, metrics_sample_cap=24)
    return {"single": one.run_monte_carlo(IC, n_samples=64, seed=1),
            "slabbed": one.run_monte_carlo(IC, n_samples=64, lane_slab=32, seed=1),
            "streaming": stream.run_monte_carlo(IC, n_samples=64, lane_slab=32, seed=1)}


@pytest.mark.parametrize("layout", ["single", "slabbed", "streaming"])
def test_tail_from_analysis_is_jax(runs, layout):
    a = runs[layout]
    assert bool(a.get("metrics_is_sample")) == (layout == "streaming")
    if layout == "streaming":
        assert a["tail_reservoirs"]["apogee_altitude"].n == a["n_samples"]
    mean = a["apogee_altitude"]["mean"]
    for side in ("upper", "lower"):
        ts = [mean, a["apogee_altitude"]["max"] + 2.0, a["apogee_altitude"]["min"] - 2.0]
        kw = dict(side=side, n_tail=12, n_boot=40, seed=5)
        got = TT.tail_from_analysis(a, "apogee_altitude", ts, **kw)
        same(got, JT.tail_from_analysis(a, "apogee_altitude", ts, **kw))
        assert got["fit"]["n_total"] == a["n_samples"]
    with pytest.raises(KeyError):
        TT.tail_from_analysis(a, "no_such_metric", [1.0])


def test_weighted_tail_is_jax():
    rng = np.random.default_rng(4)
    n = 3000
    values = rng.normal(100.0, 5.0, n)
    values[5] = np.nan
    mask = rng.random(n) > 0.05
    lw = rng.normal(0.0, 0.7, n)
    ts = [90.0, 110.0, 115.0, 200.0]
    got = TI.weighted_tail(values, mask, lw, ts)
    same(got, JI.weighted_tail(values, mask, lw, ts))
    assert got[-1]["probability"] == 0.0 and np.isnan(got[-1]["stderr"])
    same(TI.weighted_tail(values, np.zeros(n, bool), lw, ts),
         JI.weighted_tail(values, np.zeros(n, bool), lw, ts))


@pytest.mark.parametrize("grads,sigmas,threshold", [
    ({"mass": -300.0, "motor_thrust": 900.0, "motor_flow": 10.0, "density": -50.0},
     {"mass": 0.02, "motor_thrust": 0.03, "motor_flow": 0.0, "density": 0.05}, 1100.0),
    ({"mass": -300.0, "motor_thrust": 900.0}, {"mass": 0.02, "motor_thrust": 0.03}, 950.0),
], ids=["all", "two"])
def test_shift_from_gradients_is_jax(grads, sigmas, threshold):
    got = TI.shift_from_gradients(1000.0, grads, sigmas, threshold)
    assert got == JI.shift_from_gradients(1000.0, grads, sigmas, threshold)
    assert "motor_flow" not in got[0]
    assert np.sign(got[0]["motor_thrust"]) == np.sign(threshold - 1000.0)


@pytest.mark.parametrize("args", [
    (float("nan"), {"mass": 1.0}, {"mass": 0.1}, 2.0),
    (1.0, {"mass": float("inf")}, {"mass": 0.1}, 2.0),
    (1.0, {"mass": 1.0}, {"mass": 0.0}, 2.0),
], ids=["value", "gradient", "no-response"])
def test_shift_checks_are_jax(args):
    with pytest.raises(ValueError) as ref:
        JI.shift_from_gradients(*args)
    with pytest.raises(ValueError) as got:
        TI.shift_from_gradients(*args)
    assert str(got.value) == str(ref.value)


def test_importance_exceedance_is_jax():
    """An importance run's exceedance goes through the weights, in every
    layout the run can have: the port's own run, and its per-lane arrays as
    a slabbed run would hold them."""
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=WINDOW, bounds=BOUNDS,
                            importance_shift={"motor_thrust": 1.5})
    a = mc.run_monte_carlo(IC, n_samples=64, seed=2)
    ts = [a["apogee_altitude"]["mean"], a["apogee_altitude"]["max"] - 1.0, 1e6]
    got = exceedance_from_analysis(a, "apogee_altitude", ts)
    same(got, jax_exceedance(a, "apogee_altitude", ts))
    assert [r["method"] for r in got] == ["importance"] * 3
    slabbed = {"summary": None, "importance": a["importance"], "valid_mask": a["valid_mask"],
               "metrics": {"range": a["summary"].range}}
    same(exceedance_from_analysis(slabbed, "range", [1.0]),
         jax_exceedance(slabbed, "range", [1.0]))
    with pytest.raises(KeyError):
        exceedance_from_analysis(slabbed, "flight_time", [1.0])
