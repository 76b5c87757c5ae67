"""PyTorch port, subset simulation (``mc/subset.py``, ``mc/subset_driver.py``)
and ``sample_from_normals`` against the JAX package on the CPU, float64.

On analytic ``g`` (a linear limit state with a known tail, a bounded one
that stalls, one with non-finite values) ``subset_simulation``,
``subset_quantile`` and both ``pool_*`` give JAX's result dicts exactly:
the same ``np.random.default_rng`` draws in the same order. The
``sample_from_normals`` leaves equal JAX's to 1e-12 (10-knot grid,
synthesized and forecast wind), and its checks raise JAX's messages.
``subset_tail`` through the analyzer flies the same chains in both packages,
as the ``tail_probability --subset`` CLI drives it (the solid motor's 1.4 s
window, 16 lanes a level, p0 = 0.5): the analyzer's result dict and the
CLI's JSON with counts and levels exact, every number at rtol 1e-9 (the
lanes' metrics agree to about 1e-12 of their size, far from every level's
threshold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import dispersions as JD
from erpl_monte_carlo_sim_tpu.mc import subset as JS
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.mc import dispersions as TD
from erpl_monte_carlo_sim_tpu_torch.mc import subset as TS
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from test_torch_mc import pairs

torch.set_num_threads(1)

KNOTS = 10
GRID = np.linspace(0.0, 25000.0, KNOTS)
FORECAST = np.cumsum(np.random.default_rng(8).normal(size=(KNOTS, 3)), axis=0)
D = 6


def linear(u):
    return u.sum(axis=1) / np.sqrt(u.shape[1])


def bounded(u):
    return np.minimum(linear(u), 1.0)


def holes(u):
    g = linear(u)
    g[np.abs(u[:, 0]) > 2.5] = np.nan
    return g


def same(got, ref, path="r"):
    """Exact equality of result dicts, NaN equal to NaN, arrays element by
    element."""
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            same(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=path)
    elif isinstance(ref, float) and np.isnan(ref):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert got == ref and type(got) is type(ref), (path, got, ref)


@pytest.mark.parametrize("g,threshold,kw", [
    (linear, 3.0, {}),
    (linear, 3.0, {"return_population": True, "p0": 0.2, "seed": 3}),
    (bounded, 2.0, {}),
    (holes, 2.5, {"max_levels": 2}),
    (linear, 20.0, {"max_levels": 2}),
], ids=["linear", "population", "stalled", "non-finite", "budget"])
def test_subset_simulation_is_jax(g, threshold, kw):
    kw = {"n_per_level": 400, **kw}
    got = TS.subset_simulation(g, D, threshold=threshold, **kw)
    same(got, JS.subset_simulation(g, D, threshold=threshold, **kw))
    if g is linear and threshold == 3.0:
        exact = norm.sf(3.0)
        assert abs(np.log(got["probability"] / exact)) < 4 * got["cov"]
        assert got["n_levels"] >= 3 and not got["stalled"]
    if g is bounded:
        assert got["stalled"]


@pytest.mark.parametrize("g,p_target,kw", [
    (linear, 1e-4, {}), (linear, 0.3, {"return_population": True}), (bounded, 1e-4, {}),
    (holes, 1e-3, {"p0": 0.2, "seed": 9}),
], ids=["linear", "shallow", "stalled", "non-finite"])
def test_subset_quantile_is_jax(g, p_target, kw):
    kw = {"n_per_level": 400, **kw}
    got = TS.subset_quantile(g, D, p_target=p_target, **kw)
    same(got, JS.subset_quantile(g, D, p_target=p_target, **kw))
    if g is linear and p_target == 1e-4:
        lo, hi = got["ci95_threshold"]
        assert lo <= norm.isf(1e-4) <= hi


def test_pooled_runs_are_jax():
    tails = [TS.subset_simulation(linear, D, threshold=3.0, n_per_level=200, seed=s)
             for s in range(4)]
    same(TS.pool_subset_runs(tails), JS.pool_subset_runs(tails))
    quants = [TS.subset_quantile(linear, D, p_target=1e-3, n_per_level=200, seed=s)
              for s in range(3)]
    pooled = TS.pool_subset_quantiles(quants)
    same(pooled, JS.pool_subset_quantiles(quants))
    assert pooled["ci95_threshold"][0] < pooled["threshold"] < pooled["ci95_threshold"][1]
    zero = dict(tails[0], probability=0.0, cov=float("inf"), seed=99)
    same(TS.pool_subset_runs(tails[:1] + [zero]), JS.pool_subset_runs(tails[:1] + [zero]))


@pytest.mark.parametrize("call", [
    lambda m: m.subset_simulation(linear, D, threshold=1.0, p0=1.5),
    lambda m: m.subset_simulation(linear, D, threshold=1.0, n_per_level=10, p0=0.1),
    lambda m: m.subset_simulation(linear, D, threshold=1.0, n_per_level=30, p0=0.25),
    lambda m: m.subset_simulation(linear, D, threshold=1.0, max_levels=0),
    lambda m: m.subset_simulation(lambda u: linear(u)[:-1], D, threshold=1.0),
    lambda m: m.subset_quantile(linear, D, p_target=2.0),
    lambda m: m.pool_subset_runs([]),
    lambda m: m.pool_subset_quantiles([{"p_target": 1e-3, "n_per_level": 8, "p0": 0.5,
                                        "seed": 0}] * 2),
], ids=["p0", "keeps", "divisible", "levels", "shape", "p_target", "pool-one", "pool-seeds"])
def test_checks_are_jax(call):
    with pytest.raises(ValueError) as ref:
        call(JS)
    with pytest.raises(ValueError) as got:
        call(TS)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("base", [None, FORECAST], ids=["synthesized", "forecast"])
def test_sample_from_normals_is_jax(base):
    base_wind = None if base is None else (GRID, base)
    n = 24
    u = np.random.default_rng(4).standard_normal((n, TD.normal_dims(KNOTS)))
    assert TD.normal_dims(KNOTS) == JD.normal_dims(KNOTS) == 49
    ref = JD.sample_from_normals(u, jax_nominal(jax_liquid()), JaxIC.vertical_launch(),
                                 base_wind=base_wind, wind_grid_points=KNOTS)
    got = TD.sample_from_normals(u, nominal_scene(liquid_motor("cpu")),
                                 InitialConditions.vertical_launch("cpu"), base_wind=base_wind,
                                 wind_grid_points=KNOTS)
    n_leaves = 0
    for mine_obj, ref_obj in zip(got, ref):
        for path, mine, want in pairs(mine_obj, ref_obj):
            if not isinstance(mine, torch.Tensor):
                assert mine == want, path
                continue
            want = np.asarray(want)
            assert tuple(mine.shape) == want.shape, path
            scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
            np.testing.assert_allclose(mine.numpy(), want, rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=path)
            n_leaves += 1
    assert n_leaves > 40


@pytest.mark.parametrize("u,base_wind", [
    (np.zeros(49), None), (np.zeros((2, 48)), None),
    (np.zeros((2, 49)), (GRID, np.stack([FORECAST, FORECAST]))),
], ids=["rank", "columns", "ensemble"])
def test_sample_from_normals_checks_are_jax(u, base_wind):
    with pytest.raises(ValueError) as ref:
        JD.sample_from_normals(jnp.asarray(u), jax_nominal(jax_liquid()),
                               JaxIC.vertical_launch(), base_wind=base_wind,
                               wind_grid_points=KNOTS)
    with pytest.raises(ValueError) as got:
        TD.sample_from_normals(u, nominal_scene(liquid_motor("cpu")),
                               InitialConditions.vertical_launch("cpu"), base_wind=base_wind,
                               wind_grid_points=KNOTS)
    assert str(got.value) == str(ref.value)


# the tail_probability CLI's --subset on the solid motor's 1.4 s window
# (about half of the lanes pass the 100 m apogee floor)
THRESHOLD = 112.0
SUBSET = dict(n_per_level=16, p0=0.5, max_levels=2, seed=2)
ARGV = ["--metric", "apogee_altitude", "--threshold", str(THRESHOLD), "--solid", "--max-time",
        "1.4", "--subset", "--n-per-level", "16", "--p0", "0.5", "--max-levels", "2",
        "--seed", "2", "--device", "cpu"]


def capture(mp, cls, out: dict):
    """Wrap ``cls.subset_tail`` so that ``out`` receives its full result
    (the CLI prints a digest of it)."""
    real = cls.subset_tail

    def wrapped(self, *a, **kw):
        out["res"] = real(self, *a, **kw)
        return out["res"]

    mp.setattr(cls, "subset_tail", wrapped)


@pytest.fixture(scope="module")
def cli_runs():
    """Both packages' ``tail_probability --subset``: the printed JSON and the
    analyzer's ``subset_tail`` result behind it, from the same chains."""
    from erpl_monte_carlo_sim_tpu.cli.tail_probability import tail_probability as jax_cli
    from erpl_monte_carlo_sim_tpu_torch.cli.tail_probability import main

    ref, got = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        capture(mp, JaxAnalyzer, ref)
        capture(mp, MonteCarloAnalyzer, got)
        ref["json"] = jax_cli("apogee_altitude", THRESHOLD, solid=True, max_time=1.4,
                              subset=True, **SUBSET)
        got["json"] = main(ARGV)
    return got, ref


def close(got, ref, path="r"):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            close(a, b, f"{path}[{i}]")
    elif isinstance(ref, (bool, str, int)) or ref is None:
        assert got == ref, (path, got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12, err_msg=path)


def test_subset_tail_through_the_analyzer_is_jax(cli_runs):
    got, ref = (r["res"] for r in cli_runs)
    assert got["n_levels"] == 2 and 0.0 < got["probability"] < 1.0
    assert 0.0 < got["valid_fraction"] < 1.0
    assert got["failure_channels"]["n_failure_samples"] > 0
    close(got, ref)


def test_subset_cli_json_is_jax(cli_runs, capsys):
    import json

    got, ref = (r["json"] for r in cli_runs)
    assert got["method"] == "subset" and got["levels"][-1]["threshold"] == THRESHOLD
    close(json.loads(json.dumps(got)), json.loads(json.dumps(ref)))


def test_subset_quantile_and_checks_on_the_port():
    """The lower tail's bound below the median, and the forecast ensemble
    refused, on the port alone (liquid motor, 1.2 s window)."""
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=1.2),
                            bounds=OutlierBounds(min_apogee=10.0), wind_grid_points=KNOTS)
    ic = InitialConditions.vertical_launch("cpu")
    q = mc.subset_quantile(ic, "apogee_altitude", 0.3, direction="below", n_per_level=16,
                           p0=0.5)  # one level of one chain step: two flights
    assert q["direction"] == "below" and q["n_levels"] == 2
    assert q["ci95_threshold"][0] <= q["threshold"] <= q["ci95_threshold"][1]
    assert q["failure_channels"]["n_failure_samples"] > 0
    with pytest.raises(ValueError, match="metric must be one of"):
        mc.subset_tail(ic, "landing", 1.0)
    with pytest.raises(ValueError, match="forecast ensembles"):
        mc.base_altitude_profile, mc.base_wind_profile = GRID, np.stack([FORECAST] * 2)
        mc.subset_tail(ic, "range", 1.0)
