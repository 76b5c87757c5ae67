"""PyTorch port, Monte Carlo layer against the JAX package: the sampler's
scene assembly on identical NumPy draws, the outlier filter, the statistics,
and the whole slice (draws -> scene -> flight -> filter -> stats)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_summary_batch as jax_summary_batch
from erpl_monte_carlo_sim_tpu.engine.simulate import FlightSummary as JaxSummary
from erpl_monte_carlo_sim_tpu.mc import filter as jfilter
from erpl_monte_carlo_sim_tpu.mc import stats as jstats
from erpl_monte_carlo_sim_tpu.mc.dispersions import _build_scene as jax_build_scene
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu.ops.sobol import _sobol_bits, direction_numbers
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig, simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.engine.simulate import FlightSummary
from erpl_monte_carlo_sim_tpu_torch.mc import filter as tfilter
from erpl_monte_carlo_sim_tpu_torch.mc import stats as tstats
from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import _build_scene as torch_build_scene
from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import select_lane
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy,
                                                         scene_from_numpy,
                                                         to_numpy)

torch.set_num_threads(1)

RTOL = 5e-7
N_KNOTS = 100


def draws(n, seed, motor_sigmas=(0.05, 0.03)):
    """NumPy draws for every dispersion channel plus the [n, N, 3] AR(1)
    noise, at the JAX sampler's default sigmas and ranges."""
    rng = np.random.default_rng(seed)
    ch = {
        "pos_off": rng.normal(size=(n, 3)) * 0.0,
        "vel_off": rng.normal(size=(n, 3)) * 0.1,
        "att_off": rng.normal(size=(n, 3)) * 0.005,
        "omg_off": rng.normal(size=(n, 3)) * 0.005,
        "mass_mult": 1.0 + 0.02 * rng.normal(size=n),
        "thrust_mult_recorded": 1.0 + 0.03 * rng.normal(size=n),
        "motor_thrust_mult": 1.0 + motor_sigmas[0] * rng.normal(size=n),
        "motor_flow_mult": 1.0 + motor_sigmas[1] * rng.normal(size=n),
        "wind_speed": rng.uniform(0.0, 5.0, n),
        "wind_dir": rng.uniform(0.0, 2 * math.pi, n),
        "density_mult": 1.0 + 0.05 * rng.normal(size=n),
        "noise": rng.normal(size=(n, N_KNOTS, 3)),
    }
    return ch


def build_both(ch, motor="liquid", forecast=False):
    """The same draws through both packages' ``_build_scene``."""
    grid = np.linspace(0.0, 25000.0, N_KNOTS)
    base_wind = None
    if forecast:
        rng = np.random.default_rng(99)
        base_wind = (grid, np.cumsum(rng.normal(size=(N_KNOTS, 3)), axis=0))
    jscene = jax_nominal(jax_liquid() if motor == "liquid" else jax_solid())
    jic = JaxIC.vertical_launch()
    jax_out = jax_build_scene(
        jscene, jic, {k: jnp.asarray(v) for k, v in ch.items()}, jax.random.PRNGKey(0),
        None if base_wind is None else tuple(map(jnp.asarray, base_wind)),
        jnp.asarray(grid))
    tscene = scene_from_numpy(jscene, "cpu")
    tic = ic_from_numpy(jic, "cpu")
    torch_out = torch_build_scene(
        tscene, tic, {k: torch.as_tensor(v) for k, v in ch.items()},
        None if base_wind is None else tuple(map(torch.as_tensor, base_wind)),
        torch.as_tensor(grid))
    return jax_out, torch_out, tscene


def pairs(mine, ref, path=""):
    """(path, port leaf, JAX leaf) over a port dataclass and its JAX twin."""
    if dataclasses.is_dataclass(mine):
        for f in dataclasses.fields(mine):
            yield from pairs(getattr(mine, f.name), getattr(ref, f.name),
                             f"{path}.{f.name}")
    else:
        yield path, mine, ref


@pytest.mark.parametrize("motor,forecast", [("liquid", False), ("solid", False),
                                            ("liquid", True)],
                         ids=["liquid", "solid", "forecast"])
def test_build_scene_matches_jax(motor, forecast):
    ch = draws(48, seed=3)
    (js, jic, jsample), (ts, tic, tsample), _ = build_both(ch, motor, forecast)
    n_leaves = 0
    for mine_obj, ref_obj in ((ts, js), (tic, jic), (tsample, jsample)):
        for path, mine, ref in pairs(mine_obj, ref_obj):
            if not isinstance(mine, torch.Tensor):
                assert mine == ref, path
                continue
            ref = np.asarray(ref)
            assert tuple(mine.shape) == ref.shape, path
            np.testing.assert_allclose(mine.numpy(), ref, rtol=RTOL, atol=1e-12,
                                       err_msg=path)
            n_leaves += 1
    assert n_leaves > 50
    # solid: mass flow follows the thrust multiplier
    mdot_mult = ch["motor_thrust_mult"] if motor == "solid" else ch["motor_flow_mult"]
    np.testing.assert_allclose(ts.motor.mass_flow_rate.numpy(), 4.26 * mdot_mult,
                               rtol=1e-12)


def test_select_lane():
    ch = draws(5, seed=4)
    _, (ts, _, _), base = build_both(ch)
    lane = select_lane(ts, base, 2)
    assert lane.wind.wind.shape == (N_KNOTS, 3)
    assert float(lane.rocket.dry_mass) == pytest.approx(113.4 * ch["mass_mult"][2])
    assert torch.equal(lane.rocket.cd_mach, base.rocket.cd_mach)


def _summary_pair(n, seed):
    """A numpy FlightSummary-shaped pair (JAX, port) with NaN lanes, outliers
    and diverged lanes, for the filter."""
    rng = np.random.default_rng(seed)
    apogee = rng.uniform(50.0, 90000.0, n)
    apogee[:3] = [np.nan, np.inf, 1e9]
    rng_ = rng.uniform(0.0, 250000.0, n)
    rng_[5] = np.nan
    ft = rng.uniform(0.0, 700.0, n)
    div = rng.uniform(size=n) < 0.1
    v3 = np.zeros((n, 3))
    z = np.zeros(n)
    common = dict(apogee_altitude=apogee, apogee_time=z, range=rng_, flight_time=ft,
                  landing_position=v3, final_velocity=v3, max_speed=z,
                  parachute_deployed=np.zeros(n, bool), diverged=div,
                  n_steps=np.zeros(n, np.int32), rail=None)
    jax_s = JaxSummary(**{k: (jnp.asarray(v) if v is not None else None)
                          for k, v in common.items()})
    torch_s = FlightSummary(**{k: (torch.as_tensor(v) if v is not None else None)
                               for k, v in common.items()})
    return jax_s, torch_s


def test_outlier_mask_matches_jax():
    jax_s, torch_s = _summary_pair(500, seed=5)
    jv, jr = jfilter.outlier_mask(jax_s)
    tv, tr = tfilter.outlier_mask(torch_s)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.dtype == torch.int32
    assert tfilter.REASON_NAMES == jfilter.REASON_NAMES
    for bits in (0, 1, 65, 127):
        assert tfilter.decode_reasons(bits) == jfilter.decode_reasons(bits)


@pytest.mark.parametrize("case", ["random", "nan_lanes", "all_invalid", "ties", "one"])
def test_masked_stats_matches_jax(case):
    rng = np.random.default_rng(6)
    vals = rng.normal(1000.0, 100.0, 301)
    mask = rng.uniform(size=301) > 0.3
    if case == "nan_lanes":
        vals[::7] = np.nan
        vals[3] = np.inf
    elif case == "all_invalid":
        mask[:] = False
    elif case == "ties":
        vals = np.round(vals / 50.0) * 50.0
    elif case == "one":
        mask[:] = False
        mask[10] = True
    ref = jstats.masked_stats(jnp.asarray(vals), jnp.asarray(mask))
    got = tstats.masked_stats(torch.as_tensor(vals), torch.as_tensor(mask))
    for k in ("mean", "std", "min", "max", "percentiles"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12,
                                   err_msg=k)
    assert int(got["n"]) == int(ref["n"])


@pytest.mark.parametrize("n_valid", [0, 1, 2, 40, 1000])
def test_percentile_ci_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    vals = np.round(rng.normal(0.0, 1.0, 1200), 1)  # ties
    mask = np.zeros(1200, bool)
    mask[:n_valid] = True
    vals[n_valid + 1] = np.nan
    np.testing.assert_array_equal(tstats.percentile_ci(vals, mask),
                                  jstats.percentile_ci(vals, mask))
    assert tstats.order_stat_ranks(500, 0.05) == jstats.order_stat_ranks(500, 0.05)


@pytest.mark.parametrize("n", [0, 1, 8, 300])
def test_landing_footprint_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(20.0, 10.0, n)
    y = 0.3 * x + rng.normal(0.0, 5.0, n)
    got, ref = tstats.landing_footprint(x, y), jstats.landing_footprint(x, y)
    assert got.keys() == ref.keys()
    np.testing.assert_equal(got, ref)


def test_gaussian_cep_matches_jax():
    np.testing.assert_array_equal(tstats._sobol2(4096)[:, :],
                                  _sobol_bits(4096, direction_numbers(2), xp=np))
    cov = np.array([[120.0, 30.0], [30.0, 45.0]])
    assert tstats._gaussian_cep(cov) == jstats._gaussian_cep(cov)


def test_slice_matches_jax():
    """The whole slice on identical inputs: NumPy draws -> both scenes ->
    both flights (float64, 6 s window) -> both filters -> both stats."""
    n = 64
    (js, jic, _), (ts, tic, _), _ = build_both(draws(n, seed=11))
    window = 6.0
    jsum = jax_summary_batch(js, jic, JaxConfig(max_time=window))
    tsum = simulate_summary_batch(ts, tic, SimConfig(max_time=window))
    bounds = jfilter.OutlierBounds(min_apogee=900.0)  # some lanes are outliers
    jv, jr = jfilter.outlier_mask(jsum, bounds)
    tv, tr = tfilter.outlier_mask(tsum, tfilter.OutlierBounds(min_apogee=900.0))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 0 < int(tv.sum()) < n
    for metric in ("apogee_altitude", "range", "flight_time"):
        ref = jstats.masked_stats(getattr(jsum, metric), jv)
        got = tstats.masked_stats(getattr(tsum, metric), tv)
        for k in ("mean", "std", "min", "max", "percentiles"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6,
                                       err_msg=f"{metric}.{k}")
        np.testing.assert_allclose(
            tstats.percentile_ci(getattr(tsum, metric).numpy(), tv.numpy()),
            jstats.percentile_ci(np.asarray(getattr(jsum, metric)), np.asarray(jv)),
            rtol=1e-6)
    tnp = to_numpy(tsum)
    fin = tv.numpy()
    ref_fp = jstats.landing_footprint(np.asarray(jsum.landing_position)[fin, 0],
                                      np.asarray(jsum.landing_position)[fin, 1])
    got_fp = tstats.landing_footprint(tnp.landing_position[fin, 0],
                                      tnp.landing_position[fin, 1])
    for k in ("mean_m", "cov_m2", "cep_m"):
        np.testing.assert_allclose(got_fp[k], ref_fp[k], rtol=1e-6, atol=1e-9, err_msg=k)
