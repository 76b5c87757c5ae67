"""PyTorch port, ``mc.inject_reference_lanes``: the lane-matched injection
of the executed-reference Monte Carlo goldens (tests/golden/mc_calm.jsonl,
500 lanes of the solid motor; mc_forecast.jsonl, 220 lanes of the liquid
motor) against the JAX package's, leaf for leaf, and a 16-lane forecast
window flown from both injections, in parity and with
``energy_consistent_aero``, at the bars of tests/test_torch_flight.py.

The certificates themselves (tests/test_mc_distribution_parity.py) fly these
lanes to landing; ``chip_smoke.py`` holds the port to them on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.engine as jeng
import erpl_monte_carlo_sim_tpu.mc as jmc
import erpl_monte_carlo_sim_tpu.models as jmod
from chip_smoke import golden_lanes
from erpl_monte_carlo_sim_tpu_torch import engine as teng
from erpl_monte_carlo_sim_tpu_torch import mc as tmc
from erpl_monte_carlo_sim_tpu_torch import models as tmod
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy
from test_torch_flight import BARS, compare

torch.set_num_threads(1)

MOTORS = {"calm": ("solid_motor", 500), "forecast": ("liquid_motor", 220)}
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def inject_both(config, tdtype, jdtype, lanes=None):
    """Both packages' injections of the golden, optionally its first lanes."""
    params, grid, wind, _ = golden_lanes(config)
    if lanes is not None:
        params = {k: v[:lanes] for k, v in params.items()}
        wind = wind[:lanes]
    motor = MOTORS[config][0]
    jscene = jax.tree.map(
        lambda x: jnp.asarray(x, jdtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        jmod.nominal_scene(getattr(jmod, motor)()))
    ref = jmc.inject_reference_lanes(jscene, jeng.InitialConditions.vertical_launch(dtype=jdtype),
                                     params, grid, wind)
    tscene = tmod.nominal_scene(getattr(tmod, motor)("cpu", tdtype))
    got = tmc.inject_reference_lanes(tscene, teng.InitialConditions.vertical_launch("cpu", tdtype),
                                     params, grid, wind)
    return ref, got


def leaves(obj, path=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (torch.Tensor, jax.Array, np.ndarray, float, int)):
        yield path, np.asarray(obj)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("config", list(MOTORS))
def test_injection_matches_jax_leaf_for_leaf(config, dtype):
    """Every leaf of the injected scene and initial conditions has the JAX
    injection's shape, dtype and values (the same operations on the same
    float64 records, rounded once to the dtype)."""
    (jscene, jic), (tscene, tic) = inject_both(config, *DTYPES[dtype])
    for ref_obj, got_obj in ((jscene, tscene), (jic, tic)):
        ref_l, got_l = dict(leaves(ref_obj)), dict(leaves(got_obj))
        assert ref_l.keys() == got_l.keys()
        for path, a in ref_l.items():
            b = got_l[path]
            assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
            np.testing.assert_array_equal(b, a, err_msg=path)
    n = MOTORS[config][1]
    assert tscene.wind.wind.shape == (n, tscene.wind.altitudes.shape[0], 3)
    assert tscene.rocket.dry_mass.shape == (n,) and tic.position.shape == (n, 3)


@pytest.mark.parametrize("cfg", ["parity", "energy_consistent_aero"])
def test_forecast_window_matches_jax(cfg):
    """The first 16 forecast lanes (forecast wind, dispersed launch) flown
    from both injections for 2 s, float64."""
    (jscene, jic), (tscene, tic) = inject_both("forecast", torch.float64, jnp.float64, 16)
    flags = {"energy_consistent_aero": True} if cfg != "parity" else {}
    ref = jeng.simulate_summary_batch(jscene, jic, jeng.SimConfig(max_time=2.0, **flags))
    got = teng.simulate_summary_batch(tscene, tic, teng.SimConfig(max_time=2.0, **flags))
    ref, got = jax.tree.map(np.asarray, ref), to_numpy(got)
    compare(ref, got, BARS[jnp.float64])
    assert not got.diverged.any() and (got.n_steps > 200).all()
