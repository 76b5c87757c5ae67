"""PyTorch port, the prng sampler's spread against the JAX package's.

Both samplers draw under ``PRNGKey(0)`` (float64, 20,000 lanes each, the
liquid motor, synthesized wind), so the lanes are the same: the uniform
channels bit for bit, the Gaussian ones and the wind tables within the
float64 normals' bar. The distributions are compared too, as for any two
samples: each of the 19 scalar channels' standard deviation, and the AR(1)
wind table's per-knot spread at knots 0, 10, 50 and 99, within 4 standard
errors of their difference. The means are held by
tests/test_torch_analyzer.py; a wrong sigma would pass that and fail here.
"""

import jax
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
from erpl_monte_carlo_sim_tpu_torch.mc import UncertaintyParams, sample_dispersions
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.ops import prng

torch.set_num_threads(1)

N = 20_000
SEED = 0
# the 19 scalar channels: (sample field, component)
CHANNELS = [(f, c) for f in ("initial_position_offset", "initial_velocity_offset",
                             "initial_attitude_offset", "initial_angular_velocity_offset")
            for c in range(3)] + [(f, None) for f in (
                "mass_multiplier", "thrust_multiplier", "motor_thrust_multiplier",
                "motor_flow_multiplier", "wind_speed", "wind_direction", "density_multiplier")]
KNOTS = (0, 10, 50, 99)


def std_and_se(x: np.ndarray) -> tuple:
    """The population std and its standard error, from the sample's fourth
    central moment (any distribution: the normal channels, the uniform
    wind speed and direction)."""
    d = x - x.mean()
    var, m4 = (d ** 2).mean(), (d ** 4).mean()
    s = np.sqrt(var)
    return s, (np.sqrt(max(m4 - var ** 2, 0.0) / x.size) / (2 * s) if s > 0 else 0.0)


@pytest.fixture(scope="module")
def draws():
    """``(port, JAX)``, each ``{channel: values}`` with the wind knots."""
    scene_b, _, sample = sample_dispersions(prng.prng_key(SEED),
                                            nominal_scene(liquid_motor("cpu")),
                                            InitialConditions.vertical_launch("cpu"),
                                            UncertaintyParams(), N)
    ref_scene, _, ref_sample = jax_sample(jax.random.PRNGKey(SEED), jax_nominal(jax_liquid()),
                                          JaxIC.vertical_launch(), n=N)
    out = []
    for smp, wind in ((sample, scene_b.wind.wind), (ref_sample, ref_scene.wind.wind)):
        d = {}
        for f, c in CHANNELS:
            v = np.asarray(getattr(smp, f))
            d[(f, c)] = v[:, c] if c is not None else v
        w = np.asarray(wind)
        assert w.shape == (N, 100, 3)
        for k in KNOTS:
            for c in range(3):
                d[("wind", k, c)] = w[:, k, c]
        out.append(d)
    return out


@pytest.mark.parametrize("channel", CHANNELS + [("wind", k, c) for k in KNOTS
                                                for c in range(3)],
                         ids=lambda ch: "-".join(str(x) for x in ch if x is not None))
def test_spread_agrees_with_jax(draws, channel):
    mine, ref = draws
    assert mine[channel].dtype == ref[channel].dtype == np.float64
    (s_a, se_a), (s_b, se_b) = std_and_se(mine[channel]), std_and_se(ref[channel])
    if s_b == 0.0:  # a channel with zero sigma (the launch position)
        assert s_a == 0.0
        return
    assert abs(s_a - s_b) <= 4 * np.hypot(se_a, se_b), (s_a, s_b, se_a, se_b)
    assert s_a > 0


def test_lanes_are_jax(draws):
    """The same lanes: the uniform channels bit for bit, the others within
    the float64 normals' bar (2e-13 relative) of their largest magnitude."""
    mine, ref = draws
    for channel in ref:
        a, b = mine[channel], ref[channel]
        if channel[0] in ("wind_speed", "wind_direction"):
            np.testing.assert_array_equal(a, b, err_msg=str(channel))
        else:
            np.testing.assert_allclose(a, b, rtol=0.0, atol=2e-13 * np.abs(b).max(),
                                       err_msg=str(channel))
