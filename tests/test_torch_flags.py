"""PyTorch port, the ``SimConfig`` opt-ins and ``stall_limited_moments``:
the port's ``simulate_summary_batch`` against the JAX package's, lane for
lane, on the same dispersed inputs, at the bars of tests/test_torch_flight.py
(float64 rtol 5e-7 / atol 1e-6, float32 rtol 2e-5, integer leaves exact).

On CPU tensors the port runs the plain version of its CUDA kernel, so these
pin the kernel's oracle for every flag set. Each opt-in runs alone in a
window (tests/test_torch_landing_f64.py and _f32.py fly the tiered set to
landing). The opt-ins are split over three files (``GROUPS``), so that no
one test worker carries all 18 JAX compiles: this file holds the integrator
and wind opt-ins, tests/test_torch_flags_aero.py and
tests/test_torch_flags_tiered.py the others. Also here: the stall-limited
moments over alpha and beta, and the bfloat16 rounding of the wind table
against ``jnp.bfloat16``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.models as jmod
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_summary_batch as jax_summary_batch
from erpl_monte_carlo_sim_tpu_torch import models as tmod
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig, simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import OPT_INS
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy,
                                                         scene_from_numpy,
                                                         to_numpy)
from test_torch_flight import BARS, compare, jax_batch

torch.set_num_threads(1)

WINDOW = 2.0  # the rail phase and about 230 steps
DTYPES = pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
NAN_LANE = 3
# the opt-ins of each file that runs test_opt_in_matches_jax
GROUPS = {
    "test_torch_flags.py": ("rk2", "wind_eval_per_step", "wind_table_bf16"),
    "test_torch_flags_aero.py": ("energy_consistent_aero", "stall_limited_moments",
                                 "speed_guard"),
    "test_torch_flags_tiered.py": ("terminate_nonfinite", "descent_dt_scale",
                                   "ascent_q_threshold"),
}


def run_both(scene_b, ic_b, **flags):
    ref = jax_summary_batch(scene_b, ic_b, JaxConfig(**flags))
    got = simulate_summary_batch(scene_from_numpy(scene_b, "cpu"),
                                 ic_from_numpy(ic_b, "cpu"), SimConfig(**flags))
    return jax.tree.map(np.asarray, ref), to_numpy(got)


def with_table(scene_b, table):
    return scene_b.replace(wind=scene_b.wind.replace(wind=jnp.asarray(table)))


def check_opt_in(flag, dtype):
    """16 dispersed lanes in a window, one opt-in of the catalogue
    (``kernels/measure.py OPT_INS``) alone. stall_limited_moments: the wind
    is scaled 4x, so that lanes leave the rail past the 15 degree stall.
    speed_guard: passed within the window. terminate_nonfinite=False: lane
    3's wind is NaN above 2 km, and the lane runs on to the window's end
    instead of stopping as diverged."""
    fields, stall = OPT_INS[flag]
    scene_b, ic_b = jax_batch("liquid", dtype, n=16)
    if stall:
        scene_b = with_table(scene_b, np.asarray(scene_b.wind.wind) * 4.0)
        scene_b = scene_b.replace(rocket=scene_b.rocket.replace(stall_limited_moments=True))
    elif flag == "terminate_nonfinite":
        table = np.array(scene_b.wind.wind)
        table[NAN_LANE, np.asarray(scene_b.wind.altitudes) > 2000.0, :] = np.nan
        scene_b = with_table(scene_b, table)
    ref, got = run_both(scene_b, ic_b, max_time=WINDOW, **fields)
    compare(ref, got, BARS[dtype])
    if stall:
        assert (np.abs(got.rail.rail_exit_angle_of_attack) > math.radians(15.0)).any()
    elif flag == "speed_guard":
        assert got.diverged.all() and (got.max_speed >= fields["speed_guard"]).all()
    elif flag == "terminate_nonfinite":
        assert not got.diverged.any() and np.isnan(got.apogee_altitude[NAN_LANE])
    else:
        assert not got.diverged.any() and (got.n_steps > 200).all()


@DTYPES
@pytest.mark.parametrize("flag", GROUPS["test_torch_flags.py"])
def test_opt_in_matches_jax(flag, dtype):
    check_opt_in(flag, dtype)


def test_opt_in_groups_cover_the_catalogue():
    """Every opt-in of the catalogue runs in exactly one file."""
    names = [flag for group in GROUPS.values() for flag in group]
    assert sorted(names) == sorted(OPT_INS)


@pytest.mark.parametrize("case", ["zero", "stall", "past_45", "random"])
def test_stall_limited_moments_match_jax(case):
    """aero_coefficients with stall_limited_moments over alpha and beta: at
    0 (sign 0 = 0), at the stall angle and an ulp either side of it, past
    45 degrees, and random angles to +-80 degrees, both signs."""
    rng = np.random.default_rng(11)
    stall = math.radians(15.0)
    if case == "zero":
        alpha = np.array([0.0, -0.0, 0.0, 0.1, 0.0])
        beta = np.array([0.0, 0.0, -0.3, 0.0, -0.0])
    elif case == "stall":
        edge = [np.nextafter(stall, 0.0), stall, np.nextafter(stall, 1.0)]
        alpha = np.array(edge + [-e for e in edge] + [0.1, -0.1])
        beta = np.array([-e for e in edge] + edge + [stall, -stall])
    elif case == "past_45":
        alpha = np.array([math.radians(45.0), math.radians(50.0), -math.radians(60.0), 1.5, -3.0])
        beta = np.array([math.radians(46.0), -math.radians(45.0), 1.2, -1.5, 3.0])
    else:
        lim = math.radians(80.0)
        alpha, beta = rng.uniform(-lim, lim, 300), rng.uniform(-lim, lim, 300)
    mach = rng.uniform(0.0, 3.0, alpha.size)
    cg = rng.uniform(5.4, 5.8, alpha.size)
    tr = tmod.RocketParams.create("cpu", stall_limited_moments=True)
    jr = jmod.RocketParams.create(stall_limited_moments=True)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float64)

    got = tmod.aero_coefficients(tr, t(mach), t(alpha), t(beta), center_of_mass=t(cg))
    ref = jmod.aero_coefficients(jr, jnp.asarray(mach), jnp.asarray(alpha),
                                 jnp.asarray(beta), center_of_mass=jnp.asarray(cg))
    for k in ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, k)), np.asarray(getattr(ref, k)),
                                   rtol=5e-7, atol=1e-12, err_msg=k)
    plain = tmod.aero_coefficients(dataclasses.replace(tr, stall_limited_moments=False),
                                   t(mach), t(alpha), t(beta), center_of_mass=t(cg))
    stalled = np.abs(alpha) > stall
    same = ~stalled & ~(np.abs(beta) > stall)
    np.testing.assert_array_equal(got.cm.numpy()[~stalled], plain.cm.numpy()[~stalled])
    np.testing.assert_array_equal(got.cyaw.numpy()[same], plain.cyaw.numpy()[same])
    if case == "past_45":  # the stall factor is 0 there: no restoring moment
        assert np.all(got.cm.numpy() == 0.0) and np.all(got.cyaw.numpy() == 0.0)


@pytest.mark.parametrize("source", ["float32", "float64"])
def test_bf16_table_rounds_as_jax(source):
    """The wind table's bfloat16 bits from torch's ``.to(torch.bfloat16)``
    and JAX's ``astype(jnp.bfloat16)``: 2M normals at wind scale, plus values
    that round differently through float32 than straight from float64 (the
    two packages both round float64 through float32)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=2_000_000) * 10.0 ** rng.uniform(-3, 2, 2_000_000)
    if source == "float64":
        # just above a bfloat16 tie: float32 rounds it down onto the tie,
        # which then rounds to even
        tie = np.float64(1.0) + 2.0 ** -8
        x = np.concatenate([x, [tie + 2.0 ** -30, -(tie + 2.0 ** -30), 3.0 + 2.0 ** -7 + 2.0 ** -35]])
    x = x.astype(source)
    mine = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(mine, ref)
