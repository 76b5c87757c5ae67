"""PyTorch port, flight core: the port's ``simulate_summary_batch`` against
the JAX package's, lane for lane, on the same dispersed inputs.

On CPU tensors the port runs the plain PyTorch version of its CUDA kernel
(``kernels/flight_summary.py``), so these tests pin the kernel's oracle to
the JAX reference. The JAX ``simulate_summary_batch`` is itself the plain
reference of both Pallas kernels (tests/test_pallas.py pins them to
``vmap(simulate_summary)``, tests/test_batch.py pins this function to the
same). Bars: float64 at rtol 5e-7 / atol 1e-6 (tests/test_batch.py),
float32 at rtol 2e-5 (tests/test_pallas.py), integer leaves exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_summary_batch as jax_summary_batch
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig, simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy,
                                                         scene_from_numpy,
                                                         to_numpy)

torch.set_num_threads(1)

WINDOW = 6.0  # ~1k RK4 steps after rail exit: rail, boost, early coast
BARS = {jnp.float64: 5e-7, jnp.float32: 2e-5}


def leaves(obj, path=""):
    """(path, array) for every leaf of a FlightSummary-like dataclass."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    else:
        yield path, np.asarray(obj)


def compare(ref, got, rtol, atol=1e-6):
    """Every leaf: floats at ``rtol``/``atol``, integers and flags exact.
    In float32 a ``[B, 3]`` leaf is held to ``rtol`` of each lane's vector
    norm: a horizontal component far smaller than the altitude carries the
    altitude's absolute float32 rounding. NaN must meet NaN."""
    ref_l, got_l = list(leaves(ref)), list(leaves(got))
    assert [p for p, _ in ref_l] == [p for p, _ in got_l]
    for (path, a), (_, b) in zip(ref_l, got_l):
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        if a.dtype == np.float32 and a.ndim == 2:
            scale = np.linalg.norm(a, axis=-1, keepdims=True)
            bad = ~((np.abs(b - a) <= atol + rtol * scale) | (np.isnan(a) & np.isnan(b)))
            assert not bad.any(), (path, a[bad.any(-1)], b[bad.any(-1)])
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"mismatch at {path}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"mismatch at {path}")


def jax_batch(motor, dtype, n=32, key=7):
    scene = jax_nominal(jax_liquid() if motor == "liquid" else jax_solid())
    scene = jax.tree.map(
        lambda x: jnp.asarray(x, dtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, scene)
    ic = JaxIC.vertical_launch(dtype=dtype)
    scene_b, ic_b, _ = jax_sample(jax.random.PRNGKey(key), scene, ic, n=n, dtype=dtype)
    return scene_b, ic_b


def run_both(scene_b, ic_b, max_time=WINDOW):
    ref = jax_summary_batch(scene_b, ic_b, JaxConfig(max_time=max_time))
    got = simulate_summary_batch(scene_from_numpy(scene_b, "cpu"),
                                 ic_from_numpy(ic_b, "cpu"), SimConfig(max_time=max_time))
    return jax.tree.map(np.asarray, ref), to_numpy(got)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_liquid_matches_jax(dtype):
    ref, got = run_both(*jax_batch("liquid", dtype))
    compare(ref, got, BARS[dtype])
    assert (ref.n_steps > 1000).all()


def test_nan_wind_lane_diverges_at_same_step():
    """A lane whose wind table is NaN above 2 km. The JAX tent-basis sum
    multiplies every knot's value by its (zero) weight, so NaN anywhere in a
    lane's table poisons that lane's wind at any altitude: both packages
    must flag it diverged at the same step."""
    scene_b, ic_b = jax_batch("liquid", jnp.float64)
    table = np.array(scene_b.wind.wind)
    table[3, np.asarray(scene_b.wind.altitudes) > 2000.0, :] = np.nan
    scene_b = scene_b.replace(wind=scene_b.wind.replace(wind=jnp.asarray(table)))
    ref, got = run_both(scene_b, ic_b)
    assert ref.diverged[3] and got.diverged[3]
    assert got.n_steps[3] == ref.n_steps[3]
    assert not ref.diverged[np.arange(32) != 3].any()
    compare(ref, got, BARS[jnp.float64], atol=1e-6)


def test_dispatch_runs_plain_version_on_cpu():
    """CPU tensors go to the plain version: the kernel is never launched."""
    scene_b, ic_b = jax_batch("liquid", jnp.float64, n=2)
    before = fs.launches
    simulate_summary_batch(scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
                           SimConfig(max_time=1.0))
    assert fs.launches == before


@pytest.mark.slow
def test_pallas_kernels_interpret_match_plain_version():
    """Both Pallas kernels, as tests/test_pallas.py runs them (interpret
    mode, tile 8, 8 calm lanes, float32), against the port's plain version
    on the same lanes."""
    from erpl_monte_carlo_sim_tpu.engine import simulate_summary_pallas
    from erpl_monte_carlo_sim_tpu.experimental.pallas_component import (
        simulate_summary_component)
    from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams

    cfg = JaxConfig(max_time=1.5)
    scene32 = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        jax_nominal(jax_liquid()))
    ic = JaxIC.vertical_launch(dtype=jnp.float32)
    calm = UncertaintyParams(wind_speed_range=(0.0, 1.0))
    scene_b, ic_b, _ = jax_sample(jax.random.PRNGKey(0), scene32, ic, params=calm,
                                  n=8, dtype=jnp.float32)
    got = to_numpy(simulate_summary_batch(scene_from_numpy(scene_b, "cpu"),
                                          ic_from_numpy(ic_b, "cpu"),
                                          SimConfig(max_time=1.5)))
    pallas = simulate_summary_pallas(scene_b, ic_b, scene32, cfg, tile=8,
                                     interpret=True)
    compare(jax.tree.map(np.asarray, pallas), got, 2e-5)
    comp = simulate_summary_component(scene_b, ic_b, scene32, cfg, tile=8,
                                      interpret=True)
    flat = {"final_altitude": got.landing_position[:, 2],
            "final_vz": got.final_velocity[:, 2],
            "rail_exit_altitude": got.rail.rail_exit_position[:, 2]}
    for name, val in comp.items():
        mine = flat.get(name)
        if mine is None:
            mine = getattr(got, name, None)
        if mine is None:
            mine = getattr(got.rail, name)
        val = np.asarray(val)
        if val.dtype.kind == "f":
            np.testing.assert_allclose(mine, val, rtol=2e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(mine, val, err_msg=name)
