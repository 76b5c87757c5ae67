"""PyTorch port, the differentiable flight (``engine/diff.py``) on the CPU,
float64: its primal against the JAX package's ``simulate_metrics_diff`` and
against the port's own summary path, its caps, and its gradient against
finite differences.

Bars:
- the primal of every ``DIFF_METRICS`` entry against JAX's at rtol 1e-10
  (atol 1e-12), on four dispersed lanes of a 2 s window, and with the caps
  (``n_steps=64``, ``rail_steps=40``);
- against the port's summary path (``simulate_summary_batch``) at the JAX
  package's bars (tests/test_sensitivity.py:92-118): apogee and max speed
  at rtol 1e-12, range and the landing x at rtol 1e-9 (atol 1e-9);
- ``metric_and_grad`` of the apogee with respect to the thrust scale on a
  1.2 s window, where the apogee is the window's last altitude, against the
  central difference of two summary flights (eps 1e-4) at rtol 2e-3;
- ``metrics_reference`` (the eager oracle) equals ``simulate_metrics_diff``
  on the CPU, where both are eager, and ``refresh_derived`` and the
  accessors' writes are held to JAX's. The channel gradients against JAX's
  are in tests/test_torch_sensitivity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine.diff import simulate_metrics_diff as jax_metrics
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import rocket as JR
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine import diff as TD
from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.models import rocket as TR
from erpl_monte_carlo_sim_tpu_torch.utils.convert import ic_from_numpy, scene_from_numpy

torch.set_num_threads(1)

WINDOW = 2.0
CAPS = {"n_steps": 64, "rail_steps": 40}


@pytest.fixture(scope="module")
def lanes():
    scene_b, ic_b = jax_sample(jax.random.PRNGKey(2), jax_nominal(jax_liquid()),
                               JaxIC.vertical_launch(), n=4, wind_grid_points=20)[:2]
    return scene_b, ic_b, scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu")


@pytest.mark.parametrize("caps", [{}, CAPS], ids=["window", "caps"])
def test_primal_is_jax(lanes, caps):
    jscene, jic, scene, ic = lanes
    ref = jax.jit(lambda s, i: jax_metrics(s, i, JaxConfig(max_time=WINDOW), **caps))(jscene,
                                                                                      jic)
    with torch.no_grad():
        got = TD.simulate_metrics_diff(scene, ic, SimConfig(max_time=WINDOW), **caps)
    assert got.keys() == ref.keys() == set(TD.DIFF_METRICS)
    for k in TD.DIFF_METRICS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-10, atol=1e-12,
                                   err_msg=k)
    if caps:  # the main loop stopped after 64 steps
        assert float(got["flight_time"].max()) <= 64 * SimConfig().dt + 1e-9


def test_primal_is_the_summary_path():
    scene, ic = nominal_scene(liquid_motor("cpu")), InitialConditions.vertical_launch("cpu")
    cfg = SimConfig(max_time=WINDOW)
    with torch.no_grad():
        m = TD.simulate_metrics_diff(scene, ic, cfg)
    assert m["apogee_altitude"].ndim == 0  # a single flight gives 0-d metrics
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                ic.angular_velocity)))
    want = simulate_summary_batch(scene, ic1, cfg)
    np.testing.assert_allclose(float(m["apogee_altitude"]), float(want.apogee_altitude[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(m["max_speed"]), float(want.max_speed[0]), rtol=1e-12)
    np.testing.assert_allclose(float(m["range"]), float(want.range[0]), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(m["landing_x"]), float(want.landing_position[0, 0]),
                               rtol=1e-9, atol=1e-9)
    ref = TD.metrics_reference(scene, ic, cfg)
    for k in TD.DIFF_METRICS:
        assert torch.equal(ref[k].detach(), m[k]), k


def test_apogee_gradient_is_the_finite_difference():
    scene, ic = nominal_scene(liquid_motor("cpu")), InitialConditions.vertical_launch("cpu")
    cfg = SimConfig(max_time=1.2)
    apo, grad = TD.apogee_and_grad(scene, ic, cfg, wrt="motor.thrust_scale")
    eps = 1e-4
    ts = torch.tensor([1.0 - eps, 1.0 + eps], dtype=torch.float64)
    ic2 = InitialConditions(*(v[None].repeat(2, 1) for v in (
        ic.position, ic.velocity, ic.attitude, ic.angular_velocity)))
    s2 = dataclasses.replace(scene, motor=dataclasses.replace(scene.motor, thrust_scale=ts))
    out = simulate_summary_batch(s2, ic2, cfg)
    fd = float(out.apogee_altitude[1] - out.apogee_altitude[0]) / (2 * eps)
    assert float(grad) > 0.0 and float(apo) > 30.0
    np.testing.assert_allclose(float(grad), fd, rtol=2e-3)
    with pytest.raises(ValueError, match="metric must be one of"):
        TD.metric_and_grad(scene, ic, cfg, metric="bogus")


def test_refresh_derived_is_jax():
    """The tensor Barrowman CP equals the host value and JAX's traced one,
    with JAX's derivative in the fin span; ``create`` gives the same values
    as before ``refresh_derived`` existed (the host path)."""
    r = nominal_scene(liquid_motor("cpu")).rocket
    jr = jax_nominal(jax_liquid()).rocket
    np.testing.assert_allclose(float(TR.barrowman_cp_traced(r)), TR.barrowman_cp(r), rtol=1e-12)
    assert float(r.cp_location) == TR.barrowman_cp(r) == JR.barrowman_cp(jr)
    refreshed = TR.refresh_derived(r)
    for k in ("cp_location", "reference_area", "reference_diameter"):
        np.testing.assert_allclose(float(getattr(refreshed, k)), float(getattr(r, k)),
                                   rtol=1e-12, err_msg=k)
    for span in (0.2, 0.0):
        v = torch.tensor(span, dtype=torch.float64, requires_grad=True)
        cp = TR.barrowman_cp_traced(dataclasses.replace(r, fin_span=v))
        (g,) = torch.autograd.grad(cp, v)
        jcp, jg = jax.value_and_grad(lambda s: JR.barrowman_cp_traced(jr.replace(fin_span=s)))(
            jnp.asarray(span))
        np.testing.assert_allclose(float(cp.detach()), float(jcp), rtol=1e-12)
        np.testing.assert_allclose(float(g), float(jg), rtol=1e-10)
        assert np.isfinite(float(g))
    # finless: the host version divides by zero, the traced one takes length/2
    assert float(TR.barrowman_cp_traced(dataclasses.replace(r, fin_span=torch.tensor(0.0)))) \
        == pytest.approx(float(r.length) / 2.0)


def test_scene_accessors():
    scene = nominal_scene(liquid_motor("cpu"))
    read, write = TD._scene_accessors("rocket.fin_span")
    s2 = write(scene, torch.tensor(0.3, dtype=torch.float64))
    assert float(read(s2)) == 0.3
    assert float(s2.rocket.cp_location) > float(scene.rocket.cp_location)
    assert float(s2.rocket.reference_area) == pytest.approx(float(scene.rocket.reference_area))
    # a write to a derived field sticks (a refresh would undo it)
    for field in ("cp_location", "reference_area", "reference_diameter"):
        read, write = TD._scene_accessors(f"rocket.{field}")
        v0 = float(read(scene))
        assert float(read(write(scene, torch.tensor(v0 + 0.125, dtype=torch.float64)))) \
            == pytest.approx(v0 + 0.125), field
    read, write = TD._scene_accessors("motor.thrust_scale")
    assert float(read(write(scene, torch.tensor(1.5, dtype=torch.float64)))) == 1.5
