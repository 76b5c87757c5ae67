"""PyTorch port, the sensitivity channels (``cli/sensitivity.py``) through the
differentiable flight (``engine/diff.py``) against the JAX package on the
CPU, float64.

Two lanes fly a 1.8 s window: the nominal liquid-motor flight, and a weak
motor (0.3 kg of propellant, launched 2 m up) that leaves the rail and lands
at 1.64 s, so the quadratic backtrack to the ground crossing decides its
``range``, ``flight_time`` and landing point. The derivative of every
``DIFF_METRICS`` entry of each lane with respect to the six channels comes
from one reverse pass in each package over six copies of the lanes (copy i
differentiated for metric i, each channel a value per lane): JAX's
``simulate_metrics_diff`` through its ``_perturbed_scene`` under ``vmap``,
and the port's through its own. Bars:
every derivative at rtol 1e-6 (they agree to about 1e-15), the primal at
rtol 1e-10. ``_channel_sigmas`` equals JAX's; ``variance_budget`` keeps the
root-sum-square identity and JAX's keys; ``auto_shift`` is
``shift_from_gradients`` of ``metric_sensitivities``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.cli import sensitivity as JS
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine.diff import DIFF_METRICS as JAX_METRICS
from erpl_monte_carlo_sim_tpu.engine.diff import simulate_metrics_diff as jax_metrics
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc import shift_from_gradients as jax_shift
from erpl_monte_carlo_sim_tpu.models import RocketParams as JaxRocket
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.cli import sensitivity as TS
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.diff import DIFF_METRICS, simulate_metrics_diff
from erpl_monte_carlo_sim_tpu_torch.mc import UncertaintyParams, auto_shift
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.utils.convert import ic_from_numpy, scene_from_numpy

torch.set_num_threads(1)

WINDOW = 1.8
LANES = 2
WEAK_PROPELLANT, WEAK_HEIGHT = 0.3, 2.0


def jax_lanes():
    """The nominal flight and the weak motor's as one JAX batch: the leaves
    that differ get a lane axis."""
    s0 = jax_nominal(jax_liquid())
    s1 = jax_nominal(jax_liquid(propellant_mass=WEAK_PROPELLANT))
    s1 = s1.replace(rocket=JaxRocket.create(propellant_mass=WEAK_PROPELLANT))
    scene = jax.tree.map(lambda a, b: a if np.array_equal(a, b) else jnp.stack([a, b]), s0, s1)
    ic = JaxIC.vertical_launch()
    ic = ic.replace(position=jnp.stack([ic.position, ic.position.at[2].set(WEAK_HEIGHT)]),
                    velocity=jnp.stack([ic.velocity] * 2), attitude=jnp.stack([ic.attitude] * 2),
                    angular_velocity=jnp.stack([ic.angular_velocity] * 2))
    return s0, scene, ic


def tiled(scene, ic, s0, copies):
    """``copies`` copies of the lanes, one after the other."""
    return (jax.tree.map(lambda x, x0: jnp.tile(x, copies) if np.ndim(x) > np.ndim(x0) else x,
                         scene, s0),
            jax.tree.map(lambda x: jnp.tile(x, (copies, 1)), ic))


@pytest.fixture(scope="module")
def jacobians():
    """``{metric: {channel: [LANES]}}`` and the primal, from JAX and the port.
    Both take six copies of the lanes, copy i differentiated for metric i,
    each channel a value per lane, so one reverse pass gives every
    derivative (in JAX ``_perturbed_scene`` applies a lane's scalars under
    ``vmap``)."""
    s0, scene, ic = jax_lanes()
    copies = len(DIFF_METRICS)
    scene6, ic6 = tiled(scene, ic, s0, copies)
    cfg = JaxConfig(max_time=WINDOW)
    axes = jax.tree.map(lambda x, x0: 0 if np.ndim(x) > np.ndim(x0) else None, scene6, s0)

    def one_lane(c, scene_lane, ic_lane):
        return jax_metrics(*JS._perturbed_scene(scene_lane, ic_lane, c), cfg)

    def loss(c):
        m = jax.vmap(one_lane, in_axes=(0, axes, 0))(c, scene6, ic6)
        return sum(m[name][i * LANES:(i + 1) * LANES].sum()
                   for i, name in enumerate(JAX_METRICS)), m

    def channels(module, ones):
        return {k: ones(1.0 if k.endswith("multiplier") else 0.0) for k in module.CHANNELS}

    c0 = channels(JS, lambda v: jnp.full((copies * LANES,), v))
    (_, primal), jac = jax.jit(jax.value_and_grad(loss, has_aux=True))(c0)

    def per_metric(grads, names):
        return {name: {k: np.asarray(grads[k][i * LANES:(i + 1) * LANES]) for k in JS.CHANNELS}
                for i, name in enumerate(names)}

    ref = per_metric(jac, JAX_METRICS), {m: np.asarray(v)[:LANES] for m, v in primal.items()}

    c = channels(TS, lambda v: torch.full((copies * LANES,), v, dtype=torch.float64,
                                          requires_grad=True))
    s2, ic2 = TS._perturbed_scene(scene_from_numpy(scene6, "cpu"), ic_from_numpy(ic6, "cpu"), c)
    m = simulate_metrics_diff(s2, ic2, SimConfig(max_time=WINDOW))
    total = sum(m[name][i * LANES:(i + 1) * LANES].sum() for i, name in enumerate(DIFF_METRICS))
    grads = dict(zip(TS.CHANNELS, torch.autograd.grad(total, [c[k] for k in TS.CHANNELS])))
    got = (per_metric({k: g.numpy() for k, g in grads.items()}, DIFF_METRICS),
           {name: v.detach()[:LANES].numpy() for name, v in m.items()})
    return ref, got


def test_names_are_jax():
    assert TS.CHANNELS == JS.CHANNELS and DIFF_METRICS == JAX_METRICS


def test_primal_is_jax_and_the_weak_lane_lands(jacobians):
    (_, ref), (_, got) = jacobians
    for name in DIFF_METRICS:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-10, atol=1e-12, err_msg=name)
    # the weak lane landed before the window's end: its flight time is the
    # backtracked crossing, not the window
    assert got["flight_time"][1] < WINDOW - 0.1 and got["range"][1] > 0.0
    assert got["apogee_altitude"][0] > 50.0


@pytest.mark.parametrize("metric", DIFF_METRICS)
def test_channel_gradients_are_jax(jacobians, metric):
    (ref, _), (got, _) = jacobians
    for k in TS.CHANNELS:
        assert np.isfinite(got[metric][k]).all(), (metric, k)
        np.testing.assert_allclose(got[metric][k], ref[metric][k], rtol=1e-6, atol=1e-9,
                                   err_msg=f"{metric} / {k}")


@pytest.mark.parametrize("params", [{}, {"wind_direction_range": (0.0, 1e-4)},
                                    {"wind_speed_range": (1.0, 3.0),
                                     "wind_direction_range": (0.5, 2.0)}],
                         ids=["default", "narrow", "sector"])
def test_channel_sigmas_are_jax(params):
    got = TS._channel_sigmas(nominal_scene(liquid_motor("cpu")), UncertaintyParams(**params))
    ref = JS._channel_sigmas(jax_nominal(jax_liquid()), JaxUncertainty(**params))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)


SHORT = SimConfig(max_time=1.0)


def test_variance_budget_and_auto_shift():
    """The budget's root-sum-square identity and keys; ``auto_shift`` is the
    design-point rule on the same gradients (one reverse pass each)."""
    scene, ic = nominal_scene(liquid_motor("cpu")), InitialConditions.vertical_launch("cpu")
    out = TS.variance_budget(scene, ic, SHORT)
    assert set(out) == {"metric", "channels", "apogee_m", "apogee_sigma_first_order_m"}
    assert set(out["channels"]) == set(TS.CHANNELS)
    contrib = [v["apogee_sigma_contribution_m"] for v in out["channels"].values()]
    np.testing.assert_allclose(out["apogee_sigma_first_order_m"],
                               np.sqrt(np.sum(np.square(contrib))), rtol=1e-12)
    assert out["channels"]["flow_multiplier"]["sigma"] > 0  # a liquid motor
    assert out["channels"]["thrust_multiplier"]["gradient"] > 0
    threshold = 1.05 * out["apogee_m"]
    shift, info = auto_shift(scene, ic, SHORT, "apogee_altitude", threshold)
    grads = {"mass": "mass_multiplier", "motor_thrust": "thrust_multiplier",
             "motor_flow": "flow_multiplier", "density": "density_multiplier"}
    want = jax_shift(out["apogee_m"], {n: out["channels"][c]["gradient"]
                                       for n, c in grads.items()},
                     {n: out["channels"][c]["sigma"] for n, c in grads.items()}, threshold)
    assert shift.keys() == want[0].keys() and "motor_thrust" in shift
    for k in shift:
        np.testing.assert_allclose(shift[k], want[0][k], rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(info["z_star"], want[1]["z_star"], rtol=1e-12)


def test_main_routes_sobol(capsys, monkeypatch):
    """``--sobol N`` routes to ``mc.sobol_indices`` (its flights are held in
    tests/test_torch_sobol_indices.py), with the window and 200 resamples."""
    import importlib

    module = importlib.import_module("erpl_monte_carlo_sim_tpu_torch.mc.sobol_indices")
    seen = {}

    def spy(scene, ic, cfg, n, n_boot):
        seen.update(cfg=cfg, n=n, n_boot=n_boot, device=scene.rocket.dry_mass.device.type)
        return {"groups": [], "n": n}

    monkeypatch.setattr(module, "sobol_indices", spy)
    out = TS.main(["1.0", "--sobol", "8", "--device", "cpu"])
    assert out == {"groups": [], "n": 8} and '"groups"' in capsys.readouterr().out
    assert seen == {"cfg": SimConfig(max_time=1.0), "n": 8, "n_boot": 200, "device": "cpu"}
    with pytest.raises(ValueError, match="metric must be one of"):
        TS.metric_sensitivities(nominal_scene(liquid_motor("cpu")),
                                InitialConditions.vertical_launch("cpu"), SHORT, metric="bogus")
