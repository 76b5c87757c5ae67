"""PyTorch port, design optimization under dispersion (``mc/robust.py``),
the line-search optimizer and the ``optimize_apogee`` CLI, on the CPU,
float64.

The dispersed objective against the JAX package's on the same lanes (JAX's
draws fed through the port's ``_draw_lanes`` seam): ``mean - 0.7 std`` of
the apogee of 8 lanes on a 1.2 s window with respect to the fin span, whose
write refreshes the Barrowman CP in both packages; JAX's value and gradient
from one ``jax.value_and_grad`` of the same computation as its
``dispersed_objective_and_grad``. Bars: objective, mean and std at rtol
1e-9, the gradient at rtol 1e-6. On a 1 s window (4 lanes): the objective
is deterministic (the same lanes give the same bits) and ``risk_lambda``
only moves the std term. The refusals, the line search and the CLI's
argument parsing are the JAX package's tests (tests/test_robust.py),
copied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.robust as robust_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine.diff import _scene_accessors as jax_accessors
from erpl_monte_carlo_sim_tpu.engine.diff import simulate_metrics_diff as jax_metrics
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc.robust import _batched as jax_batched
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.cli import optimize_apogee
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.diff import line_search_ascent
from erpl_monte_carlo_sim_tpu_torch.mc import dispersed_objective_and_grad, optimize_robust
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.utils.convert import ic_from_numpy, scene_from_numpy

torch.set_num_threads(1)

SCENE = nominal_scene(liquid_motor("cpu"))
IC = InitialConditions.vertical_launch("cpu")
JSCENE, JIC = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
LAM = 0.7
KW = dict(wrt="rocket.fin_span", n_lanes=8, seed=3)
CHEAP = dict(wrt="rocket.fin_span", n_lanes=4, seed=3)


def jax_lanes(scene, ic, n_lanes, seed, params, base_wind):
    scene_b, ic_b = jax_batched(JSCENE, JIC, n_lanes=n_lanes, seed=seed,
                                params=JaxUncertainty(), base_wind=base_wind)
    return scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu")


def test_objective_is_jax(monkeypatch):
    cfg = JaxConfig(max_time=1.2)
    scene_b, ic_b = jax_batched(JSCENE, JIC, n_lanes=8, seed=3, params=JaxUncertainty(),
                                base_wind=None)
    _, write = jax_accessors("rocket.fin_span")

    def objective(v):
        m = jax_metrics(write(scene_b, v), ic_b, cfg)["apogee_altitude"]
        mean = jnp.mean(m)
        std = jnp.sqrt(jnp.mean((m - mean) ** 2))
        return mean - LAM * std, (mean, std)

    (obj, (mean, std)), grad = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        jnp.asarray(0.2))
    monkeypatch.setattr(robust_mod, "_draw_lanes", jax_lanes)
    got, g, diag = dispersed_objective_and_grad(SCENE, IC, SimConfig(max_time=1.2),
                                                risk_lambda=LAM, **KW)
    np.testing.assert_allclose(float(got), float(obj), rtol=1e-9)
    np.testing.assert_allclose(diag["mean"], float(mean), rtol=1e-9)
    np.testing.assert_allclose(diag["std"], float(std), rtol=1e-9)
    np.testing.assert_allclose(float(g), float(grad), rtol=1e-6)
    assert diag["value"] == 0.2 and float(g) != 0.0


def test_objective_deterministic_and_risk_identity():
    cfg = SimConfig(max_time=1.0)
    obj, grad, diag = dispersed_objective_and_grad(SCENE, IC, cfg, **CHEAP)
    assert torch.isfinite(obj) and torch.isfinite(grad)
    assert diag["mean"] == pytest.approx(float(obj))
    assert diag["std"] == 0.0  # not formed on the lam=0 path
    obj2, grad2, _ = dispersed_objective_and_grad(SCENE, IC, cfg, **CHEAP)
    assert float(obj2) == float(obj) and float(grad2) == float(grad)
    obj_l, _, diag_l = dispersed_objective_and_grad(SCENE, IC, cfg, risk_lambda=LAM, **CHEAP)
    assert diag_l["mean"] == pytest.approx(diag["mean"], rel=1e-12)
    assert diag_l["std"] > 0.0
    assert float(obj_l) == pytest.approx(diag_l["mean"] - LAM * diag_l["std"], rel=1e-12)


def test_dispersed_leaf_and_bad_metric_rejected():
    cfg = SimConfig(max_time=1.0)
    with pytest.raises(ValueError, match="DISPERSED"):
        dispersed_objective_and_grad(SCENE, IC, cfg, wrt="motor.thrust_scale", n_lanes=4)
    with pytest.raises(ValueError, match="metric"):
        dispersed_objective_and_grad(SCENE, IC, cfg, wrt="rocket.fin_span", metric="bogus",
                                     n_lanes=4)


def test_optimize_robust_and_cli_route(capsys):
    hist = optimize_robust(SCENE, IC, SimConfig(max_time=1.0), steps=1, **CHEAP)
    assert len(hist) == 1
    v0, o0, _, m0, _ = hist[0]
    assert v0 == pytest.approx(0.2) and m0 == pytest.approx(o0)
    out = optimize_apogee.main(["rocket.fin_span", "1", "--robust", "4", "--lam", "0.5",
                                "--max-time", "1.0", "--device", "cpu"])
    assert len(out) == 1
    _, obj, _, mean, std = out[0]
    assert obj == pytest.approx(mean - 0.5 * std, rel=1e-12)
    assert "objective=" in capsys.readouterr().out


def test_line_search_ascent_shared_stepper():
    """Armijo backtracking with step growth and contraction: converges to a
    stationary point, respects bounds, and says why it stopped."""
    def evaluate(v):
        f = -((v - 1.0) ** 2)
        g = -2.0 * (v - 1.0)
        return (v, f, g), f, g

    hist = line_search_ascent(evaluate, 4.0, steps=64, lr=1.0)
    assert hist.info["converged"], hist.info
    assert hist.info["reason"] in ("grad_tol", "step_tol")
    assert hist.info["value"] == pytest.approx(1.0, abs=0.02)
    assert len(hist) == hist.info["n_evals"] <= 64
    evals = []

    def spy(v):
        evals.append(v)
        return evaluate(v)

    line_search_ascent(spy, 4.0, steps=2)
    assert evals[1] == pytest.approx(4.0 - 0.08)  # the first step is 2% of |v0|
    hist = line_search_ascent(evaluate, 4.0, steps=64, lr=1.0, bounds=(2.5, 10.0))
    assert hist.info["converged"] and hist.info["reason"] == "bound"
    assert hist.info["value"] == 2.5

    def cliff(v):
        f = float("nan") if v > 4.5 else -((v - 5.0) ** 2)
        return (v, f), f, -2.0 * (v - 5.0)

    hist = line_search_ascent(cliff, 4.0, steps=64, lr=1.0)
    assert hist.info["converged"]
    assert 4.0 <= hist.info["value"] <= 4.5
    assert np.isfinite(hist.info["objective"])
    assert line_search_ascent(evaluate, 4.0, steps=0) == []


def test_line_search_nonfinite_start_refuses_convergence():
    def bad(v):
        return (v, float("nan")), float("nan"), float("nan")

    hist = line_search_ascent(bad, 1.0, steps=16, lr=0.1)
    assert not hist.info["converged"]
    assert hist.info["reason"] == "nonfinite_start"
    assert hist.info["n_evals"] == 1


def test_optimize_apogee_cli_argparse():
    """Flags parse in any order (steps=0 evaluates nothing) and bad values
    fail with argparse's error."""
    cpu = ["--device", "cpu"]
    assert optimize_apogee.main(["rocket.fin_span", "0"] + cpu) == []
    assert optimize_apogee.main(["--lam", "1.0", "rocket.fin_span", "0"] + cpu) == []
    assert optimize_apogee.main(["rocket.fin_span", "0", "--metric", "range", "--max-time",
                                 "2"] + cpu) == []
    assert optimize_apogee.main(["rocket.fin_span", "0", "0.01", "--robust", "8"] + cpu) == []
    with pytest.raises(SystemExit):
        optimize_apogee.main(["rocket.fin_span", "not-an-int"] + cpu)
    with pytest.raises(SystemExit):
        optimize_apogee.main(["rocket.fin_span", "0", "--lam"])


def test_optimize_nominal_flight():
    """The nominal path: one evaluation, metric and gradient the flight's."""
    hist = optimize_apogee.optimize("motor.thrust_scale", steps=1, cfg=SimConfig(max_time=1.0),
                                    verbose=False, device="cpu")
    (v, m, g), = list(hist)
    assert v == 1.0 and m > 10.0 and g > 0.0
