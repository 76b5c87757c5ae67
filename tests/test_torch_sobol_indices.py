"""PyTorch port, Sobol' indices (``mc/sobol_indices.py``) against the JAX
package on the CPU, float64.

The estimators (``jansen_estimates``, ``pure_interactions``,
``select_interaction_pairs``, ``active_groups``) give JAX's numbers exactly
on the same inputs. ``sobol_indices`` runs end to end in both packages on
the same draws (JAX's ``_draw_matrix`` fed through the port's seam), 64
lanes on a 1.0 s window, a 10-knot grid, 20 bootstrap resamples (the same
``default_rng`` indices): three groups with ``pairs="auto"``, and three
groups with their pairs and the triple (``groups=None``, every active
group, is ``active_groups``', held to JAX's above). Counts and names exact; indices,
means, variances and the bootstrap intervals within 1e-9 (absolute, on
shares of order 1).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc.dispersions import UncertaintyParams as JaxParams
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import UncertaintyParams
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, solid_motor

# the modules (each package's mc/__init__ exports the function of that name)
JSI = importlib.import_module("erpl_monte_carlo_sim_tpu.mc.sobol_indices")
TSI = importlib.import_module("erpl_monte_carlo_sim_tpu_torch.mc.sobol_indices")

torch.set_num_threads(1)

N, SEED, KNOTS, N_BOOT = 64, 6, 10, 20
WINDOW, MIN_APOGEE = 1.0, 10.0
TRIPLE = ("mass", "motor_thrust", "density")
SUBSETS = [TRIPLE[:2], TRIPLE[::2], TRIPLE[1:], TRIPLE]
# the groups that carry this window's spread, and the turbulence
AUTO_GROUPS = ["attitude", "motor_thrust", "wind_turbulence"]


def test_estimators_are_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=500), rng.normal(size=500)
    fabs = {"x": a + 0.3 * b, "y": rng.normal(size=500), ("x", "y"): a * 0.5 + b}
    got, ref = TSI.jansen_estimates(a, b, fabs), JSI.jansen_estimates(a, b, fabs)
    assert got == ref
    assert TSI.jansen_estimates(np.ones(4), np.ones(4), {"x": np.ones(4)}) == \
        JSI.jansen_estimates(np.ones(4), np.ones(4), {"x": np.ones(4)})
    est = {"groups": {"a": {"S": 0.2}, "b": {"S": 0.1}, "c": {"S": 0.05},
                      ("a", "b"): {"S": 0.4}, ("a", "c"): {"S": 0.3}, ("b", "c"): {"S": 0.2},
                      ("a", "b", "c"): {"S": 0.9}}}
    subsets = [("a", "b", "c"), ("a", "b"), ("a", "c"), ("b", "c")]
    assert TSI.pure_interactions(est, subsets) == JSI.pure_interactions(est, subsets)
    for gaps in ({"a": 0.3, "b": 0.05, "c": 0.2, "d": 0.5, "e": 0.15, "f": 0.11},
                 {"a": 0.01}, {}):
        assert TSI.select_interaction_pairs(gaps) == JSI.select_interaction_pairs(gaps)
        assert TSI.select_interaction_pairs(gaps, 0.0, 2) == \
            JSI.select_interaction_pairs(gaps, 0.0, 2)


@pytest.mark.parametrize("solid,kw,turbulence", [
    (False, {}, True), (True, {}, True),
    (False, {"initial_position": (0.0, 1.0, 0.0), "mass_uncertainty": 0.0}, False),
], ids=["liquid", "solid", "params"])
def test_active_groups_are_jax(solid, kw, turbulence):
    scene = nominal_scene((solid_motor if solid else liquid_motor)("cpu"))
    jscene = jax_nominal(jax_solid() if solid else jax_liquid())
    assert TSI.active_groups(scene, UncertaintyParams(**kw), turbulence) == \
        JSI.active_groups(jscene, JaxParams(**kw), turbulence)


def jax_draws(seed, matrix, n, knots, dtype, device):
    d = JSI._draw_matrix(jax.random.fold_in(jax.random.PRNGKey(seed), matrix), n, knots,
                             jnp.float64)
    return {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}


@pytest.fixture(scope="module", params=["auto", "triple"])
def both(request):
    kw = {"groups": AUTO_GROUPS, "pairs": "auto"} if request.param == "auto" else {
        "groups": list(TRIPLE), "pairs": SUBSETS}
    common = dict(n=N, seed=SEED, n_boot=N_BOOT, wind_grid_points=KNOTS, **kw)
    ref = JSI.sobol_indices(jax_nominal(jax_liquid()), JaxIC.vertical_launch(),
                            JaxConfig(max_time=WINDOW), bounds=JaxBounds(min_apogee=MIN_APOGEE),
                            **common)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TSI, "_draw_matrix", jax_draws)
        got = TSI.sobol_indices(nominal_scene(liquid_motor("cpu")),
                                InitialConditions.vertical_launch("cpu"),
                                SimConfig(max_time=WINDOW),
                                bounds=OutlierBounds(min_apogee=MIN_APOGEE), **common)
    return request.param, got, ref


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-9,
                               atol=1e-9, err_msg=what)


def test_sobol_indices_are_jax(both):
    case, got, ref = both
    for k in ("n", "n_valid", "n_sims", "groups", "pairs"):
        assert got[k] == ref[k], k
    assert 16 <= got["n_valid"] <= N
    if case == "triple":
        assert got["pairs"][-1] == "*".join(TRIPLE)
    for m in ("apogee_altitude", "range", "flight_time"):
        blk, rblk = got[m], ref[m]
        assert blk.keys() == rblk.keys(), m
        close([blk["mean"], blk["variance"], blk["sum_first_order"]],
              [rblk["mean"], rblk["variance"], rblk["sum_first_order"]], m)
        for order, idx in (("first_order", "S"), ("total_order", "T")):
            for g, row in rblk[order].items():
                close(blk[order][g][idx], row[idx], f"{m}.{order}.{g}")
                close(blk[order][g]["ci95"], row["ci95"], f"{m}.{order}.{g}.ci95")
        for p, row in rblk.get("second_order", {}).items():
            for k in ("closed", "interaction", "ci95"):
                close(blk["second_order"][p][k], row[k], f"{m}.{p}.{k}")
    dominant = max(got["groups"], key=lambda g: got["apogee_altitude"]["total_order"][g]["T"])
    assert got["apogee_altitude"]["total_order"][dominant]["T"] > 0.1


@pytest.mark.parametrize("kw", [
    {"groups": ["thrust"]}, {"groups": []}, {"pairs": [("mass",)]},
    {"pairs": [("mass", "mass")]}, {"pairs": [("mass", "density"), ("density", "mass")]},
    {"pairs": [TRIPLE]}, {"groups": ["mass"], "pairs": [("mass", "density")]},
], ids=["unknown", "none", "single", "repeat", "duplicate", "triple-alone", "unanalyzed"])
def test_checks_are_jax(kw):
    with pytest.raises(ValueError) as ref:
        JSI.sobol_indices(jax_nominal(jax_liquid()), JaxIC.vertical_launch(), JaxConfig(), n=8,
                          **kw)
    with pytest.raises(ValueError) as got:
        TSI.sobol_indices(nominal_scene(liquid_motor("cpu")),
                          InitialConditions.vertical_launch("cpu"), SimConfig(), n=8, **kw)
    assert str(got.value) == str(ref.value)


def test_port_draws_are_seeded_per_matrix_and_group():
    a = TSI._draw_matrix(3, 0, 8, KNOTS, torch.float64, "cpu")
    assert torch.equal(a["mass"], TSI._draw_matrix(3, 0, 8, KNOTS, torch.float64, "cpu")["mass"])
    b = TSI._draw_matrix(3, 1, 8, KNOTS, torch.float64, "cpu")
    assert not torch.equal(a["mass"], b["mass"]) and not torch.equal(a["mass"], a["density"])
    assert a["wind_turbulence"].shape == (8, KNOTS, 3) and a["velocity"].shape == (8, 3)
    assert bool((a["wind_speed"] >= 0).all()) and bool((a["wind_speed"] < 1).all())


def test_matrices_and_members_are_the_jax_keys():
    """The matrices' draws are JAX's (``fold_in(PRNGKey(seed), m)``, group
    ``i`` under ``fold_in(., i)``), and an ensemble's members are the ones
    JAX's fixed turbulence key ``PRNGKey(0)`` draws, in every matrix."""
    for m in (0, 1):
        got = TSI._draw_matrix(3, m, 8, KNOTS, torch.float64, "cpu")
        want = JSI._draw_matrix(jax.random.fold_in(jax.random.PRNGKey(3), m), 8, KNOTS,
                                jnp.float64)
        assert got.keys() == want.keys()
        for g in want:
            np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]), rtol=1e-12,
                                       atol=1e-12, err_msg=g)
    grid = np.linspace(0.0, 25000.0, KNOTS)
    members = np.stack([np.zeros((KNOTS, 3)), np.full((KNOTS, 3), 2.0), np.ones((KNOTS, 3))])
    jdraws = JSI._draw_matrix(jax.random.fold_in(jax.random.PRNGKey(3), 0), 8, KNOTS,
                              jnp.float64)
    jb = (jnp.asarray(grid), jnp.asarray(members))
    want, _ = JSI._assemble(jax_nominal(jax_liquid()), JaxIC.vertical_launch(), JaxParams(),
                            jdraws, jb[0], jb, jnp.float64)
    tb = tuple(torch.as_tensor(x) for x in (grid, members))
    got, _ = TSI._assemble(nominal_scene(liquid_motor("cpu")),
                           InitialConditions.vertical_launch("cpu"), UncertaintyParams(),
                           TSI._draw_matrix(3, 0, 8, KNOTS, torch.float64, "cpu"), tb[0], tb,
                           torch.float64)
    np.testing.assert_allclose(got.wind.wind.numpy(), np.asarray(want.wind.wind), rtol=1e-12,
                               atol=1e-12)
