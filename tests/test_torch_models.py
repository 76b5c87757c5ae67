"""PyTorch port, modules 1-11 (ops, models, config, initial conditions)
against the JAX package on random NumPy inputs, in float64 at rtol 5e-7
(the transcendental floor of tests/test_ops.py), plus the
tests/golden/units.json cases of test_ops/test_atmosphere/test_motor/
test_rocket for the ported functions."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.engine as jeng
import erpl_monte_carlo_sim_tpu.models as jmod
import erpl_monte_carlo_sim_tpu.ops as jops
from erpl_monte_carlo_sim_tpu.ops.math import safe_sqrt as jax_safe_sqrt
from erpl_monte_carlo_sim_tpu.models.wind import _ar1_scan as jax_ar1_scan
from erpl_monte_carlo_sim_tpu_torch import engine as teng
from erpl_monte_carlo_sim_tpu_torch import models as tmod
from erpl_monte_carlo_sim_tpu_torch import ops as tops
from erpl_monte_carlo_sim_tpu_torch.engine.component import _aero_angles, qdot_c
from erpl_monte_carlo_sim_tpu_torch.models.wind import _ar1_scan as torch_ar1_scan
from erpl_monte_carlo_sim_tpu_torch.utils.convert import ic_from_numpy, scene_from_numpy

torch.set_num_threads(1)

RTOL = 5e-7
CPU = "cpu"


def t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def close(got, ref, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


# ------------------------------------------------------------------ ops
def test_constants():
    assert (tops.R_AIR, tops.GAMMA_AIR) == (jops.R_AIR, jops.GAMMA_AIR)


def test_safe_sqrt_keeps_nan_and_zeroes_nonpositive():
    x = np.array([4.0, 0.0, -3.0, np.nan, 2.5, np.inf])
    got = tops.safe_sqrt(t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_safe_sqrt(jnp.asarray(x))))
    assert np.isnan(got[3]) and got[1] == 0.0 and got[2] == 0.0


@pytest.mark.parametrize("case", ["random", "endpoints", "knots", "duplicate"])
def test_interpolate_1d(case, rng):
    xt = np.sort(rng.uniform(0, 10, 9))
    if case == "duplicate":
        xt[4] = xt[3]
    yt = rng.normal(size=9)
    xs = {"random": rng.uniform(-2, 12, 200),
          "endpoints": np.array([xt[0], xt[-1], xt[0] - 5, xt[-1] + 5, -1e9, 1e9]),
          "knots": xt.copy(),
          "duplicate": rng.uniform(-1, 11, 50)}[case]
    ref = jops.interpolate_1d(jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(yt))
    close(tops.interpolate_1d(t(xs), t(xt), t(yt)), ref, atol=1e-13)
    if case != "duplicate":
        close(tops.interpolate_1d(t(xs), t(xt), t(yt)), np.interp(xs, xt, yt), atol=1e-12)


@pytest.mark.parametrize("table", ["shared", "per_lane"])
def test_interpolate_vec(table, rng):
    grid = np.linspace(0.0, 25000.0, 100)
    xs = np.concatenate([rng.uniform(-500, 26000, 30), grid[[0, 1, 50, 98, 99]]])
    if table == "shared":
        yt = rng.normal(size=(100, 3))
        ref = np.stack([jops.interpolate_vec(jnp.asarray(x), jnp.asarray(grid),
                                             jnp.asarray(yt)) for x in xs])
    else:
        yt = rng.normal(size=(xs.size, 100, 3))
        ref = np.stack([jops.interpolate_vec(jnp.asarray(x), jnp.asarray(grid),
                                             jnp.asarray(y)) for x, y in zip(xs, yt)])
    close(tops.interpolate_vec(t(xs), t(grid), t(yt)), ref, atol=1e-13)


def test_interpolate_vec_nan_anywhere_poisons():
    """0 * NaN = NaN: a NaN knot poisons queries far from it, as in JAX."""
    grid = np.linspace(0.0, 10.0, 11)
    yt = np.zeros((11, 3))
    yt[9, 0] = np.nan
    got = tops.interpolate_vec(t([1.0]), t(grid), t(yt)).numpy()
    ref = np.asarray(jops.interpolate_vec(jnp.asarray(1.0), jnp.asarray(grid),
                                          jnp.asarray(yt)))
    assert np.isnan(got[0, 0]) and np.isnan(ref[0]) and got[0, 1] == ref[1] == 0.0


def test_euler_quaternion_roundtrip_random(rng):
    e = rng.uniform(-3.0, 3.0, size=(200, 3))
    e[:, 1] = rng.uniform(-1.5, 1.5, 200)
    q_ref = np.asarray(jops.euler_to_quaternion(*(jnp.asarray(e[:, i]) for i in range(3))))
    q = tops.euler_to_quaternion(*(t(e[:, i]) for i in range(3)))
    close(q, q_ref, atol=1e-13)
    close(tops.quaternion_to_euler(q), jops.quaternion_to_euler(jnp.asarray(q_ref)),
          atol=1e-12)


def test_quaternion_to_euler_pitch_clamp():
    # |sinp| >= 1: pitch is +-pi/2 exactly, sign(0) = 0 path included
    q = np.array([[math.sqrt(0.5), 0.0, math.sqrt(0.5), 0.0],
                  [math.sqrt(0.5), 0.0, -math.sqrt(0.5), 0.0],
                  [0.5, 0.5, 0.5, 0.5],
                  [1.0, 0.0, 0.0, 0.0]])
    close(tops.quaternion_to_euler(t(q)), jops.quaternion_to_euler(jnp.asarray(q)),
          atol=1e-15)


def test_normalize_quaternion(rng):
    q = rng.normal(size=(20, 4))
    q[3] = 0.0
    q[5] = 1e-14
    close(tops.normalize_quaternion(t(q)), jops.normalize_quaternion(jnp.asarray(q)),
          atol=1e-15)


def test_units_euler_quat(golden_units):
    for case in golden_units["math"]["euler_quat"]:
        q = tops.euler_to_quaternion(*(t(v) for v in case["euler"]))
        close(q, case["quat_wxyz"], atol=1e-9)
        close(tops.quaternion_to_euler(t(case["quat_wxyz"])), case["euler_back"], atol=1e-9)


def test_units_qrate(golden_units):
    for case in golden_units["math"]["qrate"]:
        qd = qdot_c(*(t(v) for v in case["q"]), *(t(v) for v in case["omega"]))
        close(torch.stack(qd), case["qdot"], rtol=1e-12, atol=1e-12)


def test_units_aero_angles(golden_units):
    for case in golden_units["math"]["aero_angles"]:
        alpha, beta = _aero_angles(*(t(v) for v in case["vb"]))
        close(alpha, case["alpha"], atol=1e-9)
        close(beta, case["beta"], atol=1e-9)


def test_aero_angle_degenerate_guards():
    alpha, _ = _aero_angles(t(-1e-9), t(5.0), t(1e-9))
    _, beta = _aero_angles(t(1e-9), t(5.0), t(1e-9))
    assert float(alpha) == 0.0 and float(beta) == 0.0


# ------------------------------------------------------------------ atmosphere
def _atm_pair():
    return tmod.AtmosphereParams.create(CPU), jmod.AtmosphereParams.create()


@pytest.mark.parametrize("region", ["random", "boundaries"])
def test_atmosphere_matches_jax(region, rng):
    if region == "random":
        h = rng.uniform(0.0, 120000.0, 400)
    else:
        b = np.array([11000.0, 20000.0, 25000.0, 32000.0])
        h = np.concatenate([b, b - 1e-3, b + 1e-3, b - 1.0, b + 1.0, [0.0, -50.0]])
    tp, jp = _atm_pair()
    got = tmod.atmosphere_properties(tp, t(h))
    ref = jmod.atmosphere_properties(jp, jnp.asarray(h))
    for k in ("temperature", "pressure", "density", "speed_of_sound"):
        close(getattr(got, k), getattr(ref, k))
    close(tmod.gravity_at(tp, t(h)), jmod.gravity_at(jp, jnp.asarray(h)))


def test_atmosphere_dispersed_density_scale(rng):
    h = rng.uniform(0.0, 40000.0, 50)
    scale = rng.normal(1.0, 0.05, 50)
    tp = dataclasses.replace(tmod.AtmosphereParams.create(CPU), density_scale=t(scale))
    jp = jmod.AtmosphereParams.create().replace(density_scale=jnp.asarray(scale))
    close(tmod.atmosphere_properties(tp, t(h)).density,
          jmod.atmosphere_properties(jp, jnp.asarray(h)).density)


def test_atmosphere_nan_altitude_stays_nan():
    got = tmod.atmosphere_properties(tmod.AtmosphereParams.create(CPU), t([np.nan]))
    assert all(np.isnan(np.asarray(v)).all() for v in got)


def test_units_atmosphere(golden_units):
    g = golden_units["atmosphere"]
    tp = tmod.AtmosphereParams.create(CPU)
    got = tmod.atmosphere_properties(tp, t(g["altitudes"]))
    for key in ("temperature", "pressure", "density", "speed_of_sound"):
        close(getattr(got, key), [p[key] for p in g["properties"]])
    close(tmod.gravity_at(tp, t(g["altitudes"])), g["gravity"])


# ------------------------------------------------------------------ motor
@pytest.mark.parametrize("kind", ["solid", "liquid"])
def test_motor_matches_jax(kind, rng):
    tm = (tmod.solid_motor if kind == "solid" else tmod.liquid_motor)(CPU)
    jm = jmod.solid_motor() if kind == "solid" else jmod.liquid_motor()
    burn = float(jm.burn_time)
    ts = np.concatenate([rng.uniform(-2.0, burn + 3.0, 300),
                         [burn, -1e-12, 0.0, burn + 1e-9, float(jm.curve_time[-1])]])
    p = rng.uniform(0.0, 101325.0, ts.size)
    close(tmod.thrust_at(tm, t(ts), t(p)), jmod.thrust_at(jm, jnp.asarray(ts), jnp.asarray(p)),
          atol=1e-9)
    close(tmod.mass_flow_rate_at(tm, t(ts)), jmod.mass_flow_rate_at(jm, jnp.asarray(ts)))
    close(tmod.propellant_remaining(tm, t(ts)),
          jmod.propellant_remaining(jm, jnp.asarray(ts)))
    # the burn bound is inclusive; before ignition there is no thrust
    assert float(tmod.thrust_at(tm, t(burn), t(50000.0))) > 0.0
    assert float(tmod.thrust_at(tm, t(-0.5), t(101325.0))) == 0.0


@pytest.mark.parametrize("kind", ["solid", "liquid"])
def test_motor_parameters_match_jax(kind):
    tm = (tmod.solid_motor if kind == "solid" else tmod.liquid_motor)(CPU)
    jm = jmod.solid_motor() if kind == "solid" else jmod.liquid_motor()
    for f in dataclasses.fields(tm):
        mine, ref = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(mine, torch.Tensor):
            close(mine, ref, rtol=1e-15, atol=0)
        else:
            assert mine == ref, f.name


@pytest.mark.parametrize("kind", ["solid", "liquid"])
def test_units_motor(kind, golden_units):
    m = (tmod.solid_motor if kind == "solid" else tmod.liquid_motor)(CPU)
    g = golden_units["motor"][kind]
    assert float(m.burn_time) == pytest.approx(g["burn_time"], rel=1e-12)
    assert float(m.nozzle_exit_area) == pytest.approx(g["nozzle_exit_area"], rel=1e-12)
    for tt, p, ref in g["thrust"]:
        assert float(tmod.thrust_at(m, tt, t(p))) == pytest.approx(ref, rel=1e-9, abs=1e-9)
    for tt, ref in g["mdot"]:
        assert float(tmod.mass_flow_rate_at(m, tt)) == pytest.approx(ref, rel=1e-12)
    for tt, ref in g["prop_remaining"]:
        assert float(tmod.propellant_remaining(m, tt)) == pytest.approx(ref, rel=1e-12)


# ------------------------------------------------------------------ rocket
@pytest.fixture(scope="module")
def rockets():
    return tmod.RocketParams.create(CPU), jmod.RocketParams.create()


def test_rocket_parameters_match_jax(rockets):
    tr, jr = rockets
    for f in dataclasses.fields(tr):
        mine, ref = getattr(tr, f.name), getattr(jr, f.name)
        if isinstance(mine, torch.Tensor):
            close(mine, ref, rtol=1e-15, atol=0)
        else:
            assert mine == ref, f.name


def test_mass_properties_match_jax(rockets, rng):
    tr, jr = rockets
    frac = np.concatenate([rng.uniform(0.0, 1.0, 100), [0.0, 1.0]])
    got = tmod.mass_properties(tr, t(frac))
    ref = jmod.mass_properties(jr, jnp.asarray(frac))
    for k in ("mass", "center_of_mass", "Ixx", "Iyy", "Izz"):
        close(getattr(got, k), getattr(ref, k), rtol=1e-13)
    close(got.Izz, got.Iyy, rtol=0)


@pytest.mark.parametrize("power_on", [True, False])
def test_aero_coefficients_match_jax(power_on, rockets, rng):
    tr, jr = rockets
    n = 400
    mach = np.concatenate([rng.uniform(0.0, 3.5, n), [0.0, 1.0, 3.5, 0.8]])
    lim = math.radians(60.0)
    alpha = np.concatenate([rng.uniform(-lim, lim, n), [0.0, 0.0, -0.0, math.radians(45)]])
    beta = np.concatenate([rng.uniform(-lim, lim, n), [0.0, 0.3, 0.0, -0.2]])
    cg = rng.uniform(5.4, 5.8, alpha.size)
    got = tmod.aero_coefficients(tr, t(mach), t(alpha), t(beta), center_of_mass=t(cg),
                                 power_on=power_on)
    ref = jmod.aero_coefficients(jr, jnp.asarray(mach), jnp.asarray(alpha),
                                 jnp.asarray(beta), center_of_mass=jnp.asarray(cg),
                                 power_on=power_on)
    for k in ref._fields:
        close(getattr(got, k), getattr(ref, k), atol=1e-12)
    # alpha == 0 exactly: sign(0) = 0, so no stalled lift
    assert float(got.cl[n]) == 0.0


def test_dynamic_cp_matches_jax(rockets, rng):
    tr, jr = rockets
    mach = np.concatenate([rng.uniform(-0.5, 4.0, 100), [0.0, 0.8, 1.0, 1.2, 3.0]])
    close(tmod.dynamic_cp(tr, t(mach)), jmod.dynamic_cp(jr, jnp.asarray(mach)), rtol=1e-13)


def test_units_rocket(rockets, golden_units):
    tr, _ = rockets
    g = golden_units["rocket"]
    assert float(tr.cp_location) == pytest.approx(g["cp_location"], rel=1e-12)
    assert float(tr.reference_area) == pytest.approx(g["reference_area"], rel=1e-12)
    for frac, ref in g["mass_props"].items():
        mp = tmod.mass_properties(tr, t(float(frac)))
        for k in ("mass", "center_of_mass", "Ixx", "Iyy", "Izz"):
            assert float(getattr(mp, k)) == pytest.approx(ref[k], rel=1e-12)
    for frac, ref in g["stability_margin"].items():
        assert float(tmod.stability_margin(tr, t(float(frac)))) == pytest.approx(ref, rel=1e-12)
    for mach, ref in g["dynamic_cp"]:
        assert float(tmod.dynamic_cp(tr, t(mach))) == pytest.approx(ref, rel=1e-12)
    for case in g["aero"]:
        mp = tmod.mass_properties(tr, t(case["frac"]))
        co = tmod.aero_coefficients(tr, case["mach"], case["alpha"], case["beta"],
                                    center_of_mass=mp.center_of_mass,
                                    power_on=case["frac"] > 0)
        for key, ref in case["coeffs"].items():
            assert float(getattr(co, key)) == pytest.approx(ref, rel=RTOL, abs=1e-9), key


# ------------------------------------------------------------------ wind
def test_power_law_profile_matches_jax(rng):
    alt = np.concatenate([[0.0], rng.uniform(0.0, 25000.0, 50)])
    tp, jp = tmod.WindModelParams.create(CPU), jmod.WindModelParams()
    close(tmod.power_law_profile(tp, t(alt), 3.7),
          jmod.power_law_profile(jp, jnp.asarray(alt), 3.7))


@pytest.mark.parametrize("kind", ["stochastic", "perturb", "ar1_batch"])
def test_wind_profiles_with_explicit_noise(kind, rng):
    grid = np.linspace(0.0, 25000.0, 100)
    tp, jp = tmod.WindModelParams.create(CPU), jmod.WindModelParams()
    key = __import__("jax").random.PRNGKey(0)  # unused: noise is explicit
    noise = rng.normal(size=(6, 100, 3))
    speed = rng.uniform(0.0, 5.0, 6)
    direction = rng.uniform(0.0, 2 * math.pi, 6)
    if kind == "stochastic":
        got = tmod.generate_stochastic_profile(tp, t(grid), t(speed), t(direction),
                                               noise=t(noise))
        ref = [jmod.generate_stochastic_profile(jp, key, grid, speed[i], direction[i],
                                                noise=noise[i]) for i in range(6)]
    elif kind == "perturb":
        base = rng.normal(size=(100, 3)) * 5
        got = tmod.perturb_wind_profile(tp, t(grid), t(base), noise=t(noise))
        ref = [jmod.perturb_wind_profile(jp, key, grid, base, noise=noise[i])
               for i in range(6)]
    else:
        mean_uv = rng.normal(size=(6, 100, 2))
        got = torch_ar1_scan(tp, t(grid), t(mean_uv), noise=t(noise))
        ref = [jax_ar1_scan(jp, key, jnp.asarray(grid), jnp.asarray(mean_uv[i]),
                            noise=noise[i]) for i in range(6)]
    close(got, np.stack(ref), atol=1e-12)


def test_wind_generator_draws_reproducible():
    tp = tmod.WindModelParams.create(CPU)
    grid = torch.linspace(0.0, 25000.0, 100, dtype=torch.float64)
    a = tmod.generate_stochastic_profile(tp, grid, 3.0, generator=torch.Generator().manual_seed(5))
    b = tmod.generate_stochastic_profile(tp, grid, 3.0, generator=torch.Generator().manual_seed(5))
    assert a.shape == (100, 3) and torch.equal(a, b)


# ------------------------------------------------------------------ scene, config, state
def test_nominal_scene_matches_jax():
    mine = tmod.nominal_scene(tmod.liquid_motor(CPU))
    ref = scene_from_numpy(jmod.nominal_scene(jmod.liquid_motor()), CPU)
    for part in ("rocket", "motor", "atmosphere", "wind", "wind_model"):
        a, b = getattr(mine, part), getattr(ref, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert x.shape == y.shape, (part, f.name)
                close(x, y, rtol=1e-15, atol=0)
            else:
                assert x == y, (part, f.name)


def test_sim_config_fields_and_defaults_match_jax():
    mine, ref = teng.SimConfig(), jeng.SimConfig()
    assert [f.name for f in dataclasses.fields(mine)] == [
        f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert teng.SimConfig(max_time=6.0).max_steps == jeng.SimConfig(max_time=6.0).max_steps
    with pytest.raises(ValueError):
        teng.SimConfig(integrator="midpoint")


@pytest.mark.parametrize("flag", [
    {"integrator": "rk2"}, {"wind_eval_per_step": True}, {"wind_table_bf16": True},
    {"energy_consistent_aero": True}, {"descent_dt_scale": 4},
    {"ascent_q_threshold": 100.0}, {"terminate_nonfinite": False},
    {"speed_guard": 2000.0},
])
def test_config_flags_match_jax(flag):
    """Each opt-in: the same SimConfig as the JAX package's, and a build of
    the kernel other than the parity one, except ascent_q_threshold, which
    acts only in the tiered loop."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    mine, ref = teng.SimConfig(**flag), jeng.SimConfig(**flag)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (fs.kernel_flags(mine) == fs.PARITY) == ("ascent_q_threshold" in flag)
    tiered = fs.kernel_flags(dataclasses.replace(mine, descent_dt_scale=16))
    assert tiered.tiered and tiered.ascent_gate == ("ascent_q_threshold" in flag)


def test_initial_conditions_match_jax():
    mine = teng.InitialConditions.vertical_launch(CPU)
    ref = ic_from_numpy(jeng.InitialConditions.vertical_launch(), CPU)
    for f in dataclasses.fields(mine):
        close(getattr(mine, f.name), getattr(ref, f.name), rtol=0, atol=0)
    assert mine.position.dtype == torch.float64
