"""PyTorch port, the sampling variants of ``mc.sample_dispersions`` and the
analyzer blocks they add, against the JAX package on the CPU.

Each variant is drawn by the JAX package from ``PRNGKey(SEED)``, and by the
port from the same key, with the JAX package's key structure: the same
lanes. The port is also fed JAX's draws through its seams (``_channels`` the
standard normals and uniforms, ``ops.sobol`` the scramble seeds and
``_sobol_channels`` the points, ``_build_scene`` the turbulence driver, the
Sobol-mode tail and the ensemble members), which checks the assembly alone.
Bars: uniform channels bit for bit, the Sobol normals
within 4 ulp of JAX's, every scene, initial-condition and sample leaf at
rtol 1e-12 in float64 and 1e-5 in float32 (against the leaf's largest
magnitude, for the wind components near zero), members exact.

The analyzer's ``qmc_error``, ``importance``, ``ensemble`` and
``wind_members`` blocks are held to the JAX analyzer's on the same lanes:
its draw reaches the port through ``mc.analyzer._draw_single`` (float64,
``max_time=1.2``, 32 lanes, the outlier bound near the median apogee so
both kinds of lane occur). Every JAX configuration here is drawn at the
same ``n`` and dtype as the analyzer draws it, so each compiles once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu.models.wind import ar1_transfer_matrix as jax_ar1
from erpl_monte_carlo_sim_tpu.models.wind import (
    load_wind_ensemble_from_csvs as jax_load_ensemble)
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.mc import dispersions as D
from erpl_monte_carlo_sim_tpu_torch.models import (WindModelParams, ar1_transfer_matrix,
                                                   liquid_motor, load_wind_ensemble_from_csvs,
                                                   nominal_scene, solid_motor)
from erpl_monte_carlo_sim_tpu_torch.ops import prng
from erpl_monte_carlo_sim_tpu_torch.ops.sobol import sobol_uniform
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)
from test_torch_analyzer import keyset
from test_torch_mc import pairs

torch.set_num_threads(1)

N, N_KNOTS, SEED = 32, 100, 7
GRID = np.linspace(0.0, 25000.0, N_KNOTS)
FORECAST = np.cumsum(np.random.default_rng(99).normal(size=(N_KNOTS, 3)), axis=0)
ENSEMBLE = np.stack([FORECAST, FORECAST + [3.0, 0.0, 0.0], FORECAST - [3.0, 0.0, 0.0]])
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = {
    "antithetic": ({"antithetic": True}, None),
    "importance": ({"importance_shift": {"motor_thrust": 2.0, "mass": -1.0}}, None),
    "ensemble3": ({}, ENSEMBLE),
    "ensemble1": ({}, FORECAST[None]),
    "sobol": ({"sampler": "sobol", "sobol_scrambles": 4, "sobol_wind_modes": 2}, None),
    "sobol_forecast": ({"sampler": "sobol", "sobol_wind_modes": 3}, ENSEMBLE),
    "antithetic_ensemble": ({"antithetic": True}, ENSEMBLE),
}
# (case, dtype): float64 for every case but the Sobol draw over an ensemble,
# float32 for that one and the antithetic ensemble, which together cover
# every branch of the float32 arithmetic
VARIANTS = [(c, torch.float64) for c in CASES if c != "sobol_forecast"] + [
    (c, torch.float32) for c in ("sobol_forecast", "antithetic_ensemble")]


def jax_kwargs(kw):
    """The JAX sampler's spelling: the shift as sorted pairs."""
    kw = dict(kw)
    if "importance_shift" in kw:
        kw["importance_shift"] = tuple(sorted(kw["importance_shift"].items()))
    return kw


def scenes(dtype):
    """The JAX and port nominal liquid scene and launch in ``dtype``."""
    js, jic = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
    if dtype == torch.float32:
        def cast(x):
            x = jnp.asarray(x)
            return x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x
        js, jic = jax.tree.map(cast, js), jax.tree.map(cast, jic)
    return js, jic, scene_from_numpy(js, "cpu"), ic_from_numpy(jic, "cpu")


def jax_draws(key, n, dtype, kw, base_wind):
    """What the JAX sampler drew for ``key``, as the port's seam inputs:
    ``(std or None, sobol seeds or None, extras for _build_scene)``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    keys = jax.random.split(key, 12)
    turb_key = keys[11]
    extra = {}
    ensemble = base_wind is not None and np.ndim(base_wind[1]) == 3
    if ensemble:
        extra["member"] = np.array(jax.random.randint(
            jax.random.fold_in(turb_key, 2), (n,), 0, np.shape(base_wind[1])[0],
            dtype=jnp.int32))
    modes = kw.get("sobol_wind_modes", 0)
    if modes:
        extra["b_tail"] = np.array(jax.random.normal(
            jax.random.fold_in(turb_key, 1), (n, N_KNOTS - modes, 3), dtype=jdt))
    else:
        synthesized = base_wind is None

        def lane(k):  # a synthesized profile splits its lane key first
            return jax.random.normal(jax.random.split(k)[1] if synthesized else k,
                                     (N_KNOTS, 3), dtype=jdt)

        extra["noise"] = np.array(jax.vmap(lane)(jax.random.split(turb_key, n)))
    if kw.get("sampler") == "sobol":
        d = 19 + 3 * modes
        seeds = np.array(jax.random.bits(keys[0], (kw.get("sobol_scrambles", 1), d),
                                           "uint32")).astype(np.int64)
        return None, seeds, extra

    def z(k, shape):
        return np.array(jax.random.normal(k, shape, dtype=jdt))

    std = {"pos_off": z(keys[0], (n, 3)), "vel_off": z(keys[1], (n, 3)),
           "att_off": z(keys[2], (n, 3)), "omg_off": z(keys[3], (n, 3)),
           "mass_mult": z(keys[4], (n,)), "thrust_mult_recorded": z(keys[5], (n,)),
           "motor_thrust_mult": z(keys[6], (n,)), "motor_flow_mult": z(keys[7], (n,)),
           "wind_speed": np.array(jax.random.uniform(keys[8], (n,), dtype=jdt)),
           "wind_dir": np.array(jax.random.uniform(keys[9], (n,), dtype=jdt)),
           "density_mult": z(keys[10], (n,))}
    return std, None, extra


def port_lanes(ts, tic, dtype, kw, base_wind, std, seeds, extra):
    """The port's lanes from the JAX draws, through its seams."""
    tb = None if base_wind is None else tuple(torch.as_tensor(x, dtype=dtype)
                                              for x in base_wind)
    grid = torch.as_tensor(GRID, dtype=dtype)
    if seeds is not None:
        d = seeds.shape[1]
        u = sobol_uniform(None, N, d, seeds.shape[0], dtype, seeds=torch.as_tensor(seeds))
        ch = D._sobol_channels(u, ts, D.UncertaintyParams(), kw.get("sobol_wind_modes", 0),
                               GRID)
    else:
        ch = D._channels({k: torch.as_tensor(v) for k, v in std.items()}, ts,
                         D.UncertaintyParams(), kw.get("antithetic", False),
                         tuple(sorted(kw.get("importance_shift", {}).items())))
    ch.update({k: torch.as_tensor(v) for k, v in extra.items()})
    return D._build_scene(ts, tic, ch, tb, grid), ch


@pytest.fixture(scope="module")
def variant(request):
    case, dtype = request.param
    kw, ens = CASES[case]
    base_wind = None if ens is None else (GRID, ens)
    js, jic, ts, tic = scenes(dtype)
    key = jax.random.PRNGKey(SEED)
    # float64 as the analyzer draws it (dtype None), so the compile is shared
    ref = jax_sample(key, js, jic, n=N, base_wind=base_wind,
                     dtype=jnp.float32 if dtype == torch.float32 else None, **jax_kwargs(kw))
    std, seeds, extra = jax_draws(key, N, dtype, kw, base_wind)
    got, ch = port_lanes(ts, tic, dtype, kw, base_wind, std, seeds, extra)
    from_key = D.sample_dispersions(prng.prng_key(SEED), ts, tic, n=N, base_wind=base_wind,
                                    **kw)
    return case, dtype, ref, got, ch, seeds, from_key


def same_lanes(case, dtype, mine_lanes, ref_lanes):
    """Every scene, initial-condition and sample leaf at the dtype's bar
    (against the leaf's largest magnitude); returns how many were held."""
    n_leaves = 0
    for mine_obj, ref_obj in zip(mine_lanes, ref_lanes):
        for path, mine, ref in pairs(mine_obj, ref_obj):
            if not isinstance(mine, torch.Tensor):
                assert mine == ref, path
                continue
            ref = np.asarray(ref)
            assert tuple(mine.shape) == ref.shape, path
            scale = max(float(np.abs(ref).max()), 1e-300) if ref.size else 1.0
            np.testing.assert_allclose(mine.numpy(), ref, rtol=RTOL[dtype],
                                       atol=RTOL[dtype] * scale, err_msg=f"{case}{path}")
            n_leaves += 1
    return n_leaves


@pytest.mark.parametrize("variant", VARIANTS, indirect=True,
                         ids=[f"{c}-{str(d).split('.')[-1]}" for c, d in VARIANTS])
def test_variant_matches_jax(variant):
    case, dtype, (js, jic, jsample), (ts, tic, tsample), ch, seeds, _ = variant
    # uniform channels bit for bit, members exact
    for f in ("wind_speed", "wind_direction", "wind_member"):
        np.testing.assert_array_equal(getattr(tsample, f).numpy(),
                                      np.asarray(getattr(jsample, f)), err_msg=f)
    if seeds is not None:  # the Sobol normals within 4 ulp of JAX's ndtri
        from jax.scipy.special import ndtri

        u = sobol_uniform(None, N, seeds.shape[1], seeds.shape[0], dtype,
                          seeds=torch.as_tensor(seeds))
        mine = D._sobol_draws(u)
        ref = np.asarray(ndtri(jnp.asarray(u.numpy())))
        for name, col in (("vel_off", slice(3, 6)), ("mass_mult", 12), ("density_mult", 18)):
            a, b = mine[name].numpy(), ref[:, col]
            assert (np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max() <= 4, name
    assert same_lanes(case, dtype, (ts, tic, tsample), (js, jic, jsample)) > 50
    if CASES[case][0].get("antithetic"):
        # offsets and uniforms mirror exactly; a multiplier mirrors its
        # offset from 1 before the 1 is added, so within an ulp of 1
        for name, center in (("wind_speed", 2.5), ("vel_off", 0.0)):
            half = ch[name][: N // 2]
            assert torch.equal(ch[name][N // 2:], 2 * center - half), name
        eps = float(torch.finfo(dtype).eps)
        torch.testing.assert_close(ch["mass_mult"][N // 2:], 2.0 - ch["mass_mult"][: N // 2],
                                   rtol=0.0, atol=eps)


@pytest.mark.parametrize("variant", VARIANTS, indirect=True,
                         ids=[f"{c}-{str(d).split('.')[-1]}" for c, d in VARIANTS])
def test_variant_from_key_is_jax(variant):
    """The port's own draw under ``PRNGKey(SEED)``, no seam: the JAX
    package's lanes at the same bars, uniforms and members exact."""
    case, dtype, ref, _, _, _, from_key = variant
    for f in ("wind_speed", "wind_direction", "wind_member"):
        np.testing.assert_array_equal(getattr(from_key[2], f).numpy(),
                                      np.asarray(getattr(ref[2], f)), err_msg=f)
    assert same_lanes(case, dtype, from_key, ref) > 50


def test_one_member_ensemble_is_the_single_forecast():
    """The member draw comes after every other draw of the lane set, so a
    K=1 ensemble gives the single forecast's lanes bit for bit, on both
    samplers."""
    scene = nominal_scene(liquid_motor("cpu"))
    ic = InitialConditions.vertical_launch("cpu")
    for kw in ({}, {"sampler": "sobol", "sobol_scrambles": 2, "sobol_wind_modes": 4}):
        one = D.sample_dispersions(prng.prng_key(3), scene, ic, n=16,
                                   base_wind=(GRID, FORECAST), **kw)
        ens = D.sample_dispersions(prng.prng_key(3), scene, ic, n=16,
                                   base_wind=(GRID, FORECAST[None]), **kw)
        assert torch.equal(one[0].wind.wind, ens[0].wind.wind)
        assert torch.equal(one[2].mass_multiplier, ens[2].mass_multiplier)
        assert not ens[2].wind_member.any()
        three = D.sample_dispersions(prng.prng_key(3), scene, ic, n=16,
                                     base_wind=(GRID, ENSEMBLE), **kw)
        assert set(three[2].wind_member.tolist()) == {0, 1, 2}


def test_generator_draws_are_deterministic_and_mirrored():
    scene = nominal_scene(liquid_motor("cpu"))
    ic = InitialConditions.vertical_launch("cpu")
    for kw in ({"antithetic": True}, {"sampler": "sobol", "sobol_scrambles": 4},
               {"importance_shift": {"density": 1.5}}):
        a = D.sample_dispersions(prng.prng_key(5), scene, ic, n=8, **kw)
        b = D.sample_dispersions(prng.prng_key(5), scene, ic, n=8, **kw)
        c = D.sample_dispersions(prng.prng_key(6), scene, ic, n=8, **kw)
        assert torch.equal(a[0].wind.wind, b[0].wind.wind)
        assert torch.equal(a[2].wind_speed, b[2].wind_speed)
        assert not torch.equal(a[2].wind_speed, c[2].wind_speed)
    s = D.sample_dispersions(prng.prng_key(5), scene, ic, n=8, antithetic=True)
    lo, hi = D.UncertaintyParams().wind_direction_range
    assert torch.equal(s[2].wind_direction[4:], 2 * (0.5 * (lo + hi)) - s[2].wind_direction[:4])
    torch.testing.assert_close(s[2].density_multiplier[4:], 2.0 - s[2].density_multiplier[:4],
                               rtol=0.0, atol=float(torch.finfo(torch.float64).eps))
    # the turbulence stays independent: the pairs' tables differ beyond the mirror
    assert not torch.equal(s[0].wind.wind[4:, :, 2], -s[0].wind.wind[:4, :, 2])


@pytest.mark.parametrize("kw,base_wind", [
    ({"antithetic": True, "n": 7}, None),
    ({"sampler": "qmc"}, None),
    ({"sampler": "sobol", "antithetic": True}, None),
    ({"sampler": "sobol", "sobol_scrambles": 3, "n": 16}, None),
    ({"sobol_scrambles": 0}, None),
    ({"sobol_wind_modes": 2}, None),
    ({"sampler": "sobol", "sobol_wind_modes": 300}, None),
    ({"importance_shift": {"thrust": 1.0}}, None),
    ({"importance_shift": {"mass": 1.0}, "sampler": "sobol"}, None),
    ({"importance_shift": {"mass": 1.0}, "antithetic": True}, None),
    ({"importance_shift": {"motor_flow": 1.0}, "motor": "solid"}, None),
    ({}, (GRID, np.zeros((N_KNOTS, 2)))),
    ({}, (GRID, np.zeros((0, N_KNOTS, 3)))),
], ids=["odd-antithetic", "sampler", "sobol-antithetic", "scrambles", "scrambles0",
        "modes-prng", "dims", "channel", "shift-sobol", "shift-antithetic", "inert-flow",
        "wind-shape", "no-member"])
def test_validation_messages_match_jax(kw, base_wind):
    kw = dict(kw)
    n = kw.pop("n", 8)
    solid = kw.pop("motor", "liquid") == "solid"
    js = jax_nominal(jax_solid() if solid else jax_liquid())
    ts = nominal_scene((solid_motor if solid else liquid_motor)("cpu"))
    with pytest.raises(ValueError) as ref:
        jax_sample(jax.random.PRNGKey(0), js, JaxIC.vertical_launch(), n=n,
                   base_wind=base_wind, **jax_kwargs(kw))
    with pytest.raises(ValueError) as got:
        D.sample_dispersions(prng.prng_key(0), ts, InitialConditions.vertical_launch("cpu"),
                             n=n, base_wind=base_wind, **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("grid", [GRID, np.array([0.0, 5.0, 5.0, 400.0, 12000.0]),
                                  np.linspace(-500.0, 3000.0, 37)],
                         ids=["uniform", "repeated-knot", "negative"])
def test_ar1_transfer_matrix_matches_jax(grid):
    from erpl_monte_carlo_sim_tpu.models import WindModelParams as JaxWindParams

    got = ar1_transfer_matrix(WindModelParams.create("cpu", torch.float64), grid)
    ref = jax_ar1(JaxWindParams(), grid)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    assert np.array_equal(got, np.tril(got))


def test_load_wind_ensemble_matches_jax(tmp_path):
    def write(path, grid, wind):
        with open(path, "w") as f:
            f.write("altitude,u,v,w\n")
            for h, (u, v, w) in zip(grid, wind):
                f.write(f"{h},{u},{v},{w}\n")

    g2 = np.linspace(-500.0, 30000.0, 17)
    write(tmp_path / "a.csv", GRID, FORECAST)
    write(tmp_path / "b.csv", g2, np.stack([g2 / 1000.0, -g2 / 2000.0, 0.0 * g2], axis=1))
    paths = [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")]
    grid, ens = load_wind_ensemble_from_csvs(paths)
    rgrid, rens = jax_load_ensemble(paths)
    np.testing.assert_array_equal(grid, rgrid)
    np.testing.assert_allclose(ens, rens, rtol=1e-12, atol=1e-12)
    assert ens.shape == (2, N_KNOTS, 3)
    with pytest.raises(ValueError, match="at least one"):
        load_wind_ensemble_from_csvs([])


# ---------------------------------------------------------------- analyzer
WINDOW = 1.2
MIN_APOGEE = 45.0  # near the window's median apogee
BLOCKS = {
    "sobol": CASES["sobol"],
    "importance": CASES["importance"],
    "ensemble3": CASES["ensemble3"],
}


@pytest.fixture(scope="module", params=list(BLOCKS))
def analyses(request):
    kw, ens = BLOCKS[request.param]
    js, jic = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
    ref_mc = JaxAnalyzer(scene=js, sim_config=JaxConfig(max_time=WINDOW),
                         bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False, **kw)
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE), **kw)
    if ens is not None:
        ref_mc.base_altitude_profile = mc.base_altitude_profile = GRID
        ref_mc.base_wind_profile = mc.base_wind_profile = ens
    ref = ref_mc.run_monte_carlo(jic, n_samples=N, seed=SEED)

    def jax_single(analyzer, ic, n, seed, base_wind):
        scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), js, jic, n=n,
                                           base_wind=base_wind, **jax_kwargs(kw))
        return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
                sample_from_numpy(sample, "cpu"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        got = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=N,
                                 seed=SEED)
    return request.param, got, ref


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-9, atol=0.0, err_msg=what)


def test_analysis_blocks_match_jax(analyses):
    case, got, ref = analyses
    assert keyset(got) == keyset(ref)
    np.testing.assert_array_equal(got["valid_mask"], ref["valid_mask"])
    assert 0 < got["n_samples"] < N
    block = {"sobol": "qmc_error", "importance": "importance", "ensemble3": "ensemble"}[case]
    assert block in got
    if case == "sobol":
        for k, v in ref["qmc_error"].items():
            assert len(got["qmc_error"][k]["block_means"]) == 4
            close(got["qmc_error"][k]["block_means"], v["block_means"], k)
            close(got["qmc_error"][k]["mean_stderr"], v["mean_stderr"], k)
    elif case == "importance":
        imp, rimp = got["importance"], ref["importance"]
        assert imp["shift"] == rimp["shift"] and imp["note"] == rimp["note"]
        close(imp["log_weights"], rimp["log_weights"], "log_weights")
        for k in ("apogee_altitude", "range", "flight_time"):
            for s in ("mean", "stderr", "n_eff", "n"):
                close(imp[k][s], rimp[k][s], f"{k}.{s}")
    else:
        np.testing.assert_array_equal(got["wind_members"], ref["wind_members"])
        ens, rens = got["ensemble"], ref["ensemble"]
        assert ens["n_members"] == rens["n_members"] == 3
        for row, rrow in zip(ens["members"], rens["members"]):
            assert (row["member"], row["n_drawn"], row["n_valid"]) == \
                (rrow["member"], rrow["n_drawn"], rrow["n_valid"])
            for k in ("apogee_altitude", "range", "flight_time"):
                assert row[k]["n"] == rrow[k]["n"]
                close([row[k]["mean"], row[k]["std"]], [rrow[k]["mean"], rrow[k]["std"]], k)
        for k, v in rens["post_stratified"].items():
            close([ens["post_stratified"][k]["mean"], ens["post_stratified"][k]["stderr"]],
                  [v["mean"], v["stderr"]], k)
    for k in ("apogee_altitude", "range", "flight_time"):
        close(got[k]["mean"], ref[k]["mean"], k)


def test_analysis_of_the_sampler_on_the_port_generator():
    """The same options drawn by the port's own threefry draw: the blocks
    are present and finite where they should be."""
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE), sampler="sobol",
                            sobol_scrambles=4)
    a = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=16, seed=1)
    q = a["qmc_error"]["apogee_altitude"]
    assert len(q["block_means"]) == 4 and np.isfinite(q["mean_stderr"])
    assert dataclasses.is_dataclass(a["sample"])


@pytest.mark.parametrize("shift", [{"motor_thrust": 2.0}, {"mass": -1.0, "density": 0.5}, {}],
                         ids=["thrust", "mass-density", "none"])
def test_log_weights_and_weighted_mean_match_jax(shift):
    from erpl_monte_carlo_sim_tpu.mc import importance as JI
    from erpl_monte_carlo_sim_tpu_torch.mc import importance as TI

    rng = np.random.default_rng(3)
    n = 400
    sample = D.DispersionSample(**{f.name: torch.as_tensor(1.0 + 0.05 * rng.normal(size=n))
                                   for f in dataclasses.fields(D.DispersionSample)})
    motor, jmotor = liquid_motor("cpu"), jax_liquid()
    lw = TI.log_weights(sample, D.UncertaintyParams(), motor, tuple(shift.items()))
    ref = JI.log_weights(sample_from_numpy(sample, "cpu"), D.UncertaintyParams(), jmotor,
                         tuple(shift.items()))
    np.testing.assert_allclose(lw, ref, rtol=1e-12, atol=1e-12)
    values = rng.normal(100.0, 5.0, n)
    values[:7] = np.nan
    mask = rng.random(n) > 0.1
    got, want = TI.weighted_mean(values, mask, lw), JI.weighted_mean(values, mask, ref)
    assert got.keys() == want.keys() and got["n"] == want["n"] == n
    for k in ("mean", "stderr", "n_eff"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("option,lane_slab", [
    ({"sampler": "sobol", "sobol_scrambles": 2, "sobol_wind_modes": 2}, 8),
    ({"antithetic": True}, None),
    ({"importance_shift": {"motor_thrust": 1.5}}, 8),
], ids=["sobol-slabbed", "antithetic", "importance-slabbed"])
def test_resimulated_variant_lanes_are_the_runs(option, lane_slab):
    """Lanes of a variant run over a forecast ensemble fly again to the
    run's summaries bit for bit, drawn again with the run's members."""
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=0.5),
                            bounds=OutlierBounds(min_apogee=0.0), **option)
    mc.base_altitude_profile, mc.base_wind_profile = GRID, ENSEMBLE
    ic = InitialConditions.vertical_launch("cpu")
    a = mc.run_monte_carlo(ic, n_samples=24, seed=4, lane_slab=lane_slab)
    ids = [1, 10, 23]
    summary, _ = mc.resimulate_trajectories(ids)
    run = a["metrics"] if lane_slab else {k: getattr(a["summary"], k) for k in
                                          ("apogee_altitude", "range", "flight_time")}
    for k in ("apogee_altitude", "range", "flight_time"):
        np.testing.assert_array_equal(getattr(summary, k).numpy(), np.asarray(run[k])[ids],
                                      err_msg=k)
    if lane_slab:
        members = [int(analyzer_mod._draw_slab(mc, ic, g // lane_slab, lane_slab, 4,
                                               (GRID, ENSEMBLE))[2].wind_member[g % lane_slab])
                   for g in ids]
    else:  # the single call keeps its batch
        for lane, g in zip(mc.lane_scenes(ids), ids):
            assert torch.equal(lane.wind.wind, mc._last_batch[0].wind.wind[g])
        members = a["sample"].wind_member[ids].tolist()
    assert members == a["wind_members"][ids].tolist()
