"""PyTorch port, the collectives of ``parallel/`` over Gloo ranks on the CPU,
against the JAX package's ``parallel`` on its 8-device virtual CPU mesh
(conftest.py) and against the port's single-device functions.

Every input is made with NumPy from a seed (tests/test_parallel.py's cases)
and each rank takes its contiguous block (``shard_batch``). One group of 2
and one of 4 ranks are spawned once each (``run_ranks``), and every check's
collective runs inside that one spawn (``collectives``); the tests read its
results. The ranks import this module, which imports no JAX: the JAX side
runs here, in the parent, in threads beside the ranks. Bars: moments rel
1e-12; ``percentile_ci``, tail reservoirs and integer counts bit for bit;
the histogram path's interval ends within ``range / n_bins**2`` of the exact
values and its percentiles within 1e-4 sigma; the envelope at
tests/test_envelope.py's.
"""

import math
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, TailReservoir
from erpl_monte_carlo_sim_tpu_torch.mc import masked_stats, percentile_ci
from erpl_monte_carlo_sim_tpu_torch.mc.envelope import EnvelopeAccumulator, EnvelopeConfig
from erpl_monte_carlo_sim_tpu_torch.mc.stats import FootprintAccumulator
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.parallel import (
    collective_cv_moments, collective_envelope, collective_footprint,
    collective_footprint_moments, collective_stats, collective_tail_carry,
    collective_tail_extremes, collective_tail_reservoir, make_global_batch, pad_to_devices,
    replicate, run_ranks, shard_batch, tail_reservoir_from_carry)

torch.set_num_threads(1)

CI_SIZES = (24, 200, 5000)
HIST_N, HIST_THRESHOLD, HIST_BINS = 262_144, 1024, 4096
RESERVOIR_KS = (16, 64, 200)   # 200 > the 160 (80 in JAX) lanes of a shard
CARRY_KS = (64, 4096)          # 4096 > 3 x 640: the padding must drop
CV_KNOTS, CV_N = 10, 96
CV = {"control_variates": True, "cv_wind_modes": 2, "cv_wind_speed": 3}
ENV = dict(bin_dt=0.25, channels=("altitude", "mach"))
ENV_MAX_TIME = 2.0
WORLDS = (2, 4)
P_BATCH, P_SHARED = "PartitionSpec('batch',)", "PartitionSpec()"


def cases() -> dict:
    """Every check's inputs, NumPy from seeds (tests/test_parallel.py's)."""
    out = {}
    rng = np.random.default_rng(0)
    out["stats"] = (rng.normal(5000.0, 800.0, size=640), rng.uniform(size=640) > 0.25)
    for n in CI_SIZES:
        r = np.random.default_rng(n)
        out[f"ci{n}"] = (r.normal(100.0, 7.0, size=n), r.uniform(size=n) > 0.1)
    r = np.random.default_rng(0)
    out["hist"] = (r.normal(5000.0, 800.0, size=HIST_N), r.uniform(size=HIST_N) > 0.25)
    out["degenerate"] = (np.full(4096, 1234.5), np.arange(4096) % 3 != 0)
    out["f32"] = np.random.default_rng(3).normal(100.0, 0.1, size=1024).astype(np.float32)
    r = np.random.default_rng(7)
    landing = r.multivariate_normal([4200.0, -730.0],
                                    [[250.0 ** 2, 9000.0], [9000.0, 90.0 ** 2]], size=640)
    landing = np.concatenate([landing, np.full((640, 1), 123.0)], axis=1)
    mask = r.uniform(size=640) > 0.25
    landing[5, 0] = np.nan
    out["footprint"] = (landing, mask)
    r = np.random.default_rng(3)
    vals = r.normal(25_000.0, 800.0, size=640)
    vals[::71] = np.nan
    out["reservoir"] = (vals, r.uniform(size=640) > 0.2)
    r = np.random.default_rng(5)
    slabs = []
    for _ in range(3):
        v = r.normal(25_000.0, 800.0, size=640)
        v[::97] = np.nan
        slabs.append(v)
    out["carry"] = slabs
    r = np.random.default_rng(11)
    b, t = 16, 40
    time = np.cumsum(r.uniform(0.02, 0.08, (b, t)), axis=1)
    valid = (np.arange(t)[None, :] < r.integers(20, t + 1, b)[:, None]) & (
        r.uniform(size=(b, t)) < 0.95)
    vel = r.normal(0.0, 30.0, (b, t, 3)) + np.array([0.0, 0.0, 200.0])
    speed = np.sqrt((vel ** 2).sum(-1))
    mach = speed / 340.0
    mach[3, 7] = np.nan
    out["trajectory"] = {
        "time": time, "valid": valid,
        "position": np.stack([r.normal(0, 5, (b, t)), r.normal(0, 5, (b, t)),
                              np.cumsum(r.uniform(5, 15, (b, t)), axis=1)], axis=-1),
        "velocity": vel, "quaternion": r.normal(size=(b, t, 4)),
        "angular_velocity": r.normal(size=(b, t, 3)),
        "propellant_fraction": r.uniform(size=(b, t)),
        "derived": {"speed": speed, "mach": mach}}
    return out


def cv_inputs():
    """JAX-drawn lanes on a 10-knot grid with a forecast's wind and made-up
    summaries with invalid, non-finite and padding lanes
    (tests/test_torch_cv.py's), for both packages."""
    import jax

    from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
    from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
    from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import sample_from_numpy, scene_from_numpy

    grid = np.linspace(0.0, 25000.0, CV_KNOTS)
    forecast = np.cumsum(np.random.default_rng(5).normal(size=(CV_KNOTS, 3)), axis=0)
    scene_b, _, sample = jax_sample(jax.random.PRNGKey(3), jax_nominal(jax_liquid()),
                                    JaxIC.vertical_launch(), n=CV_N,
                                    base_wind=(grid, forecast), wind_grid_points=CV_KNOTS)
    rng = np.random.default_rng(1)
    s = {"apogee_altitude": rng.normal(60.0, 5.0, CV_N), "range": rng.normal(3.0, 1.0, CV_N),
         "flight_time": rng.normal(1.2, 0.01, CV_N),
         "landing_position": rng.normal(size=(CV_N, 3))}
    s["apogee_altitude"][3] = np.nan
    s["range"][7] = np.inf
    s["landing_position"][11, 1] = np.nan
    valid = rng.random(CV_N) > 0.3
    include = np.arange(CV_N) < CV_N - 8
    port = {"scene_b": scene_from_numpy(scene_b, "cpu"),
            "sample": sample_from_numpy(sample, "cpu"),
            "summary": {k: torch.as_tensor(v) for k, v in s.items()},
            "valid": torch.as_tensor(valid), "include": torch.as_tensor(include),
            "base_wind": (grid, forecast)}
    return port, (scene_b, sample, s, valid, include, (grid, forecast))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, TailReservoir):
        return {"n": x.n, "hi": x.hi, "lo": x.lo}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def collectives(mesh, inp: dict, cv: dict) -> dict:
    """One rank's part of every check: its block of each input through the
    port's collectives. Returns the results, NumPy."""
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import trajectory_from_numpy

    torch.set_num_threads(1)

    def shard(x):
        x = torch.as_tensor(x)
        return shard_batch(x, mesh, x.shape[0])

    out = {}
    v, m = inp["stats"]
    out["stats"] = collective_stats(shard(v), shard(m), mesh)
    for n in CI_SIZES:
        v, m = inp[f"ci{n}"]
        out[f"ci{n}"] = collective_stats(shard(v), shard(m), mesh)
    v, m = inp["hist"]
    out["hist"] = collective_stats(shard(v), shard(m), mesh,
                                   exact_percentile_threshold=HIST_THRESHOLD,
                                   percentile_bins=HIST_BINS)
    out["hist_default"] = collective_stats(shard(v), shard(m), mesh)
    v, m = inp["degenerate"]
    out["degenerate"] = collective_stats(shard(v), shard(m), mesh, exact_percentile_threshold=64)
    out["f32"] = collective_stats(shard(inp["f32"]), None, mesh)
    landing, m = inp["footprint"]
    out["footprint_moments"] = collective_footprint_moments(shard(landing), shard(m), mesh)
    out["footprint"] = collective_footprint(shard(landing), shard(m), mesh)
    out["footprint_all"] = collective_footprint(shard(landing), None, mesh)
    v, m = inp["reservoir"]
    for k in RESERVOIR_KS:
        out[f"reservoir{k}"] = collective_tail_reservoir(shard(v), shard(m), mesh, k=k)
    out["extremes"] = collective_tail_extremes(shard(v), shard(m), mesh, k=16)
    for k in CARRY_KS:
        carry, n_tot = None, 0
        for vals in inp["carry"]:
            cnt, carry = collective_tail_carry(shard(vals), None, mesh, carry, k=k)
            n_tot += int(cnt)
        out[f"carry{k}"] = tail_reservoir_from_carry(carry, n_tot)
    for name, n_local in (("uneven", 5 if mesh.rank == 0 else 4), ("empty", 0)):
        for fn in (collective_tail_extremes, collective_tail_carry, collective_tail_reservoir):
            try:
                fn(torch.ones(n_local, dtype=torch.float64), None, mesh, k=4)
                out[f"{name} {fn.__name__}"] = "no error"
            except ValueError as e:
                out[f"{name} {fn.__name__}"] = str(e)

    # control-variate moments: the shard's sample, wind controls and summary
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), wind_grid_points=CV_KNOTS, **CV)
    scene_s = shard_batch(cv["scene_b"], mesh, CV_N, base_tree=mc.scene)
    sample_s = shard_batch(cv["sample"], mesh, CV_N)
    summary_s = types.SimpleNamespace(**shard_batch(cv["summary"], mesh, CV_N))
    out["cv"] = collective_cv_moments(
        sample_s, summary_s, shard(cv["valid"]), shard(cv["include"]), mc.uncertainty_params,
        mc.scene.motor, mesh, mc._cv_wind_ctrl(scene_s, sample_s, cv["base_wind"]))
    out["cv_names"] = mc._cv_names()

    traj = trajectory_from_numpy(inp["trajectory"], "cpu")
    traj_s = shard_batch(traj, mesh, traj.time.shape[0])
    out["envelope"] = collective_envelope(traj_s, mesh, env=EnvelopeConfig(**ENV),
                                          max_time=ENV_MAX_TIME)

    # make_global_batch: a shared leaf as long as the local batch
    local = 8
    tree = {"batched": torch.full((local, 3), float(mesh.rank)),
            "shared_grid": torch.arange(local, dtype=torch.float32)}
    base = {"batched": torch.zeros(3), "shared_grid": torch.arange(local, dtype=torch.float32)}
    out["global_base"] = make_global_batch(tree, mesh, local, base_tree=base)
    out["global_shape_rule"] = make_global_batch(tree, mesh, local)
    try:
        make_global_batch({"shared": torch.tensor([float(mesh.rank)])}, mesh, local,
                          base_tree={"shared": torch.zeros(1)})
        out["global_mismatch"] = "no error"
    except ValueError as e:
        out["global_mismatch"] = str(e)
    out["replicated"] = replicate({"rank": torch.tensor([mesh.rank]),
                                   "pair": (np.full(2, mesh.rank + 0.5),)}, mesh)
    out["padded"] = (mesh.shape, pad_to_devices(17, mesh), pad_to_devices(16, mesh))
    return _np(out)


def jax_collectives(inp: dict) -> dict:
    """The JAX package's stats, footprint and tail collectives on its
    8-device CPU mesh, on the same inputs."""
    import jax
    import jax.numpy as jnp

    from erpl_monte_carlo_sim_tpu import parallel as jp

    mesh = jp.make_mesh(n_devices=8)
    out = {}
    v, m = inp["stats"]
    out["stats"] = jax.device_get(jp.collective_stats(jnp.asarray(v), jnp.asarray(m), mesh))
    landing, m = inp["footprint"]
    out["footprint_moments"] = jp.collective_footprint_moments(jnp.asarray(landing),
                                                               jnp.asarray(m), mesh)
    v, m = inp["reservoir"]
    k = RESERVOIR_KS[-1]  # past a shard's lanes (a compile per call: one k)
    out[f"reservoir{k}"] = jp.collective_tail_reservoir(jnp.asarray(v), jnp.asarray(m), mesh,
                                                        k=k)
    carry, n_tot = None, 0
    for vals in inp["carry"]:
        cnt, carry = jp.collective_tail_carry(jnp.asarray(vals), None, mesh, carry,
                                              k=CARRY_KS[0])
        n_tot += int(cnt)
    out[f"carry{CARRY_KS[0]}"] = jp.tail_reservoir_from_carry(carry, n_tot)
    local = 8
    tree = {"batched": np.zeros((local, 3), np.float32),
            "shared_grid": np.arange(local, dtype=np.float32)}
    base = {"batched": np.zeros((3,), np.float32),
            "shared_grid": np.arange(local, dtype=np.float32)}
    out["global_base"] = {k: str(x.sharding.spec) for k, x in
                          jp.make_global_batch(tree, mesh, local, base_tree=base).items()}
    out["global_shape_rule"] = {k: str(x.sharding.spec) for k, x in
                                jp.make_global_batch(tree, mesh, local).items()}
    return out


def jax_cv(lanes) -> dict:
    """The JAX package's CV moments on its 8-device CPU mesh."""
    import collections

    import jax.numpy as jnp

    from erpl_monte_carlo_sim_tpu import parallel as jp
    from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
    from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
    from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal

    scene_b, sample, s, valid, include, base_wind = lanes
    mesh = jp.make_mesh(n_devices=8)
    jmc = JaxAnalyzer(scene=jax_nominal(jax_liquid()), persistent_cache=False,
                      wind_grid_points=CV_KNOTS, **CV)
    summary = collections.namedtuple("J", list(s))(**{k: jnp.asarray(x) for k, x in s.items()})
    return {"cv": jp.collective_cv_moments(
        sample, summary, jnp.asarray(valid), jnp.asarray(include), jmc.uncertainty_params,
        jmc.scene.motor, mesh, jmc._cv_wind_ctrl(scene_b, sample, base_wind)),
        "cv_names": jmc._cv_names()}


def jax_envelope(inp: dict) -> dict:
    """The JAX package's envelope of the trajectory on its 8-device CPU mesh."""
    import jax.numpy as jnp

    from erpl_monte_carlo_sim_tpu import parallel as jp
    from erpl_monte_carlo_sim_tpu.engine.simulate import Trajectory as JaxTrajectory
    from erpl_monte_carlo_sim_tpu.mc import EnvelopeConfig as JaxEnvConfig

    tr = inp["trajectory"]
    traj = JaxTrajectory(**{k: jnp.asarray(x) for k, x in tr.items() if k != "derived"},
                         derived={k: jnp.asarray(x) for k, x in tr["derived"].items()})
    return {"envelope": jp.collective_envelope(traj, jp.make_mesh(n_devices=8),
                                               env=JaxEnvConfig(**ENV), max_time=ENV_MAX_TIME)}


@pytest.fixture(scope="module")
def everything():
    """The port's collectives on a spawned Gloo group of each size and the
    JAX package's on its mesh, all four at once (the ranks are processes;
    XLA compiles with the interpreter lock released)."""
    inp = cases()
    with ThreadPoolExecutor(5) as ex:
        ref = [ex.submit(jax_collectives, inp), ex.submit(jax_envelope, inp)]
        port_cv, jax_lanes = cv_inputs()
        port = {w: ex.submit(run_ranks, collectives, w, inp, port_cv, device="cpu",
                             timeout_s=300) for w in WORLDS}
        ref.append(ex.submit(jax_cv, jax_lanes))
        port = {w: f.result() for w, f in port.items()}
        jax_ref = {k: v for f in ref for k, v in f.result().items()}
    return inp, port, jax_ref


@pytest.fixture(scope="module")
def inputs(everything):
    return everything[0]


@pytest.fixture(scope="module", params=WORLDS, ids=[f"{w}ranks" for w in WORLDS])
def ranks(request, everything):
    """Every rank's results of ``collectives`` on a spawned Gloo group."""
    return request.param, everything[1][request.param]


@pytest.fixture(scope="module")
def jax_ref(everything):
    return everything[2]


def rel(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=0.0)


def test_every_rank_has_the_same_result(ranks):
    world, results = ranks
    assert len(results) == world
    for r in results[1:]:
        np.testing.assert_equal(r, results[0])


def test_collective_stats_match_masked_stats_and_jax(ranks, jax_ref, inputs):
    _, (got, *_) = ranks
    v, m = inputs["stats"]
    ref = masked_stats(torch.as_tensor(v), torch.as_tensor(m))
    st, js = got["stats"], jax_ref["stats"]
    for k in ("mean", "std", "min", "max", "n"):
        rel(st[k], float(ref[k]))
        rel(st[k], js[k])
    assert st["n"].dtype == np.int64 and int(st["n"]) == int(m.sum())
    rel(st["percentiles"], ref["percentiles"].numpy())
    rel(st["percentiles"], js["percentiles"])
    assert st["percentile_ci"].shape == (5, 2)
    np.testing.assert_array_equal(st["percentile_ci"], np.asarray(percentile_ci(v, m)))
    np.testing.assert_array_equal(st["percentile_ci"], js["percentile_ci"])
    assert (st["percentile_ci"][:, 0] <= st["percentiles"]).all()
    assert (st["percentile_ci"][:, 1] >= st["percentiles"]).all()


@pytest.mark.parametrize("n", CI_SIZES)
def test_collective_percentile_ci_exact_ranks(ranks, inputs, n):
    """Exact binomial ranks at small and large n, bit for bit against the
    port's host interval and the JAX package's (``mc.stats.percentile_ci``,
    to which tests/test_parallel.py holds JAX's collective bit for bit at
    these n)."""
    from erpl_monte_carlo_sim_tpu.mc.stats import percentile_ci as jax_percentile_ci

    _, (got, *_) = ranks
    v, m = inputs[f"ci{n}"]
    np.testing.assert_array_equal(got[f"ci{n}"]["percentile_ci"],
                                  np.asarray(percentile_ci(v, m)))
    np.testing.assert_array_equal(got[f"ci{n}"]["percentile_ci"],
                                  np.asarray(jax_percentile_ci(v, m)))


def test_collective_histogram_percentiles(ranks, inputs):
    """Past the threshold the two-pass histogram. The interval ends (order
    statistics at integer ranks) lie within one refined bucket, range /
    n_bins**2, of the exact values; a percentile at a fractional rank
    interpolates between two order statistics that may lie buckets apart, so
    it is held within tests/test_parallel.py's 1e-4 sigma. The default
    threshold keeps the exact path."""
    _, (got, *_) = ranks
    v, m = inputs["hist"]
    exact = masked_stats(torch.as_tensor(v), torch.as_tensor(m))
    h, d = got["hist"], got["hist_default"]
    for k in ("mean", "std", "min", "max", "n"):
        rel(h[k], float(exact[k]))
    bar = (float(exact["max"]) - float(exact["min"])) / HIST_BINS ** 2
    assert np.abs(h["percentile_ci"] - d["percentile_ci"]).max() <= bar
    assert np.abs(h["percentiles"] - exact["percentiles"].numpy()).max() < 1e-4 * float(
        exact["std"])
    rel(d["percentiles"], exact["percentiles"].numpy())
    np.testing.assert_array_equal(d["percentile_ci"], np.asarray(percentile_ci(v, m)))


def test_collective_histogram_degenerate_span(ranks, inputs):
    _, (got, *_) = ranks
    st = got["degenerate"]
    np.testing.assert_array_equal(st["percentiles"], np.full(5, 1234.5))
    np.testing.assert_array_equal(st["percentile_ci"], np.full((5, 2), 1234.5))
    assert float(st["std"]) == 0.0
    assert int(st["n"]) == int(inputs["degenerate"][1].sum())


def test_collective_stats_variance_catastrophic_cancellation(ranks, inputs):
    """A float32 metric with a large mean and a small std keeps its std
    (two passes)."""
    _, (got, *_) = ranks
    st = got["f32"]
    assert st["std"].dtype == np.float32
    np.testing.assert_allclose(float(st["std"]), float(inputs["f32"].astype(np.float64).std()),
                               rtol=2e-3)
    np.testing.assert_array_equal(st["percentile_ci"],
                                  np.asarray(percentile_ci(inputs["f32"], np.ones(1024, bool))))


def test_collective_footprint_matches_accumulator_and_jax(ranks, jax_ref, inputs):
    _, (got, *_) = ranks
    landing, m = inputs["footprint"]
    n, *moments = got["footprint_moments"]
    jn, *jmoments = jax_ref["footprint_moments"]
    assert n == int(jn) == int((m & np.isfinite(landing[:, 0])).sum())
    rel(moments, jmoments, 1e-11)
    # the accumulator fed one slab of every valid lane
    keep = m & np.isfinite(landing[:, 0]) & np.isfinite(landing[:, 1])
    x, y = landing[keep, 0], landing[keep, 1]
    acc = FootprintAccumulator()
    acc.add(keep.sum(), x.mean(), y.mean(), ((x - x.mean()) ** 2).sum(),
            ((y - y.mean()) ** 2).sum(), ((x - x.mean()) * (y - y.mean())).sum())
    ref = acc.footprint()
    fp = got["footprint"]
    assert fp["n"] == ref["n"] and fp["cep_method"] == "gaussian"
    rel(fp["mean_m"], ref["mean_m"], 1e-12)
    rel(fp["cov_m2"], ref["cov_m2"], 1e-10)
    rel(fp["ellipse95"]["semi_major_m"], ref["ellipse95"]["semi_major_m"], 1e-10)
    assert got["footprint_all"]["n"] == 639


def test_collective_cv_moments_match_jax(ranks, jax_ref):
    _, (got, *_) = ranks
    assert int(got["cv"][0]) == int(jax_ref["cv"][0]) == CV_N - 8
    for name, a, b in zip(("mz", "mt", "szz", "szt", "stt"), got["cv"][1:], jax_ref["cv"][1:]):
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max(), err_msg=name)
    assert got["cv_names"] == jax_ref["cv_names"]


@pytest.mark.parametrize("k", RESERVOIR_KS)
def test_collective_tail_reservoir_matches_host_and_jax(ranks, jax_ref, inputs, k):
    """Order statistics, not a sketch: exactly a host reservoir of the same
    valid lanes and JAX's collective one."""
    _, (got, *_) = ranks
    v, m = inputs["reservoir"]
    ref = TailReservoir(k)
    ref.add(v[m])
    r = got[f"reservoir{k}"]
    assert r["n"] == ref.n
    np.testing.assert_array_equal(r["hi"], ref.hi)
    np.testing.assert_array_equal(r["lo"], ref.lo)
    if f"reservoir{k}" in jax_ref:  # JAX's on the largest k (a compile per call)
        j = jax_ref[f"reservoir{k}"]
        assert r["n"] == j.n
        np.testing.assert_array_equal(r["hi"], j.hi)
        np.testing.assert_array_equal(r["lo"], j.lo)


@pytest.mark.parametrize("k", CARRY_KS)
def test_collective_tail_carry_matches_host_and_jax(ranks, jax_ref, inputs, k):
    _, (got, *_) = ranks
    ref = TailReservoir(k)
    for vals in inputs["carry"]:
        ref.add(vals)
    r = got[f"carry{k}"]
    assert r["n"] == ref.n
    np.testing.assert_array_equal(r["hi"], ref.hi)
    np.testing.assert_array_equal(r["lo"], ref.lo)
    if f"carry{k}" in jax_ref:  # JAX's carry on the first k (a compile per slab)
        j = jax_ref[f"carry{k}"]
        assert r["n"] == j.n
        np.testing.assert_array_equal(r["hi"], j.hi)
        np.testing.assert_array_equal(r["lo"], j.lo)


def test_collective_tail_extremes_are_supersets(ranks, inputs):
    world, (got, *_) = ranks
    v, m = inputs["reservoir"]
    cnt, hi, lo = got["extremes"]
    assert int(cnt) == int((m & np.isfinite(v)).sum())
    assert hi.shape == lo.shape == (16 * world,)
    fin = np.sort(v[m & np.isfinite(v)])
    assert set(fin[-16:]) <= set(hi[np.isfinite(hi)])
    assert set(fin[:16]) <= set(lo[np.isfinite(lo)])


@pytest.mark.parametrize("case", ["uneven", "empty"])
@pytest.mark.parametrize("fn", ["collective_tail_extremes", "collective_tail_carry",
                                "collective_tail_reservoir"])
def test_collective_tail_rejects_unshardable_batch(ranks, case, fn):
    """Shards of unequal length, or an empty batch, raise ValueError on every
    rank (tests/test_parallel.py's "cannot shard")."""
    _, results = ranks
    for got in results:
        assert "cannot shard" in got[f"{case} {fn}"], got[f"{case} {fn}"]


def test_collective_envelope_matches_accumulator_and_jax(ranks, jax_ref, inputs):
    """The same batched trajectory: the port's collective envelope against
    JAX's and against the port's single-device accumulator, at
    tests/test_envelope.py's bars (counts, min and max exact)."""
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import trajectory_from_numpy

    _, (got, *_) = ranks
    acc = EnvelopeAccumulator(SimConfig(max_time=ENV_MAX_TIME), EnvelopeConfig(**ENV))
    acc.add(trajectory_from_numpy(inputs["trajectory"], "cpu"))
    col = got["envelope"]
    for ref in (acc.result(), jax_ref["envelope"]):
        assert col["n_lanes"] == ref["n_lanes"] == 16 and col["time"] == ref["time"]
        for ch in ENV["channels"]:
            a, b = ref["channels"][ch], col["channels"][ch]
            assert a["n"] == b["n"], ch
            np.testing.assert_array_equal(b["min"], a["min"], err_msg=ch)
            np.testing.assert_array_equal(b["max"], a["max"], err_msg=ch)
            np.testing.assert_allclose(b["mean"], a["mean"], rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(b["std"], a["std"], rtol=1e-9, atol=1e-12,
                                       equal_nan=True)
            for q in a["percentiles"]:
                np.testing.assert_allclose(b["percentiles"][q], a["percentiles"][q],
                                           rtol=1e-9, atol=1e-12, equal_nan=True)
            assert b["clipped_frac"] == 0.0
    assert sum(col["channels"]["mach"]["n"]) == int(
        (inputs["trajectory"]["valid"] & np.isfinite(
            inputs["trajectory"]["derived"]["mach"])).sum())


def test_make_global_batch_base_tree_classification(ranks, jax_ref):
    """A shared leaf as long as the local batch stays shared with the base
    tree, and is concatenated by the shape rule without it (the documented
    misclassification), as JAX's places them (``P("batch")`` or ``P()``); a
    shared leaf that differs between ranks raises."""
    world, (got, *_) = ranks
    assert jax_ref["global_base"] == {"batched": P_BATCH, "shared_grid": P_SHARED}
    assert jax_ref["global_shape_rule"] == {"batched": P_BATCH, "shared_grid": P_BATCH}
    out = got["global_base"]
    assert out["batched"].shape == (8 * world, 3)
    np.testing.assert_array_equal(out["batched"][:, 0], np.repeat(np.arange(world), 8))
    np.testing.assert_array_equal(out["shared_grid"], np.arange(8))
    assert got["global_shape_rule"]["shared_grid"].shape == (8 * world,)
    assert "differs between ranks" in got["global_mismatch"]


def test_replicate_and_pad_to_devices(ranks):
    """Rank 0's leaves on every rank; lane padding to the mesh's size."""
    world, results = ranks
    for got in results:
        assert int(got["replicated"]["rank"][0]) == 0
        np.testing.assert_array_equal(got["replicated"]["pair"][0], [0.5, 0.5])
        assert got["padded"] == ({"batch": world}, -(-17 // world) * world, 16)


def test_single_rank_mesh_is_the_single_device_function():
    """A mesh of one rank without a process group: each collective is the
    single-device computation (the footprint moments bit for bit those of
    the analyzer's slab reduction)."""
    from erpl_monte_carlo_sim_tpu_torch.parallel import make_mesh

    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    v, m = cases()["stats"]
    st = collective_stats(torch.as_tensor(v), torch.as_tensor(m), mesh)
    ref = masked_stats(torch.as_tensor(v), torch.as_tensor(m))
    for k in ("mean", "std", "min", "max", "n"):
        assert float(st[k]) == float(ref[k]), k
    landing, m = cases()["footprint"]
    got = collective_footprint_moments(torch.as_tensor(landing), torch.as_tensor(m), mesh)
    assert got == MonteCarloAnalyzer._footprint_moments(torch.as_tensor(landing),
                                                        torch.as_tensor(m))
    assert math.isfinite(got[1])
