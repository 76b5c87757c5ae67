"""PyTorch port, chunked flights: ``engine.simulate_batch_chunked`` and the
analyzer's ``chunk_steps`` against the JAX package's, on the same inputs.

On CPU tensors the port's chunks are the stacked engine's masked steps
(``simulate_batch_chunked_reference``), the plain version of the flight
kernel's carry build they launch on a card. The tests hold them to the JAX
package's ``simulate_batch_chunked`` and ``jax.vmap(simulate_summary)`` on
8 dispersed float64 lanes with a NaN-wind lane (tests/test_batch.py's bars:
rtol 5e-7 / atol 1e-6, integers and flags exact, the same progress calls),
to the port's own unchunked run bit for bit, the analyzer's chunked runs
(single call, slabbed, ``run_to_precision``) to the JAX analyzer's with the
same seed (masks exact, metrics and statistics within rtol 1e-6), and the
card route's plumbing, run here with ``_on_card`` patched. The JAX flights,
most of their time XLA's compile, run in threads from the module's first
test on.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.engine as je
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
from erpl_monte_carlo_sim_tpu.mc import scene_in_axes
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
import erpl_monte_carlo_sim_tpu_torch.engine as pe
from erpl_monte_carlo_sim_tpu_torch.engine import simulate as psim
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy
from test_torch_flight import compare, leaves
from test_torch_stacked import FLIGHT_BARS, NAN_LANE, dispersed, port  # noqa: F401

torch.set_num_threads(1)

WINDOW = 1.5       # rail exit at 0.87 s, then about 126 steps
CHUNK = 50         # three chunks of the window
CFG = pe.SimConfig(max_time=WINDOW)
JCFG = JaxConfig(max_time=WINDOW)
# the analyzer's runs: 8 lanes, slabs of 4, min_apogee near the window's
# median apogee (tests/test_torch_slabbed.py), so the mask splits them
N, SLAB, SEED, MIN_APOGEE = 8, 4, 5, 64.2
CRITERIA = [{"metric": "apogee_altitude", "mean_stderr": 100.0}]  # met by the first slab
RUNS = {
    "single": ("run_monte_carlo", {"n_samples": N}),
    "slabbed": ("run_monte_carlo", {"n_samples": N, "lane_slab": SLAB}),
    "to_precision": ("run_to_precision", {"criteria": CRITERIA, "max_samples": N,
                                          "lane_slab": SLAB}),
}


MODES = 4          # wind_table_modes, which the chunks do not fly
SUBSET_LANES = 4   # the subset driver's metric: lanes of normals from this seed
SUBSET_SEED = 3


def jax_run(name, **analyzer_kw):
    method, kw = RUNS[name]
    mc = JaxAnalyzer(scene=jax_nominal(jax_liquid()), sim_config=JCFG,
                     bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False,
                     **analyzer_kw)
    return getattr(mc, method)(JaxIC.vertical_launch(), seed=SEED, chunk_steps=CHUNK, **kw)


def subset_normals(d):
    return np.random.default_rng(SUBSET_SEED).standard_normal((SUBSET_LANES, d))


def jax_subset_metric():
    """The JAX subset driver's chunked metric of ``subset_normals``."""
    mc = JaxAnalyzer(scene=jax_nominal(jax_liquid()), sim_config=JCFG,
                     bounds=JaxBounds(min_apogee=MIN_APOGEE), persistent_cache=False)
    g_fn, d, _, sign, _ = mc._subset_g_fn(JaxIC.vertical_launch(), "apogee_altitude", "above",
                                          1, CHUNK)
    return g_fn(subset_normals(d)), sign


@pytest.fixture(scope="module", autouse=True)
def jax_flights(dispersed):  # noqa: F811
    """The JAX package's results the tests hold the port to: its
    ``simulate_batch_chunked`` of the dispersed lanes (with the progress
    calls it made), ``jax.vmap(simulate_summary)`` of the same lanes, and
    its analyzer's chunked runs (``run_to_precision`` also with
    ``wind_table_modes``), and its subset driver's chunked metric."""
    base, _, scene, ic = dispersed

    def chunked():
        calls = []
        s = je.simulate_batch_chunked(scene, ic, JCFG, chunk_steps=CHUNK,
                                      progress=lambda k, n: calls.append((k, n)))
        return jax.tree.map(np.asarray, s), calls

    jobs = {"chunked": chunked,
            "vmap": lambda: jax.tree.map(np.asarray, jax.jit(
                jax.vmap(je.simulate_summary, in_axes=(scene_in_axes(base, scene), 0, None)),
                static_argnums=2)(scene, ic, JCFG))}
    jobs.update({name: lambda name=name: jax_run(name) for name in RUNS})
    jobs["to_precision_modes"] = lambda: jax_run("to_precision", wind_table_modes=MODES)
    jobs["subset"] = jax_subset_metric
    with ThreadPoolExecutor(3) as ex:
        yield {k: ex.submit(f) for k, f in jobs.items()}


@pytest.fixture(scope="module")
def chunked(dispersed):  # noqa: F811
    """The port's chunked run of the dispersed lanes, with its progress calls."""
    _, _, scene, ic = dispersed
    calls = []
    s = pe.simulate_batch_chunked(port(scene), port(ic), CFG, chunk_steps=CHUNK,
                                  progress=lambda k, n: calls.append((k, n)))
    return s, calls


@pytest.mark.parametrize("ref", ["chunked", "vmap"])
def test_chunked_matches_jax(ref, chunked, jax_flights):
    """Every leaf against JAX's chunked run and its vmapped one, the NaN-wind
    lane stopped diverged at the same step with ``max_speed`` 0; the
    progress calls JAX's, one a chunk until no lane runs."""
    got, calls = chunked
    want = jax_flights[ref].result()
    if ref == "chunked":
        want, jax_calls = want
        assert calls == jax_calls == [(k, -(-CFG.max_steps // CHUNK) + 1) for k in (1, 2, 3)]
    got = to_numpy(got)
    compare(want, got, FLIGHT_BARS[jax.numpy.float64])
    assert got.diverged[NAN_LANE] and not np.delete(got.diverged, NAN_LANE).any()
    assert got.max_speed[NAN_LANE] == 0.0 and (np.delete(got.n_steps, NAN_LANE) > 100).all()


@pytest.mark.parametrize("chunk_steps", [7, CHUNK, 4096])
def test_chunked_is_the_unchunked_run(chunk_steps, chunked, dispersed):  # noqa: F811
    """Chunks of any length give the stacked engine's one-shot run bit for
    bit (a masked step leaves a stopped lane as it is); a chunk longer than
    the flight is one chunk."""
    _, _, scene, ic = dispersed
    calls = []
    got = (chunked[0] if chunk_steps == CHUNK else
           pe.simulate_batch_chunked(port(scene), port(ic), CFG, chunk_steps=chunk_steps,
                                     progress=lambda k, n: calls.append(k)))
    want = pe.simulate_summary(port(scene), port(ic), CFG)
    for (path, a), (_, b) in zip(leaves(to_numpy(want)), leaves(to_numpy(got))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    if chunk_steps != CHUNK:
        assert calls == list(range(1, -(-int(want.n_steps.max()) // chunk_steps) + 1))


def same_analysis(mine: dict, ref: dict) -> None:
    """The port's analysis against JAX's from the same seed: masks and
    counts exact, the per-lane metrics (or summary leaves) and the
    statistics within rtol 1e-6."""
    np.testing.assert_array_equal(mine["valid_mask"], ref["valid_mask"])
    assert mine["n_samples"] == ref["n_samples"] and 0 < mine["n_samples"] < N
    if ref["summary"] is not None:
        for (path, a), (_, b) in zip(leaves(ref["summary"]), leaves(mine["summary"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        for k in ref["metrics"]:
            np.testing.assert_allclose(mine["metrics"][k], ref["metrics"][k], rtol=1e-6,
                                       err_msg=k)
    for metric in ("apogee_altitude", "range", "flight_time"):
        for k in ("mean", "std", "min", "max", "percentiles"):
            np.testing.assert_allclose(mine[metric][k], ref[metric][k], rtol=1e-6,
                                       err_msg=f"{metric}.{k}")


@pytest.mark.parametrize("name", list(RUNS))
def test_analyzer_chunked_matches_jax(name, jax_flights):
    """``run_monte_carlo`` in one call and in slabs, and ``run_to_precision``
    (which stops after its first slab), with ``chunk_steps``: the JAX
    analyzer's analysis of the same seed."""
    method, kw = RUNS[name]
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG,
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE))
    mine = getattr(mc, method)(pe.InitialConditions.vertical_launch("cpu"), seed=SEED,
                               chunk_steps=CHUNK, **kw)
    ref = jax_flights[name].result()
    same_analysis(mine, ref)
    if name == "to_precision":
        for k in ("n_used", "stopped_early", "satisfied"):
            assert mine["sequential"][k] == ref["sequential"][k], k
        assert mine["sequential"]["n_used"] == SLAB


@pytest.mark.parametrize("case", ["modes", "modes_to_precision", "descent_dt_scale",
                                  "chunk_steps_zero"])
def test_chunked_refusals(case, jax_flights):
    """``run_monte_carlo`` with ``chunk_steps`` and ``wind_table_modes``
    raises the JAX package's ValueError before any draw; ``run_to_precision``
    takes the two, as JAX's does, and its chunks fly the uncompressed
    tables (the JAX analyzer's analysis of the same call); the tiered
    timestep is refused as the stacked engine refuses it; a chunk of no
    steps is refused."""
    ic = pe.InitialConditions.vertical_launch("cpu")
    if case == "modes":
        mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG,
                                wind_table_modes=MODES)
        mc_draws = []
        mc._check_split = lambda n: mc_draws.append(n)  # reached only past the check
        with pytest.raises(ValueError, match="does not compose with chunk_steps"):
            mc.run_monte_carlo(ic, n_samples=N, chunk_steps=CHUNK)
        assert not mc_draws
        with pytest.raises(ValueError, match="does not compose with chunk_steps"):
            JaxAnalyzer(scene=jax_nominal(jax_liquid()), sim_config=JCFG, wind_table_modes=MODES,
                        persistent_cache=False).run_monte_carlo(
                JaxIC.vertical_launch(), n_samples=N, chunk_steps=CHUNK)
    elif case == "modes_to_precision":
        method, kw = RUNS["to_precision"]
        mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG,
                                bounds=OutlierBounds(min_apogee=MIN_APOGEE),
                                wind_table_modes=MODES)
        flown = []
        mc._compress_for_sim = lambda *a: flown.append(a)  # the component route's tables
        mine = mc.run_to_precision(ic, seed=SEED, chunk_steps=CHUNK, **kw)
        assert not flown
        same_analysis(mine, jax_flights["to_precision_modes"].result())
    elif case == "descent_dt_scale":
        mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"),
                                sim_config=pe.SimConfig(max_time=WINDOW, descent_dt_scale=4))
        with pytest.raises(ValueError, match="descent_dt_scale"):
            mc.run_monte_carlo(ic, n_samples=4, chunk_steps=CHUNK)
        with pytest.raises(ValueError, match="descent_dt_scale"):
            je.simulate_batch_chunked(jax_nominal(jax_liquid()), JaxIC.vertical_launch(),
                                      JaxConfig(descent_dt_scale=4), chunk_steps=CHUNK)
    else:
        scene = port(jax_nominal(jax_liquid()))
        for bad in (0, -3, 2.5):
            with pytest.raises(ValueError, match="chunk_steps must be a positive integer"):
                pe.simulate_batch_chunked(scene, ic, CFG, chunk_steps=bad)


@pytest.mark.parametrize("lanes", ["batched", "single"])
def test_card_route_matches_the_stacked_engine(lanes, dispersed, monkeypatch):  # noqa: F811
    """The card route's plumbing, run here on CPU tensors: ``engine.batch``
    into ``flight_summary_chunked`` (whose CPU route is the carry build's
    plain version, the stacked chunk loop) and back to a ``FlightSummary``,
    a single flight lifted to one lane and squeezed back: the stacked plain
    version's result bit for bit, and its progress calls; the NaN-wind
    lane's ``max_speed`` 0."""
    if lanes == "single":
        scene = port(jax_nominal(jax_liquid()))
        ic = pe.InitialConditions.vertical_launch("cpu")
    else:
        scene, ic = port(dispersed[2]), port(dispersed[3])
    want_calls, got_calls = [], []
    want = psim.simulate_batch_chunked_reference(scene, ic, CFG, CHUNK,
                                                 lambda k, n: want_calls.append((k, n)))
    monkeypatch.setattr(psim, "_on_card", lambda ic: True)
    before = fs.launches
    got = pe.simulate_batch_chunked(scene, ic, CFG, chunk_steps=CHUNK,
                                    progress=lambda k, n: got_calls.append((k, n)))
    assert fs.launches == before and got_calls == want_calls and len(want_calls) == 3
    got, want = to_numpy(got), to_numpy(want)
    for (path, a), (_, b) in zip(leaves(want), leaves(got)):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    if lanes == "batched":
        assert got.max_speed[NAN_LANE] == 0.0 and got.diverged[NAN_LANE]
    else:
        assert got.apogee_altitude.shape == ()


def test_subset_driver_flies_chunked(jax_flights):
    """The subset driver's metric with ``chunk_steps`` is the stacked
    engine's flight of the same normals (chunked = one-shot bit for bit),
    invalid lanes at ``-inf``, and the JAX subset driver's chunked metric
    of the same normals (tests/test_batch.py's bars, the ``-inf`` lanes
    exact)."""
    from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import sample_from_normals
    from erpl_monte_carlo_sim_tpu_torch.mc.filter import outlier_mask

    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG,
                            bounds=OutlierBounds(min_apogee=MIN_APOGEE))
    ic = pe.InitialConditions.vertical_launch("cpu")
    g_fn, d, _, sign = mc._subset_g_fn(ic, "apogee_altitude", "above", 1, CHUNK)
    u = subset_normals(d)
    scene_b, ic_b, _ = sample_from_normals(u, mc.scene, ic, params=mc.uncertainty_params,
                                           wind_grid_points=mc.wind_grid_points,
                                           wind_grid_top=mc.wind_grid_top)
    s = pe.simulate_summary(scene_b, ic_b, CFG)
    valid, _ = outlier_mask(s, mc.bounds)
    want = torch.where(valid & torch.isfinite(s.apogee_altitude), sign * s.apogee_altitude,
                       -torch.inf).numpy()
    got = g_fn(u)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any() and not np.isfinite(got).all() and sign == 1.0
    ref, jax_sign = jax_flights["subset"].result()
    assert jax_sign == sign
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_array_equal(got[~np.isfinite(got)], ref[~np.isfinite(ref)])
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)],
                               rtol=FLIGHT_BARS[jax.numpy.float64], atol=1e-6)
