"""PyTorch port, re-simulation of Monte Carlo lanes (``mc/resimulate.py``)
against the JAX package's, single-call and slabbed.

Both analyzers run the same lanes in float64 on a 1.5 s window: the JAX
analyzer draws them, and the port's run takes them through its draw seams
(``mc.analyzer._draw_single`` and ``_draw_slab``, as
tests/test_torch_slabbed.py feeds slabs), which a slabbed run's
re-simulation draws through again. Re-simulated summaries must be the
port's run's bit for bit, and agree with the JAX package's re-simulation of
the same lanes at tests/test_trajectory_batch.py's bars, trajectories too.
The lane counts are chosen so that one JAX compile of the recorder serves
every re-simulation. Also: ``lane_scenes``, the single-slot memo, the
rejections, and the first chunk's cap under ``inline=True`` (ROADMAP F2b,
not copied).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.engine.batch as batch_mod
import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
import erpl_monte_carlo_sim_tpu_torch.mc.resimulate as resimulate_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import EnvelopeConfig, MonteCarloAnalyzer
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy, to_numpy)
from test_torch_flight import compare
from test_torch_trajectory import compare_trajectories

torch.set_num_threads(1)

WINDOW = 1.5          # rail exit and about 130 steps
SEED = 5
SINGLE = 16           # lanes of the single-call run, and the slab of the slabbed one
SLABBED = 40          # 3 slabs, a ragged last one
SINGLE_IDS = [3, 11]
SLABBED_IDS = [25, 2, 9, 17]  # two lanes in each of slabs 0 and 1
JSCENE = jax_nominal(jax_liquid())
JIC = JaxIC.vertical_launch()


def jax_draw(key, n):
    scene_b, ic_b, sample = jax_sample(key, JSCENE, JIC, n=n)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def jax_single(analyzer, ic, n, seed, base_wind):
    return jax_draw(jax.random.PRNGKey(seed), n)


def jax_slab(analyzer, ic, k, slab, seed, base_wind):
    return jax_draw(jax.random.fold_in(jax.random.PRNGKey(seed), k), slab)


def port_analyzer():
    return MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW))


@pytest.fixture(scope="module")
def runs():
    """``{kind: (port analyzer, port analysis, JAX analyzer, JAX
    analysis)}`` for a single-call and a slabbed run of the same lanes; the
    port's draw seams keep feeding the JAX lanes for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        mp.setattr(analyzer_mod, "_draw_slab", jax_slab)
        out = {}
        for kind, n in (("single", SINGLE), ("slabbed", SLABBED)):
            ref_mc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW),
                                 persistent_cache=False)
            ref = ref_mc.run_monte_carlo(JIC, n_samples=n, lane_slab=SINGLE, seed=SEED)
            mc = port_analyzer()
            got = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=n,
                                     lane_slab=SINGLE, seed=SEED)
            out[kind] = (mc, got, ref_mc, ref)
        yield out


def run_metric(analysis, name, ids):
    if analysis["summary"] is not None:
        return np.asarray(getattr(analysis["summary"], name))[ids]
    return analysis["metrics"][name][ids]


@pytest.mark.parametrize("kind", ["single", "slabbed"])
def test_resimulation_is_the_run_and_matches_jax(runs, kind):
    mc, got_run, ref_mc, ref_run = runs[kind]
    ids = SINGLE_IDS if kind == "single" else SLABBED_IDS
    s, traj = mc.resimulate_trajectories(ids)
    s, traj = to_numpy(s), to_numpy(traj)
    for name in ("apogee_altitude", "range", "flight_time"):
        np.testing.assert_array_equal(getattr(s, name), run_metric(got_run, name, ids),
                                      err_msg=name)
        np.testing.assert_allclose(run_metric(got_run, name, ids),
                                   run_metric(ref_run, name, ids), rtol=5e-7, err_msg=name)
    if kind == "single":
        full = got_run["summary"]
        for a, b in zip(jax.tree.leaves(dataclasses.asdict(s)),
                        jax.tree.leaves(dataclasses.asdict(full))):
            np.testing.assert_array_equal(a, np.asarray(b)[ids])
    ref_s, ref_t = ref_mc.resimulate_trajectories(ids)
    compare(jax.tree.map(np.asarray, ref_s), s, 5e-7)
    compare_trajectories(jax.device_get(ref_t), traj)
    assert traj.time.shape[0] == len(ids) and (traj.valid.sum(1) > 100).all()


@pytest.mark.parametrize("kind", ["single", "slabbed"])
def test_lane_scenes_match_jax(runs, kind):
    mc, _, ref_mc, _ = runs[kind]
    ids = SINGLE_IDS if kind == "single" else SLABBED_IDS
    for got, ref in zip(mc.lane_scenes(ids), ref_mc.lane_scenes(ids)):
        want = scene_from_numpy(ref, "cpu")
        for part in ("rocket", "motor", "atmosphere", "wind"):
            a, b = getattr(got, part), getattr(want, part)
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), (kind, part, f.name)
        assert got.wind.wind.ndim == 2  # one lane's table


def test_memo_holds_one_call_and_a_run_clears_it():
    mc = port_analyzer()
    ic = InitialConditions.vertical_launch("cpu")
    with pytest.raises(RuntimeError, match="run_monte_carlo first"):
        mc.resimulate_trajectories([0])
    mc.run_monte_carlo(ic, n_samples=4, seed=1)
    cfg = SimConfig(max_time=0.5)
    first = mc.resimulate_trajectories([1, 2], cfg)
    assert mc.resimulate_trajectories([1, 2], cfg) is first
    assert mc.resimulate_trajectories([2], cfg) is not first
    mc.run_monte_carlo(ic, n_samples=4, seed=2)
    assert mc._resim_memo is None
    s, _ = mc.resimulate_trajectories([1, 2], cfg)
    assert not torch.equal(s.rail.rail_exit_speed, first[0].rail.rail_exit_speed)


def test_inline_envelope_refuses_a_slabbed_run(runs):
    mc = runs["slabbed"][0]
    with pytest.raises(ValueError, match="inline=True needs a single-call run"):
        mc.flight_envelope(n_lanes=8, chunk=4, inline=True)


def test_inline_calibration_chunk_is_capped(runs, monkeypatch):
    """ROADMAP F2b, not copied: under ``inline=True`` the first, frame-based
    chunk holds at most ``CALIBRATION_CAP`` lanes (the JAX package takes a
    whole ``chunk``), and the frame path keeps its chunks."""
    mc = runs["single"][0]
    frames, aggregates = [], []
    resim, envelope = mc.resimulate_trajectories, batch_mod.simulate_envelope_batch

    def spy_resim(ids, cfg=None):
        frames.append(len(ids))
        return resim(ids, cfg)

    def spy_envelope(scene_b, ic_b, cfg, **kw):
        aggregates.append(int(ic_b.position.shape[0]))
        return envelope(scene_b, ic_b, cfg, **kw)

    monkeypatch.setattr(resimulate_mod, "CALIBRATION_CAP", 3)
    monkeypatch.setattr(mc, "resimulate_trajectories", spy_resim)
    monkeypatch.setattr(batch_mod, "simulate_envelope_batch", spy_envelope)
    env = EnvelopeConfig(record_stride=4, n_buckets=16)
    inline = mc.flight_envelope(n_lanes=13, chunk=8, env_config=env, inline=True)
    assert (frames, aggregates) == ([3], [8, 2])
    frames.clear()
    framed = mc.flight_envelope(n_lanes=13, chunk=8, env_config=env)
    assert (frames, aggregates) == ([8, 5], [8, 2])
    assert inline["n_lanes"] == framed["n_lanes"] == 13
    assert inline["channels"]["altitude"]["n"] == framed["channels"]["altitude"]["n"]
