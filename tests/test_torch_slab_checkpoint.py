"""PyTorch port, mid-run checkpoint and resume of slabbed runs
(``mc/slab_checkpoint.py``), ``run_to_precision``, the per-slab seeds, and
``save_summaries`` / ``load_summaries`` across the two packages.

A run killed after two slabs resumes from its checkpoint to the
uninterrupted run's analysis bit for bit, with exact statistics and across
the streams' exact -> sketch crossing; another run refuses the checkpoint.
The fingerprint changes with each input that changes a slab's results or
the accumulators' shapes (the JAX package's leaves ``wind_table_modes`` out,
ROADMAP F2a; the port refuses that knob until P8). The flights are a 1 s
window (rail exit and about 40 steps), float64, on the CPU.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from chip_smoke import plain_data, same_analysis
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig, \
    simulate_summary_batch
from erpl_monte_carlo_sim_tpu_torch.mc import (MonteCarloAnalyzer, OutlierBounds,
                                               UncertaintyParams, load_summaries,
                                               sample_dispersions, save_summaries, slab_seed)
from erpl_monte_carlo_sim_tpu_torch.mc.slab_checkpoint import run_fingerprint
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

torch.set_num_threads(1)

CFG = SimConfig(max_time=1.0)
BOUNDS = OutlierBounds(min_apogee=34.0)  # about the window's median apogee
IC = InitialConditions.vertical_launch("cpu")
N, SLAB = 96, 32
STREAMING = {"stats_stream_threshold": 40, "metrics_sample_cap": 20}


def analyzer(**kw):
    return MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG, bounds=BOUNDS, **kw)


def kill_after(monkeypatch, n_slabs):
    """The slab loop dies at its draw of slab ``n_slabs``, as a killed
    process would."""
    real = analyzer_mod._draw_slab
    calls = {"n": 0}

    def draw(*a, **kw):
        if calls["n"] >= n_slabs:
            raise RuntimeError("simulated crash")
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(analyzer_mod, "_draw_slab", draw)


@pytest.fixture(scope="module")
def runs():
    """Uninterrupted runs, exact and streaming, seed 7."""
    return {kind: analyzer(**knobs).run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, seed=7)
            for kind, knobs in (("exact", {}), ("crossing", STREAMING))}


@pytest.mark.parametrize("kind", ["exact", "crossing"])
def test_resume_is_bit_identical(kind, runs, monkeypatch, tmp_path):
    """Killed after two slabs, resumed: the uninterrupted run's analysis.
    "crossing": the checkpoint holds the streams' exact buffers (32 or so
    valid lanes of 40), and the resumed run crosses to the sketch."""
    knobs = STREAMING if kind == "crossing" else {}
    ckpt = str(tmp_path / "nested" / "dir" / "run.ckpt.npz")  # parents are created
    kill_after(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        analyzer(**knobs).run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, seed=7,
                                          checkpoint_path=ckpt, checkpoint_every=1)
    assert os.path.exists(ckpt)
    if kind == "crossing":
        with np.load(ckpt) as z:
            assert "stream.apogee_altitude.exact" in z
    monkeypatch.undo()
    got = analyzer(**knobs).run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, seed=7,
                                            checkpoint_path=ckpt, checkpoint_every=1)
    assert not os.path.exists(ckpt)  # gone once the run completed
    ref = runs[kind]
    same_analysis(got, ref)
    assert 0 < ref["n_samples"] < N
    if kind == "crossing":
        assert ref["metrics_is_sample"] and not ref["streams"]["range"].is_exact


def test_another_run_refuses_to_resume(monkeypatch, tmp_path):
    ckpt = str(tmp_path / "run.ckpt.npz")
    kill_after(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        analyzer().run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, seed=7,
                                   checkpoint_path=ckpt, checkpoint_every=1)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="different run"):
        analyzer().run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, seed=8,
                                   checkpoint_path=ckpt)


def test_checkpoint_options_are_checked():
    with pytest.raises(ValueError, match="slabbed runs"):
        analyzer().run_monte_carlo(IC, n_samples=16, lane_slab=SLAB, checkpoint_path="x.npz")
    with pytest.raises(ValueError, match="checkpoint_every"):
        analyzer().run_monte_carlo(IC, n_samples=N, lane_slab=SLAB, checkpoint_path="x.npz",
                                   checkpoint_every=0)


BASE = dict(ic=IC, n_samples=N, slab=SLAB, seed=7, base_wind=None, limit=1000)


def _fingerprint(mc=None, **changes):
    return run_fingerprint(mc or analyzer(), **{**BASE, **changes})


def _as_cuda(mc):
    """The analyzer as the fingerprint sees it, but on a card."""
    return types.SimpleNamespace(**vars(mc), device=torch.device("cuda"))


CHANGES = {
    "scene_leaf": lambda: {"mc": MonteCarloAnalyzer(scene=dataclasses.replace(
        nominal_scene(liquid_motor("cpu")), rocket=dataclasses.replace(
            nominal_scene(liquid_motor("cpu")).rocket,
            dry_mass=torch.tensor(113.5, dtype=torch.float64))), sim_config=CFG,
        bounds=BOUNDS)},
    "scene_dtype": lambda: {"mc": MonteCarloAnalyzer(motor=liquid_motor("cpu", torch.float32),
                                                     sim_config=CFG, bounds=BOUNDS)},
    "scene_static": lambda: {"mc": MonteCarloAnalyzer(scene=dataclasses.replace(
        nominal_scene(liquid_motor("cpu")), rocket=dataclasses.replace(
            nominal_scene(liquid_motor("cpu")).rocket, stall_limited_moments=True)),
        sim_config=CFG, bounds=BOUNDS)},
    "ic": lambda: {"ic": InitialConditions.create("cpu", torch.float64,
                                                  attitude=(0.0, 0.01, 0.0))},
    "base_wind": lambda: {"base_wind": (torch.linspace(0.0, 25000.0, 10, dtype=torch.float64),
                                        torch.ones((10, 3), dtype=torch.float64))},
    "uncertainty_params": lambda: {"mc": analyzer(
        uncertainty_params=UncertaintyParams(mass_uncertainty=0.03))},
    "sim_config": lambda: {"mc": MonteCarloAnalyzer(
        motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=1.0, integrator="rk2"),
        bounds=BOUNDS)},
    "bounds": lambda: {"mc": MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=CFG,
                                                bounds=OutlierBounds(min_apogee=35.0))},
    "n_samples": lambda: {"n_samples": N + 1},
    "slab": lambda: {"slab": SLAB * 2},
    "seed": lambda: {"seed": 8},
    "limit": lambda: {"limit": 999},
    "stats_stream_threshold": lambda: {"mc": analyzer(stats_stream_threshold=40)},
    "metrics_sample_cap": lambda: {"mc": analyzer(metrics_sample_cap=20)},
    "wind_grid_points": lambda: {"mc": analyzer(wind_grid_points=50)},
    "wind_grid_top": lambda: {"mc": analyzer(wind_grid_top=20000.0)},
    "device_type": lambda: {"mc": _as_cuda(analyzer())},
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_fingerprint_covers_every_input(change):
    """No flights: the fingerprint of the same run twice is equal, and any
    one input changed changes it."""
    assert _fingerprint() == _fingerprint()
    assert _fingerprint(**CHANGES[change]()) != _fingerprint()


@pytest.mark.parametrize("case", ["early", "min_samples", "budget"])
def test_run_to_precision_is_run_monte_carlo(case, runs):
    """``mean_stderr`` on apogee, targeted at the stderr that the run's
    convergence history reaches after two slabs: the run stops there
    ("early"), at the ``min_samples`` floor of three slabs, or, with a
    target out of reach, at ``max_samples``. Each analysis is
    ``run_monte_carlo(n_samples=n_used)``'s bit for bit, but for
    ``performance`` and the ``sequential`` block."""
    hist = runs["exact"]["convergence"]
    target = hist[1]["apogee_altitude"]["stderr"]
    assert hist[0]["apogee_altitude"]["stderr"] > target
    kw = {"early": {}, "min_samples": {"min_samples": 3 * SLAB},
          "budget": {}}[case]
    if case == "budget":
        target = 1e-9
    mc = analyzer()
    a = mc.run_to_precision(IC, criteria=[{"metric": "apogee_altitude", "mean_stderr": target}],
                            max_samples=N, lane_slab=SLAB, seed=7, **kw)
    n_used = {"early": 2 * SLAB, "min_samples": 3 * SLAB, "budget": N}[case]
    seq = a.pop("sequential")
    assert seq["n_used"] == n_used and seq["stopped_early"] == (n_used < N)
    assert seq["satisfied"] == (case != "budget")
    assert seq["criteria"][0]["n"] == a["n_samples"]
    # runs["exact"] is this analyzer's run_monte_carlo(n_samples=N)
    ref = (runs["exact"] if n_used == N
           else mc.run_monte_carlo(IC, n_samples=n_used, lane_slab=SLAB, seed=7))
    same_analysis(a, ref)


def test_run_to_precision_refuses_what_jax_refuses():
    mc = analyzer()
    for kw, match in (({"criteria": []}, "non-empty"),
                      ({"criteria": [{"metric": "range", "qmc_mean_stderr": 1.0}]}, "sobol"),
                      ({"criteria": [{"metric": "range", "mean_stderr": 1.0}],
                        "max_samples": 0}, "max_samples"),
                      ({"criteria": [{"metric": "range", "mean_stderr": 1.0}],
                        "min_samples": 200}, "min_samples")):
        with pytest.raises(ValueError, match=match):
            mc.run_to_precision(IC, **{"max_samples": N, **kw})


# np.random.SeedSequence([0, k]).generate_state(1, np.uint64), 63 bits
PINNED_SEEDS = [6569863346532939966, 5836529245451711556, 7971947199917040255]


def test_slab_seed_is_pinned():
    assert [slab_seed(0, k) for k in range(3)] == PINNED_SEEDS
    assert slab_seed(5, 1) != slab_seed(1, 5)
    assert all(slab_seed(s, k) != s for s in range(4) for k in range(4))
    assert all(0 <= slab_seed(s, k) < 2**63 for s in (0, 2**40, -1) for k in (0, 9))


def test_slab_lanes_and_random_seed_are_global(runs):
    """Slab 1 of the run is one call on ``slab_seed(7, 1)``'s lanes; lane
    ids (``random_seed``) and record ids are global across slabs."""
    a = runs["exact"]
    mc = analyzer()
    scene_b, ic_b, _ = sample_dispersions(torch.Generator().manual_seed(slab_seed(7, 1)),
                                          mc.scene, IC, n=SLAB)
    one = to_numpy(simulate_summary_batch(scene_b, ic_b, CFG))
    np.testing.assert_array_equal(a["metrics"]["apogee_altitude"][SLAB:2 * SLAB],
                                  one.apogee_altitude)
    for rec in a["results"] + a["outliers"]:
        assert rec["parameters"]["random_seed"] == rec["simulation_id"]
    valid_ids = np.nonzero(a["valid_mask"])[0]
    assert a["parameter_ranges_observed"]["random_seed"] == {
        "min": int(valid_ids.min()), "max": int(valid_ids.max())}
    assert valid_ids.max() >= 2 * SLAB


def _jax_typed(analysis):
    """The single-call analysis with the JAX package's summary and sample
    types around the same NumPy arrays."""
    from erpl_monte_carlo_sim_tpu.engine.rail import RailInfo as JRail
    from erpl_monte_carlo_sim_tpu.engine.simulate import FlightSummary as JSummary
    from erpl_monte_carlo_sim_tpu.mc.dispersions import DispersionSample as JSample

    s = plain_data(analysis["summary"])
    s["rail"] = JRail(**s["rail"])
    return {**analysis, "summary": JSummary(**s),
            "sample": JSample(**plain_data(analysis["sample"]))}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("layout", ["single", "slabbed"])
def test_summaries_load_across_packages(layout, writer, runs, tmp_path):
    """A file that either package's ``save_summaries`` writes loads in both
    ``load_summaries`` to the same arrays and meta: the single-call layout
    (every ``FlightSummary`` leaf and the sample) and the streaming slabbed
    one (the metrics prefix and the tail reservoirs)."""
    from erpl_monte_carlo_sim_tpu.mc import checkpoint as jckpt

    if layout == "single":
        analysis = analyzer().run_monte_carlo(IC, n_samples=16, seed=3)
    else:
        analysis = runs["crossing"]
    path = str(tmp_path / "run.npz")
    if writer == "port":
        save_summaries(path, analysis, seed=3)
    else:
        jckpt.save_summaries(path, _jax_typed(analysis) if layout == "single" else analysis,
                             seed=3)
    got, ref = load_summaries(path), jckpt.load_summaries(path)
    assert got.keys() == ref.keys()
    np.testing.assert_equal(plain_data(got), plain_data(ref))
    assert got["meta"]["stats"]["range"] == analysis["range"]
    if layout == "single":
        np.testing.assert_equal(plain_data(got["summary"]), plain_data(analysis["summary"]))
        np.testing.assert_equal(got["sample"], plain_data(analysis["sample"]))
    else:
        np.testing.assert_equal(got["metrics"], analysis["metrics"])
        np.testing.assert_equal(plain_data(got["tail_reservoirs"]),
                                plain_data(analysis["tail_reservoirs"]))
