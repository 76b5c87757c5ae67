"""PyTorch port, the launch-window sweep (``cli/launch_window.py``) against
the JAX package's: the twin of tests/test_launch_window.py.

The sweep's rows are held to the JAX package's on the same lanes, with
tests/test_launch_window.py's ``N=48``, ``seed=7`` and ``max_time=3.0``:
each candidate's analyzer takes the JAX sampler's lanes through the port's
draw seam (``mc.analyzer._draw_single``), drawn with the candidate's own
forecast profile. Counts and verdicts exact, means and footprints at rtol
1e-9, float64 on the CPU. The other checks of tests/test_launch_window.py
run on the port alone, on shorter windows (the port's plain version costs
about 13 ms a step on the CPU), with the CLI's ``--device cpu``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu.cli.launch_window import launch_window_sweep as jax_sweep
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.cli.launch_window import (_candidate_profile,
                                                              launch_window_sweep, main)
from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import UncertaintyParams
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)

torch.set_num_threads(1)

N = 48
KW = dict(n=N, seed=7, max_time=3.0)
CPU = dict(device="cpu")
# the port-only checks' window: past the outlier filter's 100 m apogee floor
SHORT = 2.5
JSCENE = jax_nominal(jax_liquid())
JIC = JaxIC.vertical_launch()


def jax_single(analyzer, ic, n, seed, base_wind):
    """The port's single-call draw, replaced: the JAX sampler's lanes under
    the candidate's dispersions and forecast."""
    params = JaxUncertainty(**dataclasses.asdict(analyzer.uncertainty_params))
    scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, params, n,
                                       base_wind=base_wind)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


@pytest.fixture(scope="module")
def sweeps():
    """``(JAX sweep, port sweep)`` of the same candidates on the same lanes."""
    args = ([2.0, 8.0], [0.0, 180.0])
    ref = jax_sweep(*args, range_limit=500.0, p_limit=0.5, **KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        got = launch_window_sweep(*args, range_limit=500.0, p_limit=0.5, **KW, **CPU)
    return ref, got


def test_sweep_rows_match_jax(sweeps):
    ref, got = sweeps
    assert got.keys() == ref.keys()
    assert {k: v for k, v in got.items() if k != "candidates"} == \
        {k: v for k, v in ref.items() if k != "candidates"}
    assert len(got["candidates"]) == 4
    for a, b in zip(ref["candidates"], got["candidates"]):
        assert b.keys() == a.keys()
        for k in ("wind_speed", "wind_direction_deg", "n_valid", "n_outliers", "go"):
            assert b[k] == a[k], k
        for blk in ("apogee_altitude", "range"):
            np.testing.assert_allclose([b[blk]["mean"], b[blk]["std"]],
                                       [a[blk]["mean"], a[blk]["std"]], rtol=1e-9, err_msg=blk)
        np.testing.assert_allclose(b["range_p95"], a["range_p95"], rtol=1e-9)
        np.testing.assert_allclose(b["landing_footprint"]["mean_m"],
                                   a["landing_footprint"]["mean_m"], rtol=1e-9)
        np.testing.assert_allclose(b["landing_footprint"]["cep_m"],
                                   a["landing_footprint"]["cep_m"], rtol=1e-9)
        pa, pb = a["p_range_exceed"], b["p_range_exceed"]
        assert pb["probability"] == pa["probability"] and pb["n"] == pa["n"]
        np.testing.assert_allclose(pb["ci95"], pa["ci95"], rtol=1e-12)
    json.dumps(got)


def test_sweep_wind_direction_shifts_impact(sweeps):
    """tests/test_launch_window.py's check on the port's sweep: flipping the
    forecast 180 degrees moves the mean impact downwind, less for the weak
    wind."""
    by = {(r["wind_speed"], r["wind_direction_deg"]): r for r in sweeps[1]["candidates"]}
    x0 = by[(8.0, 0.0)]["landing_footprint"]["mean_m"][0]
    x180 = by[(8.0, 180.0)]["landing_footprint"]["mean_m"][0]
    assert x0 - x180 > 0.2
    w0 = by[(2.0, 0.0)]["landing_footprint"]["mean_m"][0]
    w180 = by[(2.0, 180.0)]["landing_footprint"]["mean_m"][0]
    assert abs(w0 - w180) < (x0 - x180)


def test_candidate_profile_matches_jax():
    from erpl_monte_carlo_sim_tpu.cli.launch_window import _candidate_profile as jax_profile

    alts, prof = _candidate_profile(nominal_scene(liquid_motor("cpu")), 8.0, 135.0, 100,
                                    25000.0)
    ref_alts, ref_prof = jax_profile(JSCENE, 8.0, 135.0, 100, 25000.0)
    np.testing.assert_array_equal(alts, ref_alts)
    np.testing.assert_allclose(prof, ref_prof, rtol=1e-12, atol=1e-15)


def test_go_rule_follows_limits():
    kw = dict(KW, max_time=SHORT, **CPU)
    assert launch_window_sweep([2.0], [0.0], range_limit=1e9, p_limit=0.2,
                               **kw)["candidates"][0]["go"] is True
    assert launch_window_sweep([2.0], [0.0], range_limit=0.0, p_limit=0.01,
                               **kw)["candidates"][0]["go"] is False
    descriptive = launch_window_sweep([2.0], [0.0], **kw)
    assert descriptive["candidates"][0]["n_valid"] > 0
    assert descriptive["candidates"][0]["go"] is None
    assert descriptive["go_count"] == 0


def test_cli_main_with_plot(tmp_path, capsys):
    out = main([
        "--speeds", "2", "--directions", "0,180", "--n", str(N), "--seed", "7",
        "--max-time", str(SHORT), "--range-limit", "500", "--p-limit", "0.5",
        "--device", "cpu", "--plot", str(tmp_path),
    ])
    printed = json.loads(capsys.readouterr().out)
    assert printed["go_count"] == out["go_count"]
    assert all(r["n_valid"] > 0 for r in out["candidates"])
    assert os.path.getsize(out["plot"]) > 10_000


def test_cli_runs_on_the_card_by_default():
    """``--device`` defaults to cuda: without a card the sweep raises, it
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["--speeds", "2", "--directions", "0", "--n", "4", "--max-time", "0.5"])


def test_sweep_holds_candidate_forecast():
    """The sweep's default dispersions zero the uniform mean-wind offset
    (tests/test_launch_window.py's regression)."""
    kw = dict(n=16, seed=3, max_time=SHORT, **CPU)
    a = launch_window_sweep([4.0], [90.0], **kw)
    b = launch_window_sweep([4.0], [90.0], uncertainty_params=UncertaintyParams(
        wind_speed_range=(0.0, 0.0), wind_direction_range=(0.0, 0.0)), **kw)
    assert a["candidates"][0]["range"]["mean"] == b["candidates"][0]["range"]["mean"]
    c = launch_window_sweep([4.0], [90.0],
                            uncertainty_params=UncertaintyParams(wind_speed_range=(5.0, 5.0)),
                            **kw)
    assert c["candidates"][0]["range"]["mean"] != a["candidates"][0]["range"]["mean"]
