"""PyTorch port, the user's entry point: ``example.main`` against the JAX
package's on the same lanes, on the CPU.

Both examples run whole, with their ``SimConfig`` patched to a 2 s window
(the port's plain version costs about 13 ms a step on the CPU; 2 s is past
the outlier filter's 100 m apogee floor): the CSV-wind single flight, a
50-lane Monte Carlo perturbing the packaged forecast (the port's run takes
the JAX sampler's lanes through its draw seam, ``mc.analyzer._draw_single``),
the report, the per-sim exports and every figure, each example in its own
working directory. Held: the same file names, the report's statistics
blocks at rtol 1e-9 (the report's keys at every depth), and the single
flight's headline values.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.example as jax_example
import erpl_monte_carlo_sim_tpu_torch.example as example
import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)
from test_torch_reporting import same_keys

torch.set_num_threads(1)

WINDOW = 2.0
N = 50


def jax_single(analyzer, ic, n, seed, base_wind):
    params = JaxUncertainty(**dataclasses.asdict(analyzer.uncertainty_params))
    scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), jax_nominal(jax_liquid()),
                                       JaxIC.vertical_launch(), params, n,
                                       base_wind=base_wind)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def files(out):
    return sorted(os.path.relpath(os.path.join(root, f), out)
                  for root, _, fs in os.walk(out) for f in fs)


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """``{package: (results, analysis, output dir)}`` of both examples."""
    base = tmp_path_factory.mktemp("examples")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_example, "SimConfig",
                   lambda **kw: JaxConfig(max_time=WINDOW, **kw))
        mp.setattr(example, "SimConfig", lambda **kw: SimConfig(max_time=WINDOW, **kw))
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        for name, run in (("jax", lambda: jax_example.main(N)),
                          ("port", lambda: example.main(N, device="cpu"))):
            os.makedirs(base / name)
            mp.chdir(base / name)
            results, analysis, out_dir = run()
            out[name] = (results, analysis, str(base / name / out_dir))
    return out


def test_example_writes_jax_files(mains):
    ref, got = files(mains["jax"][2]), files(mains["port"][2])
    assert got == ref
    assert {"monte_carlo_report.json", "monte_carlo_report.txt",
            "monte_carlo_distributions.png", "landing_footprint.png",
            "monte_carlo_trajectories.png", "monte_carlo_trajectories_3d.png",
            "single_simulation_results.png", "thrust_twr.png"} <= set(got)
    assert sum(f.startswith("simulation_results/") for f in got) == \
        min(N, mains["port"][1]["n_samples"]) > 0
    for f in got:
        assert os.path.getsize(os.path.join(mains["port"][2], f)) > 0, f


def test_example_report_matches_jax(mains):
    ref, got = (json.load(open(os.path.join(mains[k][2], "monte_carlo_report.json")))
                for k in ("jax", "port"))
    same_keys(ref, got)  # every key at every depth
    assert got["simulation_summary"] == ref["simulation_summary"]
    for key in ("apogee_altitude_stats", "range_stats", "flight_time_stats"):
        assert got[key].keys() == ref[key].keys()
        for stat, a in ref[key].items():
            np.testing.assert_allclose(np.asarray(got[key][stat], np.float64),
                                       np.asarray(a, np.float64), rtol=1e-9,
                                       err_msg=f"{key}.{stat}")
    assert got["rocket_parameters"]["name"] == "Sounding Rocket"


def test_example_single_flight_matches_jax(mains):
    ref, got = mains["jax"][0], mains["port"][0]
    assert got.keys() == ref.keys()
    for key in ("apogee_altitude", "apogee_time", "range", "flight_time", "rail_exit_speed",
                "rail_exit_angle_of_attack", "rail_exit_sideslip"):
        np.testing.assert_allclose(got[key], ref[key], rtol=5e-7, err_msg=key)
    np.testing.assert_array_equal(got["wind_profile"], ref["wind_profile"])


def test_main_raises_without_a_card():
    """``device="cuda"`` is the default and has no fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        example.main(4)
