"""PyTorch port, the ``tail_probability`` CLI against the JAX package's on
the CPU, float64.

``--gpd`` and ``--shift`` run in both packages on the solid motor's 1.4 s
window (about half of the lanes pass the default 100 m apogee floor), the
port's analyzer fed the JAX sampler's lanes through its draw seam
(``mc.analyzer._draw_single``): the JSON objects have the same keys, counts
and methods, every probability, interval and fit within rtol 1e-9.
``--subset``'s JSON is held to JAX's in tests/test_torch_subset.py, beside
the ``subset_tail`` result it prints. ``--auto-shift`` runs the importance
estimator on the tilt that ``mc.importance.auto_shift`` picks from one
reverse pass (tests/test_torch_sensitivity.py holds that rule).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu.cli.tail_probability import tail_probability as jax_tail
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu_torch.cli.tail_probability import main
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)

torch.set_num_threads(1)

THRESHOLD = 112.0
COMMON = dict(n=64, seed=1, solid=True, max_time=1.4)
ARGV = ["--metric", "apogee_altitude", "--threshold", str(THRESHOLD), "--n", "64", "--seed",
        "1", "--solid", "--max-time", "1.4", "--device", "cpu"]
CASES = {
    "gpd": (dict(gpd=True, n_tail=20), ["--gpd", "--n-tail", "20"]),
    "shift": (dict(shift={"motor_thrust": 1.5}), ["--shift", "motor_thrust=1.5"]),
}


def jax_single(analyzer, ic, n, seed, base_wind):
    params = JaxUncertainty(**dataclasses.asdict(analyzer.uncertainty_params))
    scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), jax_nominal(jax_solid()),
                                       JaxIC.vertical_launch(), params, n,
                                       importance_shift=analyzer.importance_shift)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def close(got, ref, path="out"):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            close(a, b, f"{path}[{i}]")
    elif isinstance(ref, (bool, str, int)) or ref is None:
        assert got == ref, (path, got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0.0, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_json_is_jax(case, capsys):
    kw, argv = CASES[case]
    ref = json.loads(json.dumps(jax_tail("apogee_altitude", THRESHOLD, **COMMON, **kw)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        got = main(ARGV + argv)
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    close(json.loads(json.dumps(got)), ref)
    assert got["method"] == {"gpd": "gpd", "shift": "importance"}[case]
    assert 0 < got["n_valid"] < got["n_lanes"]


def test_auto_shift_and_exclusive_options(capsys):
    out = main(ARGV + ["--auto-shift"])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(out))
    assert out["method"] == "importance" and out["shift"] == out["auto_shift"]["shift"]
    assert out["shift"].get("motor_thrust", 0.0) > 0.0  # an upper tail of the apogee
    assert 0.0 <= out["probability"] <= 1.0 and out["n_eff"] > 0
    with pytest.raises(SystemExit):
        main(ARGV + ["--auto-shift", "--shift", "mass=1"])
    for extra, match in ((["--gpd", "--shift", "mass=1"], "exclusive"),
                         (["--subset", "--gpd"], "its own estimator"),
                         (["--p-target", "1e-3"], "needs --subset")):
        with pytest.raises(ValueError, match=match):
            main(ARGV + extra)
