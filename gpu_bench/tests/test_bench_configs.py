"""The configuration files hold what the port's README runs: the vehicle of
``nominal_scene(liquid_motor)``, the launch of
``InitialConditions.vertical_launch``, the analyzer's default dispersions,
and ``SimConfig`` fields that exist."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from gpu_bench import program, spec


def _configs():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [c["file"] for c in bench["configs"]]


@pytest.mark.parametrize("path", _configs())
def test_config_is_the_readme_vehicle(path):
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.mc.dispersions import UncertaintyParams
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene

    with open(os.path.join(spec.ROOT, path)) as f:
        cfg = json.load(f)
    dtype = getattr(torch, cfg["dtype"])
    got = program.scene(cfg, "cpu", dtype)
    want = nominal_scene(liquid_motor("cpu", dtype))
    for part in ("rocket", "motor", "atmosphere", "wind_model"):
        for f in dataclasses.fields(getattr(want, part)):
            a, b = getattr(getattr(want, part), f.name), getattr(getattr(got, part), f.name)
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b.reshape(a.shape)), (part, f.name)
            else:
                assert a == b, (part, f.name)
    ic = program.initial_conditions(cfg, "cpu", dtype)
    ref = InitialConditions.vertical_launch("cpu", dtype)
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(ic, f.name), getattr(ref, f.name))
    assert program.uncertainty(cfg) == UncertaintyParams()
    SimConfig(**cfg["sim_config"])
    assert set(cfg["reduced"]) == set()
