"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary checkout root with tiny cells added as new files, which the CPU
tests run; and the ``card`` fixture of the tests that need an NVIDIA GPU.

The test files import these fixtures by name. Run them from the repository
root with ``python -m pytest --noconftest -q gpu_bench/tests`` (no JAX is
imported then); on a card, ``-m cuda`` runs the control."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from gpu_bench import spec

# the tiny cells: a 2 s window of each configuration, a few lanes, each
# held to the limits of the cell it stands for
TINY_CELLS = {
    "tiny.analysis": ("liquid_window6", "window6.mc1m", {
        "entry": "analysis", "n_samples": 16, "check_lanes": 6}),
    "tiny.slabbed": ("liquid_window6", "window6.mc1m", {
        "entry": "analysis", "n_samples": 24, "lane_slab": 8, "check_lanes": 6}),
    "tiny.gonogo": ("liquid_landing_stabilized", "landing.gonogo2k", {
        "entry": "gonogo", "n": 16, "range_limit": 2.0, "p_limit": 0.01, "speeds": [2, 11],
        "directions_deg": [0, 90], "check_lanes": 6,
        "dispersions": {"wind_speed_range": [0.0, 0.0], "wind_direction_range": [0.0, 0.0]}}),
}


def make_root(path: str) -> str:
    """A checkout root at ``path``: ``BENCHMARK.json`` and a copy of the
    benchmark's folder, with the tiny cells added as new files only."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), path)
    shutil.copytree(os.path.join(spec.ROOT, spec.HERE), os.path.join(path, spec.HERE),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(path, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (config, like, mix) in TINY_CELLS.items():
        with open(os.path.join(path, spec.HERE, "configs", f"{config}.json")) as f:
            c = json.load(f)
        c["name"] = f"{config}_tiny"
        c["sim_config"]["max_time"] = 2.0
        cfg_file = f"{spec.HERE}/configs/{c['name']}.json"
        if not any(x["name"] == c["name"] for x in bench["configs"]):
            with open(os.path.join(path, cfg_file), "w") as f:
                json.dump(c, f)
            bench["configs"].append({"name": c["name"], "source": "a test", "file": cfg_file,
                                     "reduced": ["max_time"], "why": "a test"})
        mix_name = cell.replace(".", "_")
        with open(os.path.join(path, spec.HERE, "mixes", f"{mix_name}.json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(path, spec.HERE, "limits", f"{like}.json")) as f:
            limits = json.load(f)
        with open(os.path.join(path, spec.HERE, "limits", f"{cell}.json"), "w") as f:
            # a slabbed run returns no sample: no draw is compared
            json.dump({k: v for k, v in limits.items()
                       if k != "draw_gap" or "lane_slab" not in mix}, f)
        bench["workloads"].append({"name": cell, "config": c["name"], "traffic": mix_name,
                                   "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(TINY_CELLS)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_root(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
