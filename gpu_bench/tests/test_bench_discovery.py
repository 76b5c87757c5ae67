"""A configuration, a traffic mix and a metric are found by name from new
files alone: the tiny cells of ``fixtures`` and a metric reader added here
are new files, and no file the benchmark already had changes."""

from __future__ import annotations

import filecmp
import json
import os

from gpu_bench import spec
from gpu_bench.tests.fixtures import make_root
from gpu_bench.tests.test_bench_runs import run_cell

READER = '''"""analyses_in_window: how many analyses the window ran."""


def read(run):
    return float(len(run.walls))
'''


def test_new_files_alone(tmp_path, capsys):
    root = make_root(str(tmp_path))
    with open(os.path.join(root, spec.HERE, "metrics", "analyses_in_window.py"), "w") as f:
        f.write(READER)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["end_to_end"].append({"name": "analyses_in_window", "unit": "1", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.analysis"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell("tiny.analysis", root)
    assert cell.config["name"] == "liquid_window6_tiny" and cell.mix["n_samples"] == 16
    rc, out, _ = run_cell(root, "tiny.analysis", capsys)
    res = json.loads(out[-1])
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["analyses_in_window"]["value"] == res["attempted"]
    # every file the benchmark had is as it was
    ours = os.path.join(spec.ROOT, spec.HERE)
    for d, _, files in os.walk(ours):
        if "__pycache__" in d or os.sep + "tests" in d[len(ours):]:
            continue
        for name in files:
            if name.endswith((".py", ".json")):
                rel = os.path.relpath(os.path.join(d, name), ours)
                assert filecmp.cmp(os.path.join(ours, rel), os.path.join(root, spec.HERE, rel),
                                   shallow=False), rel
