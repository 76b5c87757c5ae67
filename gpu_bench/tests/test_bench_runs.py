"""Tiny CPU runs of every entry through the whole harness: the result line
carries exactly the contract's keys, with names and units of the allowed
characters, and the compared numbers come last on standard error."""

from __future__ import annotations

import json
import re

import pytest

from gpu_bench import run
from gpu_bench.tests.fixtures import tiny_root  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run_cell(root, cell, capsys, trace=0, seconds=0.2, seed=3_000_000_017):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device="cpu")
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err.strip().splitlines()


@pytest.mark.parametrize("cell,trace", [("tiny.analysis", 0), ("tiny.analysis", 1),
                                        ("tiny.slabbed", 0), ("tiny.gonogo", 0)])
def test_result_line(tiny_root, capsys, cell, trace):  # noqa: F811
    rc, out, err = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 0, err[-20:]
    res = json.loads(out[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(res) == keys + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    else:
        assert {"flights_per_s", "setup_s"} <= set(res["metrics"])
    for name, m in res["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]), (name, m)
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    # the compared numbers, each beside its limit, are stderr's last lines
    checks = res["checks"]
    assert set(checks) >= {"lanes_off", "lane_gap", "stats_gap", "exact_off"}
    tail = err[-len(checks):]
    for line, (name, c) in zip(tail, checks.items()):
        assert line == f"check {name} {c['value']} limit {c['limit']}"


def test_slabbed_analysis_has_metrics_not_summary(tiny_root, capsys):  # noqa: F811
    """The slabbed route returns per-lane ``metrics`` in place of
    ``summary``; its check compares the kept lanes and the statistics."""
    rc, out, _ = run_cell(tiny_root, "tiny.slabbed", capsys, seed=12)
    checks = json.loads(out[-1])["checks"]
    assert rc == 0
    assert "draw_gap" not in checks
    assert checks["lanes_off"]["value"] == 0.0 and checks["exact_off"]["value"] == 0.0
