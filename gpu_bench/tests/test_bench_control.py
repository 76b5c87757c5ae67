"""The control comes out as not correct: the plain reference, in the
precision below the configuration's (``check.CONTROL``), put in the
program's place, fails at least one of a cell's limits, where the program
itself keeps to all of them. On the CPU at the tiny cells' sizes, and with
``-m cuda`` on a card; the cells' own sizes are read on the card by
``python3 -m gpu_bench.calibrate``."""

from __future__ import annotations

import pytest

from gpu_bench import run
from gpu_bench.calibrate import readings
from gpu_bench.tests.fixtures import card, tiny_root  # noqa: F401


def _held(values: dict, limits: dict) -> bool:
    return all(name in values and values[name] <= limit for name, limit in limits.items())


@pytest.mark.parametrize("cell", ["tiny.analysis", "tiny.slabbed", "tiny.gonogo"])
@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_control_fails(tiny_root, request, cell, where):  # noqa: F811
    device = request.getfixturevalue("card") if where == "cuda" else "cpu"
    c, bench = run.prepare(cell, tiny_root, device)
    got = []
    readings(c, bench, [2_718_281_828_459], 1, got.append)
    by_side = {r["side"]: r["values"] for r in got}
    assert _held(by_side["program"], c.limits), by_side["program"]
    assert not _held(by_side["control"], c.limits), by_side["control"]
