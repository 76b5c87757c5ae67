"""``flights_per_s`` and ``analysis_p90_s`` are taken over every analysis
of the window: one stalled analysis moves both."""

from __future__ import annotations

import time

from gpu_bench import run
from gpu_bench.spec import load_cell
from gpu_bench.tests.fixtures import tiny_root  # noqa: F401


class Entry:
    """Analyses of 10 ms, one of them stalled by ``stall`` seconds."""

    def __init__(self, stall_at=None, stall=0.0):
        self.stall_at, self.stall = stall_at, stall

    def run(self, state, seed):
        state["i"] += 1
        time.sleep(0.01 + (self.stall if state["i"] == self.stall_at else 0.0))
        return 100, None


def _metrics(tiny_root, entry):  # noqa: F811
    cell = load_cell("tiny.analysis", tiny_root)
    walls, flights, window_s, _, _ = run._window(entry, {"i": 0}, 5, 0.3, False,
                                                 lambda *a: None, lambda r: None)
    r = run.Run(cell=cell, setup_s=0.0, walls=walls, flights=flights, window_s=window_s)
    return (cell.reader("flights_per_s").read(r), cell.reader("analysis_p90_s").read(r),
            len(walls))


def test_a_stall_moves_rate_and_tail(tiny_root):  # noqa: F811
    rate, p90, n = _metrics(tiny_root, Entry())
    assert n >= 20 and p90 < 0.05
    s_rate, s_p90, s_n = _metrics(tiny_root, Entry(stall_at=3, stall=0.5))
    # the window closes after the stalled analysis, which every metric counts
    assert s_n == 3
    assert s_p90 > 0.3 and s_rate < 0.5 * rate
