"""The check catches a broken timed path: each run drives the whole harness
on the CPU (without the look for a card) with one fault planted in the port,
and ``correct`` comes out false. A sound run's ``correct`` is true
(``test_bench_runs``). The faults a cell of this benchmark can have: a
flight step that returns its state unchanged; half of the batch left out
of the statistics, the mean taken over the rest; an answer altered where it
is produced (a flight's summary, a drawn lane, a go/no-go row). A cell has
no optimizer state and no exchange between chips."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from gpu_bench.tests.fixtures import tiny_root  # noqa: F401
from gpu_bench.tests.test_bench_runs import run_cell


def _half_stats(monkeypatch):
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer
    real = analyzer.masked_stats

    def half(values, mask):
        keep = torch.arange(mask.numel(), device=mask.device) < mask.numel() // 2
        return real(values, mask & keep)

    monkeypatch.setattr(analyzer, "masked_stats", half)


def _altered_flight(monkeypatch):
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer
    real = analyzer.simulate_summary_batch

    def altered(*a, **kw):
        s = real(*a, **kw)
        return dataclasses.replace(s, apogee_altitude=s.apogee_altitude * 1.001)

    monkeypatch.setattr(analyzer, "simulate_summary_batch", altered)


def _altered_draw(monkeypatch):
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer
    real = analyzer._draw_single

    def altered(*a, **kw):
        scene_b, ic_b, sample = real(*a, **kw)
        return scene_b, ic_b, dataclasses.replace(
            sample, density_multiplier=sample.density_multiplier * 1.001)

    monkeypatch.setattr(analyzer, "_draw_single", altered)


def _altered_row(monkeypatch):
    from erpl_monte_carlo_sim_tpu_torch.cli import launch_window
    real = launch_window.exceedance_from_analysis

    def altered(*a, **kw):
        rows = real(*a, **kw)
        return [dict(r, probability=r["probability"] + 1.0 / r["n"],
                     n_exceed=r["n_exceed"] + 1) for r in rows]

    monkeypatch.setattr(launch_window, "exceedance_from_analysis", altered)


def _step_unchanged(monkeypatch):
    from erpl_monte_carlo_sim_tpu_torch.engine import component

    monkeypatch.setattr(component, "rk4_c",
                        lambda scene, cfg, wind_fn, t, st, para, dt=None: (st, para))


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_stats,
          "flight_altered": _altered_flight, "draw_altered": _altered_draw,
          "row_altered": _altered_row}
CASES = [("tiny.analysis", "step_unchanged"), ("tiny.analysis", "half_batch"),
         ("tiny.analysis", "flight_altered"), ("tiny.analysis", "draw_altered"),
         ("tiny.gonogo", "step_unchanged"), ("tiny.gonogo", "half_batch"),
         ("tiny.gonogo", "flight_altered"), ("tiny.gonogo", "row_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(tiny_root, capsys, monkeypatch, cell, fault):  # noqa: F811
    FAULTS[fault](monkeypatch)
    rc, out, err = run_cell(tiny_root, cell, capsys, seed=99)
    assert rc == 0, err[-20:]
    res = json.loads(out[-1])
    assert res["correct"] is False, res["checks"]
