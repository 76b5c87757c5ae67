"""PyTorch port, the CSV-wind flight on the reference forecast recovered from
the repository (ROADMAP F1).

The executed reference flew tests/golden/flight_liquid_csvwind.json on a
forecast CSV that is not in the repository. Its Monte Carlo golden
tests/golden/mc_forecast.jsonl holds each lane's realized wind table: the
forecast perturbed by AR(1) turbulence plus the lane's uniform offset
``(wind_speed cos(wind_direction), wind_speed sin(wind_direction), 0)``
(scripts/gen_mc_golden.py). Taking the offset away and averaging the 220
lanes gives the forecast back, to within the turbulence's sampling error:
integers, committed as ``erpl_monte_carlo_sim_tpu_torch/data/
reference_sample_wind.csv``. The port's float64 flight on it meets the
golden at tests/test_wind_flight_parity.py's bars (rail exit, and the
probes up to 10.5 s of an 11 s window, before the reference's own flight
diverges), and the JAX package's flight on the same file at
tests/test_trajectory_batch.py's bars.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_flight_batch as jax_flight_batch
from erpl_monte_carlo_sim_tpu.models import WindField as JaxWindField
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import load_wind_profile_from_csv as jax_load_csv
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_flight_batch)
from erpl_monte_carlo_sim_tpu_torch.models import (WindField, liquid_motor,
                                                   load_wind_profile_from_csv, nominal_scene)
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy
from test_torch_flight import compare
from test_torch_trajectory import compare_trajectories

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(ROOT, "erpl_monte_carlo_sim_tpu_torch", "data", "reference_sample_wind.csv")
GOLDEN = os.path.join(ROOT, "tests", "golden")
WINDOW = 11.0  # the pre-divergence window of tests/test_wind_flight_parity.py


def recovered_forecast():
    """``(grid, mean table [6, 3], lane spread [6, 3])`` of the forecast
    under the golden Monte Carlo's lanes."""
    tables, grid = [], None
    with open(os.path.join(GOLDEN, "mc_forecast.jsonl")) as f:
        for line in f:
            lane = json.loads(line)
            if lane.get("failed"):
                continue
            w = np.asarray(lane["wind_profile"], np.float64)
            p = lane["params"]
            w[:, 0] -= p["wind_speed"] * np.cos(p["wind_direction"])
            w[:, 1] -= p["wind_speed"] * np.sin(p["wind_direction"])
            tables.append(w)
            grid = lane["wind_grid"]
    tables = np.stack(tables)
    return np.asarray(grid), tables.mean(0), tables.std(0), len(tables)


def test_recovered_csv_is_the_goldens_forecast():
    grid, mean, spread, n = recovered_forecast()
    alts, wind = load_wind_profile_from_csv(CSV)
    assert n == 220
    np.testing.assert_array_equal(alts, grid)
    np.testing.assert_array_equal(np.round(mean), wind)  # -0.0 == 0.0
    assert np.array_equal(wind, np.round(wind))  # integers
    # each knot's mean within 4 standard errors of the committed value
    assert (np.abs(mean - wind) <= 4 * spread / np.sqrt(n) + 1e-12).all()
    # the turbulence decays with altitude: 1.97 m/s at the ground, none aloft
    assert 1.9 < spread[0].max() < 2.0 and spread[4:].max() < 1e-3


@pytest.fixture(scope="module")
def flight():
    """The port's float64 CSV-wind flight, recorded, in the window: NumPy
    ``(summary, trajectory)`` of the one lane."""
    alts, wind = load_wind_profile_from_csv(CSV)
    scene = dataclasses.replace(nominal_scene(liquid_motor("cpu")),
                                wind=WindField.from_arrays(alts, wind, "cpu"))
    ic = InitialConditions.vertical_launch("cpu")
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                 ic.angular_velocity)))
    s, t = simulate_flight_batch(scene, ic1, SimConfig(max_time=WINDOW))
    return to_numpy(s), to_numpy(t)


def test_rail_exit_meets_the_golden(flight, golden_flight_csvwind):
    s, _ = flight
    g = golden_flight_csvwind
    assert float(s.rail.rail_exit_speed[0]) == pytest.approx(g["rail_exit_speed"], rel=1e-5)
    assert float(s.rail.rail_exit_angle_of_attack[0]) == pytest.approx(g["rail_exit_aoa"],
                                                                       rel=1e-3)
    assert float(s.rail.rail_exit_sideslip[0]) == pytest.approx(g["rail_exit_sideslip"],
                                                                rel=1e-2, abs=1e-6)


def test_trajectory_probes_meet_the_golden(flight, golden_flight_csvwind):
    _, t = flight
    valid = t.valid[0]
    time = t.time[0][valid]
    pos = t.position[0][valid]
    speed = t.derived["speed"][0][valid]
    aoa = t.derived["angle_of_attack"][0][valid]
    probes = [p for p in golden_flight_csvwind["probes"] if p["t"] <= 10.5]
    assert len(probes) == 4
    for probe in probes:
        i = int(np.argmin(np.abs(time - probe["t"])))
        assert pos[i, 2] == pytest.approx(probe["alt"], rel=2e-3), probe["t"]
        assert speed[i] == pytest.approx(probe["speed"], rel=2e-3), probe["t"]
        assert pos[i, 0] == pytest.approx(probe["x"], rel=0.05, abs=0.5), probe["t"]
        assert pos[i, 1] == pytest.approx(probe["y"], rel=0.05, abs=0.5), probe["t"]
        assert aoa[i] == pytest.approx(probe["aoa"], abs=3e-3), probe["t"]


def test_flight_matches_jax_on_the_same_file(flight):
    alts, wind = jax_load_csv(CSV)
    scene = jax_nominal(jax_liquid()).replace(wind=JaxWindField.from_arrays(alts, wind))
    ic1 = jax.tree.map(lambda x: np.asarray(x)[None], JaxIC.vertical_launch())
    ref_s, ref_t = jax_flight_batch(scene, ic1, JaxConfig(max_time=WINDOW))
    compare(jax.tree.map(np.asarray, ref_s), flight[0], 5e-7)
    compare_trajectories(jax.device_get(ref_t), flight[1])
