"""PyTorch port, the single-flight goldens of the executed reference
(tests/golden/flight_liquid_nowind.json and flight_solid_nowind.json), held
as tests/test_flight.py holds the JAX package.

The whole flights (40k steps to landing) are too slow for the port's plain
version on the CPU (about 13 ms a step), so this file flies each motor in
float64 for a 6 s window (5 s past the rail), through the recorder: the rail exit at
``_check_summary``'s bars (time within 0.011 s, speed rel 1e-4, angle of
attack within 1e-6, position rtol 1e-3) and the probes inside the window
at tests/test_flight.py's bars for that motor. The summaries to landing
(apogee rel 1e-5 liquid / 5e-4 solid, range rel 5e-3, times rel 1e-2) are
held on the card by chip_smoke.py phase 3, in float64 through the kernel.
"""

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_flight_batch)
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, solid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

torch.set_num_threads(1)

WINDOW = 6.0  # from launch; the probe times count from the rail exit
# tests/test_flight.py's probe bars: (alt rel, speed rel, speed abs, mass rel)
PROBE_BARS = {"liquid": (2e-4, 2e-3, 0.2, 1e-4), "solid": (2e-3, 3e-3, 0.3, 1e-3)}
MOTORS = {"liquid": liquid_motor, "solid": solid_motor}


@pytest.fixture(scope="module")
def flights():
    """Each motor's float64 flight in the window: NumPy ``(summary,
    trajectory)`` of the one lane, flown on first use."""
    cache = {}

    def fly(motor):
        if motor not in cache:
            scene = nominal_scene(MOTORS[motor]("cpu"))
            ic = InitialConditions.vertical_launch("cpu")
            ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity,
                                                         ic.attitude, ic.angular_velocity)))
            s, t = simulate_flight_batch(scene, ic1, SimConfig(max_time=WINDOW))
            cache[motor] = (to_numpy(s), to_numpy(t))
        return cache[motor]

    return fly


@pytest.fixture(scope="module")
def goldens(golden_flight_liquid, golden_flight_solid):
    return {"liquid": golden_flight_liquid, "solid": golden_flight_solid}


@pytest.mark.parametrize("motor", ["liquid", "solid"])
def test_rail_exit_meets_the_golden(flights, goldens, motor):
    s, _ = flights(motor)
    g = goldens[motor]
    rail = s.rail
    assert float(rail.rail_exit_time[0]) == pytest.approx(g["rail_exit_time"], abs=0.011)
    assert float(rail.rail_exit_speed[0]) == pytest.approx(g["rail_exit_speed"], rel=1e-4)
    assert float(rail.rail_exit_angle_of_attack[0]) == pytest.approx(g["rail_exit_aoa"],
                                                                     abs=1e-6)
    np.testing.assert_allclose(rail.rail_exit_position[0], g["rail_exit_position"],
                               rtol=1e-3, atol=1e-6)
    assert not bool(s.diverged[0])


@pytest.mark.parametrize("motor", ["liquid", "solid"])
def test_probes_meet_the_golden(flights, goldens, motor):
    _, t = flights(motor)
    valid = t.valid[0]
    time = t.time[0][valid]
    alt = t.position[0][valid][:, 2]
    speed, mass = t.derived["speed"][0][valid], t.derived["mass"][0][valid]
    thrust = t.derived["thrust"][0][valid]
    alt_rel, speed_rel, speed_abs, mass_rel = PROBE_BARS[motor]
    probes = [p for p in goldens[motor]["probes"] if p["t"] <= WINDOW - 1.0]
    assert len(probes) == 3
    for probe in probes:
        i = int(np.argmin(np.abs(time - probe["t"])))
        assert alt[i] == pytest.approx(probe["alt"], rel=alt_rel), probe["t"]
        assert speed[i] == pytest.approx(probe["speed"], rel=speed_rel, abs=speed_abs), \
            probe["t"]
        assert mass[i] == pytest.approx(probe["mass"], rel=mass_rel), probe["t"]
        if motor == "solid":  # the thrust-curve interpolation path
            assert thrust[i] == pytest.approx(probe["thrust"], rel=1e-3, abs=2.0), probe["t"]
