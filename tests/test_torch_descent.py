"""PyTorch port, the tiered timestep to landing: ``scripts/full_flights.py``'s
configuration (``energy_consistent_aero``, ``descent_dt_scale=16``,
``ascent_q_threshold=8000``), with RK4 and with rk2, on the low-apogee
scenes of tests/test_descent.py, against the JAX package's
``simulate_summary_batch`` lane for lane at the bars of
tests/test_torch_flight.py. The flights pass every gate of the tiered loop:
the coarse quiet coast, fine steps through the chute latch, the coarse
canopy descent, each lane's own time. Dispersed full flights are held in
float64 only: over about 5k steps float32 rounds differently in XLA and
in PyTorch's CPU kernels (ROADMAP F8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.models as jmod
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import FULL_FLIGHTS, LOW_APOGEE_PROPELLANT
from test_torch_flags import DTYPES, run_both
from test_torch_flight import BARS, compare, jax_batch

torch.set_num_threads(1)


def low_apogee_batch(dtype):
    """The JAX package's side of ``kernels/measure.py low_apogee_batch``: the
    two scenes of tests/test_descent.py::test_tiered_dt_low_apogee_guard
    (``LOW_APOGEE_PROPELLANT``, 5 and 7 kg: apogee about 476 and 880 m,
    below the 1 km apogee gate) as the two lanes of one batch, vertical
    launch, no wind."""
    scenes = []
    for pm in LOW_APOGEE_PROPELLANT:
        scene = jmod.nominal_scene(jmod.liquid_motor(propellant_mass=pm))
        scenes.append(scene.replace(rocket=jmod.RocketParams.create(propellant_mass=pm)))

    def lanes(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if np.issubdtype(a.dtype, np.floating):
            out = a if np.array_equal(a, b) else np.stack([a, b])
            return jnp.asarray(out, dtype)
        return a

    scene_b = jax.tree.map(lanes, *scenes)
    ic = JaxIC.vertical_launch(dtype=dtype)
    ic_b = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(x, dtype), (2,) + np.shape(x)),
                        ic)
    return scene_b, ic_b


@DTYPES
@pytest.mark.parametrize("integrator", ["rk4", "rk2"])
def test_full_flights_set_to_landing_matches_jax(integrator, dtype):
    """Both scenes in one batch, to landing under the chute."""
    ref, got = run_both(*low_apogee_batch(dtype), integrator=integrator, **FULL_FLIGHTS)
    compare(ref, got, BARS[dtype])
    assert (got.apogee_altitude < 1000.0).all() and got.parachute_deployed.all()
    assert not got.diverged.any() and (got.landing_position[:, 2] <= 0.5).all()
    # coarse steps were taken: a 70-90 s flight in far fewer than 14k steps
    assert (got.n_steps < 3500).all() and (got.flight_time > 60.0).all()


def test_dispersed_full_flights_match_jax():
    """Eight dispersed lanes (0-5 m/s synthesized wind) flown to landing
    under the full_flights.py set in float64: about 5k steps each, with
    the weathercocked apogees of 2-4.5 km the reference physics gives
    them."""
    ref, got = run_both(*jax_batch("liquid", jnp.float64, n=8), **FULL_FLIGHTS)
    compare(ref, got, BARS[jnp.float64])
    assert not got.diverged.any() and got.parachute_deployed.all()
    assert (got.n_steps > 4000).all() and (got.landing_position[:, 2] <= 0.5).all()
