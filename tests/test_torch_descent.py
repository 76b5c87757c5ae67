"""PyTorch port, the tiered timestep to landing: ``scripts/full_flights.py``'s
configuration (``energy_consistent_aero``, ``descent_dt_scale=16``,
``ascent_q_threshold=8000``), with RK4 and with rk2, on the low-apogee
scenes of tests/test_descent.py, against the JAX package's
``simulate_summary_batch`` lane for lane at the bars of
tests/test_torch_flight.py. The flights pass every gate of the tiered loop:
the coarse quiet coast, fine steps through the chute latch, the coarse
canopy descent, each lane's own time. Dispersed full flights are held in
float64 only: over about 5k steps float32 rounds differently in XLA and
in PyTorch's CPU kernels (ROADMAP F8).

The low-apogee checks run in tests/test_torch_landing_f64.py and _f32.py,
one precision each, beside the emulated kernel's flights of the same scenes
(tests/test_torch_kernel_emulated.py builds it): both hold the plain
version's flights, which ``plain_to_landing`` makes once per flag set and
precision, the slowest part of either check (about 3k eager steps).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import erpl_monte_carlo_sim_tpu.models as jmod
from chip_smoke import compare as compare_outputs
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_summary_batch as jax_summary_batch
from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.batch import _summary_pytree, prepare_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import (FLAG_SETS, FULL_FLIGHTS,
                                                            LOW_APOGEE_PROPELLANT)
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import low_apogee_batch as port_batch
from erpl_monte_carlo_sim_tpu_torch.utils.convert import ic_from_numpy, scene_from_numpy, to_numpy
from test_torch_flags import run_both
from test_torch_flight import BARS, compare, jax_batch
from test_torch_kernel_emulated import run_emulated

torch.set_num_threads(1)

# the flag set of each integrator (kernels/measure.py FLAG_SETS)
SETS = {"rk4": "full_flights", "rk2": "full_flights+rk2"}
TORCH = {jnp.float64: torch.float64, jnp.float32: torch.float32}


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


@functools.lru_cache(maxsize=None)
def plain_to_landing(name, dtype):
    """The plain version's flights of the low-apogee scenes
    (``kernels/measure.py low_apogee_batch``) to landing under a tiered flag
    set: ``(prepared inputs, SimConfig, output dict)``, made once."""
    cfg = SimConfig(**FLAG_SETS[name][0])
    args = prepare_batch(*port_batch("cpu", dtype))
    return args, cfg, fs.flight_summary_reference(*args, cfg)


def tensors(x):
    """Every tensor of prepared inputs, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensors(getattr(x, f.name))


def check_full_flights_set_to_landing(integrator, dtype):
    """Both scenes in one batch, to landing under the chute: the JAX
    package's flights against the port's on the same inputs. The JAX batch,
    carried across, is the port's ``low_apogee_batch`` bit for bit, so the
    port's flights are ``plain_to_landing``'s (``simulate_summary_batch``
    on CPU tensors is the plain version)."""
    scene_b, ic_b = low_apogee_batch(dtype)
    args, cfg, out = plain_to_landing(SETS[integrator], TORCH[dtype])
    mine = list(tensors(prepare_batch(scene_from_numpy(scene_b, "cpu"),
                                      ic_from_numpy(ic_b, "cpu"))))
    theirs = list(tensors(args))
    assert len(mine) == len(theirs) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(mine, theirs))
    ref = jax.tree.map(np.asarray, jax_summary_batch(
        scene_b, ic_b, JaxConfig(integrator=integrator, **FULL_FLIGHTS)))
    got = to_numpy(_summary_pytree(out))
    compare(ref, got, BARS[dtype])
    assert (got.apogee_altitude < 1000.0).all() and got.parachute_deployed.all()
    assert not got.diverged.any() and (got.landing_position[:, 2] <= 0.5).all()
    # coarse steps were taken: a 70-90 s flight in far fewer than 14k steps
    assert (got.n_steps < 3500).all() and (got.flight_time > 60.0).all()


def landing_builds() -> set:
    """The kernel builds of the tiered flag sets."""
    return {fs.kernel_flags(SimConfig(**FLAG_SETS[name][0]), FLAG_SETS[name][1])
            for name in SETS.values()}


def check_emulated_tiered_set_to_landing(libs, name, dtype):
    """The tiered builds of the emulated kernel on the low-apogee scenes to
    landing, against the plain version: fine steps through the chute latch,
    coarse quiet coast and canopy descent, each lane's own time."""
    args, cfg, ref = plain_to_landing(name, dtype)
    got = run_emulated(libs, *args, cfg)
    compare_outputs(ref, got, dtype)
    assert bool(got["parachute_deployed"].all()) and not bool(got["diverged"].any())
    assert bool((got["n_steps"] < 3500).all()) and bool((got["final_pz"] <= 0.5).all())


def test_dispersed_full_flights_match_jax():
    """Eight dispersed lanes (0-5 m/s synthesized wind) flown to landing
    under the full_flights.py set in float64: about 5k steps each, with
    the weathercocked apogees of 2-4.5 km the reference physics gives
    them."""
    ref, got = run_both(*jax_batch("liquid", jnp.float64, n=8), **FULL_FLIGHTS)
    compare(ref, got, BARS[jnp.float64])
    assert not got.diverged.any() and got.parachute_deployed.all()
    assert (got.n_steps > 4000).all() and (got.landing_position[:, 2] <= 0.5).all()
