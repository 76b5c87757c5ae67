"""PyTorch port, trajectory recording: ``engine.batch.simulate_flight_batch``
against the JAX package's on the same lanes.

On CPU tensors the port records through ``flight_components_trajectory``,
the plain version of the kernel's recording build. JAX-sampled lanes,
converted, fly through both packages; the bars and pattern are those of
tests/test_trajectory_batch.py: summary and state leaves at rtol 5e-7 /
atol 1e-6, derived channels at rtol 1e-6, ``valid`` exact, float64. Two
configurations: a parity window (2 s, ``record_stride=2``) of four
dispersed lanes, and the tiered full-flight set on the low-apogee scenes
to landing. Port-only checks: the recorder's summary is
``simulate_summary_batch``'s bit for bit, ``record_stride`` subsamples the
stride-1 frames, ``record_channels`` selects and validates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_flight_batch as jax_flight_batch
from erpl_monte_carlo_sim_tpu_torch.engine import (SimConfig, simulate_flight_batch,
                                                   simulate_summary_batch)
from erpl_monte_carlo_sim_tpu_torch.engine.component import DERIVED_KEYS, record_names
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import FULL_FLIGHTS
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, scene_from_numpy,
                                                         to_numpy, trajectory_from_numpy)
from test_torch_descent import low_apogee_batch
from test_torch_flight import compare, jax_batch

torch.set_num_threads(1)

WINDOW = dict(max_time=2.0, record_stride=2)
# the tiered set to landing, a frame every 4 steps
TIERED = dict(FULL_FLIGHTS, record_stride=4)
LEAVES = ("time", "position", "velocity", "quaternion", "angular_velocity",
          "propellant_fraction")


def fly_both(scene_b, ic_b, fields):
    """``(JAX summary, JAX trajectory, port summary, port trajectory)``, as
    NumPy, on the same lanes."""
    ref_s, ref_t = jax_flight_batch(scene_b, ic_b, JaxConfig(**fields))
    got_s, got_t = simulate_flight_batch(scene_from_numpy(scene_b, "cpu"),
                                         ic_from_numpy(ic_b, "cpu"), SimConfig(**fields))
    return (jax.tree.map(np.asarray, ref_s), jax.device_get(ref_t), to_numpy(got_s),
            to_numpy(got_t))


def compare_trajectories(ref, got):
    """tests/test_trajectory_batch.py's bars."""
    for k in LEAVES:
        a, b = np.asarray(getattr(ref, k)), getattr(got, k)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=5e-7, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got.valid, np.asarray(ref.valid))
    assert set(got.derived) == set(ref.derived)
    for k, a in ref.derived.items():
        a = np.asarray(a)
        assert a.shape == got.derived[k].shape, k
        np.testing.assert_allclose(got.derived[k], a, rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def window():
    scene_b, ic_b = jax_batch("liquid", jnp.float64, n=4, key=7)
    return (scene_b, ic_b) + fly_both(scene_b, ic_b, WINDOW)


def test_flight_batch_matches_jax_window(window):
    _, _, ref_s, ref_t, got_s, got_t = window
    compare(ref_s, got_s, 5e-7)
    compare_trajectories(ref_t, got_t)
    assert got_t.time.shape == (4, 201)
    assert (got_t.valid.sum(1) > 100).all() and not got_t.valid.all()
    assert got_t.derived["euler_angles"].shape == (4, 201, 3)


def test_flight_batch_matches_jax_tiered_to_landing():
    """The low-apogee scenes (tests/test_descent.py) to landing under
    scripts/full_flights.py's set: coarse quiet coast, fine steps through
    the chute latch, coarse canopy descent, each lane's own time."""
    ref_s, ref_t, got_s, got_t = fly_both(*low_apogee_batch(jnp.float64), TIERED)
    compare(ref_s, got_s, 5e-7)
    compare_trajectories(ref_t, got_t)
    assert got_s.parachute_deployed.all() and (got_s.landing_position[:, 2] <= 0.5).all()
    steps = np.diff(np.where(got_t.valid, got_t.time, np.nan), axis=1)
    assert np.nanmax(steps) / np.nanmin(steps[steps > 0]) > 8  # coarse and fine frames


def test_recorded_summary_is_the_summary_batch(window):
    """The recorder runs the summary path's masked steps: its summary is
    ``simulate_summary_batch``'s, bit for bit."""
    scene_b, ic_b, _, _, got_s, _ = window
    want = to_numpy(simulate_summary_batch(scene_from_numpy(scene_b, "cpu"),
                                           ic_from_numpy(ic_b, "cpu"), SimConfig(**WINDOW)))
    for (a, b) in zip(jax.tree.leaves(dataclasses.asdict(want)),
                      jax.tree.leaves(dataclasses.asdict(got_s))):
        np.testing.assert_array_equal(b, a)


def test_time_rounding_against_jax(window):
    """ROADMAP F9: the parity loop's frame time is ``rail_time + step *
    dt`` less ``rail_time``. The port rounds the sum per operation in
    float64 (as its summary path and the kernel do); XLA:CPU fuses it in the
    JAX recorder. The two differ in the last bit only, and each is its own
    rounding of the same exact sum."""
    _, _, ref_s, ref_t, _, got_t = window
    rail = ref_s.rail.rail_exit_time[:, None]
    step = 2.0 * np.arange(got_t.time.shape[1])[None, :]
    valid = got_t.valid & (step <= ref_s.n_steps[:, None])  # not a terminal frame
    np.testing.assert_array_equal(got_t.time[valid], ((rail + step * 0.005) - rail)[valid])
    diff = np.abs(got_t.time - np.asarray(ref_t.time))[valid]
    assert diff.max() <= 2 * np.spacing(np.abs(got_t.time[valid])).max()


def test_record_stride_subsamples(window):
    """Stride-3 frames are the stride-1 frames at steps 0, 3, 6, ..., and
    a lane that stops inside a block records its terminal state there."""
    scene_b, ic_b = window[:2]
    args = scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu")
    base = dict(max_time=1.0, record_derived=False)
    s1, t1 = simulate_flight_batch(*args, SimConfig(**base))
    s3, t3 = simulate_flight_batch(*args, SimConfig(**base, record_stride=3))
    assert torch.equal(s1.n_steps, s3.n_steps) and not t3.derived
    n3 = t3.time.shape[1]
    assert n3 == -(-SimConfig(max_time=1.0).max_steps // 3) + 1
    for lane in range(4):
        steps = int(s1.n_steps[lane])
        idx = np.minimum(3 * np.arange(n3), steps)  # frozen after the stop
        for k in ("time", "position", "velocity", "quaternion"):
            assert torch.equal(getattr(t3, k)[lane], getattr(t1, k)[lane, idx]), (k, lane)
        assert int(t3.valid[lane].sum()) == -(-steps // 3) + 1
    assert (s1.n_steps % 3 != 0).any()  # a lane stopped inside a block


def test_record_channels_select_and_validate(window):
    """Any Euler name selects all three angles (stacked as
    ``euler_angles``); the selected channels are the full recording's; an
    unknown name raises; ``record_derived=False`` records none."""
    scene_b, ic_b = window[:2]
    args = scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu")
    full = trajectory_from_numpy(window[5], "cpu")
    cfg = SimConfig(**WINDOW, record_channels=("euler_pitch", "mach"))
    assert record_names(cfg) == ("euler_roll", "euler_pitch", "euler_yaw", "mach")
    _, t = simulate_flight_batch(*args, cfg)
    assert set(t.derived) == {"euler_angles", "mach"}
    for k in t.derived:
        assert torch.equal(t.derived[k], full.derived[k]), k
    assert torch.equal(t.position, full.position)
    assert record_names(SimConfig(record_derived=False)) == ()
    assert record_names(SimConfig()) == DERIVED_KEYS
    assert record_names(SimConfig(record_channels=("euler_angles",))) == DERIVED_KEYS[5:8]
    with pytest.raises(ValueError, match="no derived channel named"):
        simulate_flight_batch(*args, SimConfig(max_time=0.5, record_channels=("Mach",)))
