"""PyTorch port, flight-envelope statistics (``mc/envelope.py``,
``engine.batch.simulate_envelope_batch``, ``MonteCarloAnalyzer.flight_envelope``)
against the JAX package's.

The device reductions (``_bin_moments_mc``, ``_bin_histogram_mc``,
``_bin_histogram``) on the same arrays, and ``EnvelopeAccumulator`` on the
same trajectories (the JAX recorder's, converted), fed in two chunks: counts,
histograms and clipped counts exact, min and max exact, means at rtol 1e-9,
standard deviations at rtol 1e-6. The in-loop envelope against JAX's with
the same edges, on a tiered window (each lane carries its own time, whose
bits both packages share; ROADMAP F9 is why not a parity window). The
port's in-loop path against its frame path at the bars of JAX
tests/test_envelope.py::test_inline_envelope_matches_frame_path. All
float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_flight_batch as jax_flight_batch
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_envelope_batch as jax_envelope_batch
from erpl_monte_carlo_sim_tpu.mc import EnvelopeAccumulator as JaxAccumulator
from erpl_monte_carlo_sim_tpu.mc import EnvelopeConfig as JaxEnvConfig
from erpl_monte_carlo_sim_tpu.mc import envelope as jax_envelope
from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_envelope_batch)
from erpl_monte_carlo_sim_tpu_torch.mc import (EnvelopeAccumulator, EnvelopeConfig,
                                               MonteCarloAnalyzer)
from erpl_monte_carlo_sim_tpu_torch.mc import envelope as port_envelope
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, scene_from_numpy,
                                                         trajectory_from_numpy)
from test_torch_flight import jax_batch

torch.set_num_threads(1)

WINDOW = dict(max_time=2.0, record_stride=2)
ENV = dict(bin_dt=0.25, n_buckets=32, record_stride=2)
# a tiered window: fine steps only, each lane's time carried as t + dt
TIERED_WINDOW = dict(WINDOW, descent_dt_scale=16)


def same_block(a, b):
    """Two envelope result blocks' channels: counts exact, min/max
    exact, mean rtol 1e-9, std rtol 1e-6, percentiles rtol 1e-9."""
    assert a["channels"].keys() == b["channels"].keys()
    assert a["n_lanes"] == b["n_lanes"] and a["time"] == b["time"]
    for ch, x in a["channels"].items():
        y = b["channels"][ch]
        assert x["n"] == y["n"], ch
        np.testing.assert_array_equal(y["min"], x["min"], err_msg=ch)
        np.testing.assert_array_equal(y["max"], x["max"], err_msg=ch)
        np.testing.assert_allclose(y["mean"], x["mean"], rtol=1e-9, atol=1e-12,
                                   equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(y["std"], x["std"], rtol=1e-6, atol=1e-9, equal_nan=True,
                                   err_msg=ch)
        assert y["clipped_frac"] == x["clipped_frac"], ch
        for q, band in x["percentiles"].items():
            np.testing.assert_allclose(y["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=f"{ch} p{q}")


def random_frames(seed=7, C=2, B=13, T=50):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.01, 0.08, (B, T)), axis=1)
    valid = rng.uniform(size=(B, T)) < 0.9
    value = rng.normal(100.0, 5.0, (B, T))
    value[0, 3] = np.nan
    return t, valid, np.stack([value + 7.0 * c for c in range(C)])


def test_bin_reductions_match_jax():
    t, valid, values = random_frames()
    n_bins, bin_dt, n_buckets = 6, 0.4, 16
    ref = [np.asarray(x) for x in jax_envelope._bin_moments_mc(
        jnp.asarray(t), jnp.asarray(valid), jnp.asarray(values), bin_dt, n_bins)]
    got = [x.numpy() for x in port_envelope._bin_moments_mc(
        torch.as_tensor(t), torch.as_tensor(valid), torch.as_tensor(values), bin_dt, n_bins)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])

    # edges a little narrower than the data: some samples clip
    lo = (np.nanmin(values, axis=(1, 2)) + 1.0)[:, None].repeat(n_bins, 1)
    width = ((np.nanmax(values, axis=(1, 2)) - 2.0)[:, None] - lo) / n_buckets
    lo32, w32 = np.float32(lo), np.float32(width)
    for stride in (1, 3):
        h_ref, c_ref = jax_envelope._bin_histogram_mc(
            jnp.asarray(t), jnp.asarray(valid), jnp.asarray(values), bin_dt,
            jnp.asarray(lo32), jnp.asarray(w32), n_bins, n_buckets, frame_stride=stride)
        h, c = port_envelope._bin_histogram_mc(
            torch.as_tensor(t), torch.as_tensor(valid), torch.as_tensor(values), bin_dt,
            torch.as_tensor(lo32), torch.as_tensor(w32), n_bins, n_buckets,
            frame_stride=stride)
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
        assert c.sum() > 0 and h.sum() > 0
    h_ref, c_ref = jax_envelope._bin_histogram(
        jnp.asarray(t), jnp.asarray(valid), jnp.asarray(values[0]), bin_dt,
        jnp.asarray(lo32[0]), jnp.asarray(w32[0]), n_bins, n_buckets)
    h, c = port_envelope._bin_histogram(
        torch.as_tensor(t), torch.as_tensor(valid), torch.as_tensor(values[0]), bin_dt,
        torch.as_tensor(lo32[0]), torch.as_tensor(w32[0]), n_bins, n_buckets)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.fixture(scope="module")
def jax_trajectories():
    scene_b, ic_b = jax_batch("liquid", jnp.float64, n=6, key=3)
    _, traj = jax_flight_batch(scene_b, ic_b, JaxConfig(**WINDOW))
    return scene_b, ic_b, jax.device_get(traj)


def halves(traj, convert):
    """The trajectory's lanes in two chunks."""
    return [convert(jax.tree.map(lambda x, s=s: x[s], traj))
            for s in (slice(0, 3), slice(3, 6))]


def test_accumulator_matches_jax(jax_trajectories):
    _, _, traj = jax_trajectories
    env = dict(ENV, hist_frame_stride=2)
    ref = JaxAccumulator(JaxConfig(**WINDOW), JaxEnvConfig(**env))
    got = EnvelopeAccumulator(SimConfig(**WINDOW), EnvelopeConfig(**env))
    for a, b in zip(halves(traj, lambda x: x),
                    halves(traj, lambda x: trajectory_from_numpy(x, "cpu"))):
        ref.add(a)
        got.add(b)
    for ch in got.env.channels:
        np.testing.assert_array_equal(got._hist[ch], ref._hist[ch], err_msg=ch)
        assert got._clipped[ch] == ref._clipped[ch]
    np.testing.assert_array_equal(got._edges[0].numpy(), np.asarray(ref._edges[0]))
    np.testing.assert_array_equal(got._edges[1].numpy(), np.asarray(ref._edges[1]))
    same_block(ref.result(), got.result())
    assert sum(got.result()["channels"]["altitude"]["n"]) > 600


def test_unrecorded_channel_and_uncalibrated_aggregates_raise(jax_trajectories):
    _, _, traj = jax_trajectories
    part = trajectory_from_numpy(jax.tree.map(lambda x: x[:2], traj), "cpu")
    part = dataclasses.replace(part, derived={"mach": part.derived["mach"]})
    acc = EnvelopeAccumulator(SimConfig(**WINDOW), EnvelopeConfig(**ENV))
    with pytest.raises(KeyError, match="'angle_of_attack' is not recorded"):
        acc.add(part)
    assert port_envelope.trajectory_channel(part, "speed").shape == part.time.shape
    with pytest.raises(RuntimeError, match="not calibrated"):
        acc.add_aggregates({}, 2)


def test_in_loop_envelope_matches_jax(jax_trajectories):
    """``simulate_envelope_batch`` against JAX's with the same calibrated
    edges, the histogram fed every second record step."""
    scene_b, ic_b, traj = jax_trajectories
    acc = JaxAccumulator(JaxConfig(**WINDOW), JaxEnvConfig(**ENV))
    acc.add(traj)
    lo, width = acc._edges
    kw = dict(channels=acc.env.channels, n_bins=acc.n_bins, n_buckets=ENV["n_buckets"],
              bin_dt=ENV["bin_dt"], hist_every=2)
    _, ref = jax_envelope_batch(scene_b, ic_b, JaxConfig(**TIERED_WINDOW), lo=lo, width=width,
                                **kw)
    _, got = simulate_envelope_batch(scene_from_numpy(scene_b, "cpu"),
                                     ic_from_numpy(ic_b, "cpu"), SimConfig(**TIERED_WINDOW),
                                     lo=torch.tensor(np.asarray(lo)),
                                     width=torch.tensor(np.asarray(width)), **kw)
    ref = jax.device_get(ref)
    for k in ("n", "hist", "clipped"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["mean"].numpy(), ref["mean"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["m2"].numpy(), ref["m2"], rtol=1e-6, atol=1e-9)
    # two flights of the same lanes: their values share all but the last bits
    np.testing.assert_allclose(got["min"].numpy(), ref["min"], rtol=1e-12)
    np.testing.assert_allclose(got["max"].numpy(), ref["max"], rtol=1e-12)
    assert got["hist"].dtype == torch.float32 and float(got["n"].sum()) > 600


@pytest.fixture(scope="module")
def port_run():
    mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=2.0))
    analysis = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=48,
                                  seed=11)
    return mc, analysis


def test_inline_envelope_matches_frame_path(port_run):
    """The port's in-loop envelope against its frame path on the same lanes,
    at JAX test_inline_envelope_matches_frame_path's bars: chunk 1 of 16
    calibrates frame-based, chunks 2-3 reduce in the loop."""
    mc, analysis = port_run
    env = EnvelopeConfig(bin_dt=0.25, record_stride=2)
    inl = mc.flight_envelope(n_lanes=48, chunk=16, env_config=env, analysis=analysis,
                             inline=True)
    frm = mc.flight_envelope(n_lanes=48, chunk=16, env_config=env, analysis=analysis)
    assert inl["n_lanes"] == frm["n_lanes"] > 16
    for ch in env.channels:
        a, b = frm["channels"][ch], inl["channels"][ch]
        assert a["n"] == b["n"], ch
        np.testing.assert_allclose(b["min"], a["min"], rtol=1e-12, equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["max"], a["max"], rtol=1e-12, equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["mean"], a["mean"], rtol=1e-9, atol=1e-12,
                                   equal_nan=True, err_msg=ch)
        np.testing.assert_allclose(b["std"], a["std"], rtol=1e-6, atol=1e-9, equal_nan=True,
                                   err_msg=ch)
        assert b["clipped_frac"] == pytest.approx(a["clipped_frac"], abs=1e-12)
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=f"{ch} p{q}")


def test_inline_envelope_hist_stride(port_run):
    """``hist_frame_stride`` in the loop feeds the record steps the frame
    path's ``[::stride]`` slicing feeds."""
    mc, analysis = port_run
    env = EnvelopeConfig(bin_dt=0.25, record_stride=2, hist_frame_stride=3)
    inl = mc.flight_envelope(n_lanes=32, chunk=16, env_config=env, analysis=analysis,
                             inline=True)
    frm = mc.flight_envelope(n_lanes=32, chunk=16, env_config=env, analysis=analysis)
    for ch in env.channels:
        a, b = frm["channels"][ch], inl["channels"][ch]
        assert a["n"] == b["n"], ch
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=f"{ch} p{q}")
