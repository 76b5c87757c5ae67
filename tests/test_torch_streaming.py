"""PyTorch port, the host statistics of slabbed runs against the JAX
package's on the same NumPy arrays, with ``==``: ``StreamingStats`` across
its exact -> sketch crossing (percentiles, ``cdf``, ``percentile_ci``,
``sketch_warnings``, the stats block), ``TailReservoir``,
``FootprintAccumulator``, ``exceedance`` and the checkpoint's stream
packing."""

import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.mc import slab_checkpoint as jckpt
from erpl_monte_carlo_sim_tpu.mc import stats as jstats
from erpl_monte_carlo_sim_tpu.mc import tail as jtail
from erpl_monte_carlo_sim_tpu_torch.mc import slab_checkpoint as tckpt
from erpl_monte_carlo_sim_tpu_torch.mc import stats as tstats
from erpl_monte_carlo_sim_tpu_torch.mc import tail as ttail


def batches(case: str, seed: int = 0) -> list:
    """Slab-sized batches of one metric: unimodal, bimodal (a density gap),
    with NaN/inf lanes, or taking two values (ties, as ``flight_time`` in a
    window)."""
    rng = np.random.default_rng(seed)
    sizes = [300, 257, 0, 411, 390, 128]
    out = []
    for n in sizes:
        if case == "bimodal":  # half and half: the median sits in the gap
            v = rng.permutation(np.concatenate([rng.normal(100.0, 2.0, n // 2),
                                                rng.normal(400.0, 5.0, n - n // 2)]))
        elif case == "ties":
            v = np.where(rng.uniform(size=n) < 0.8, 6.0, 5.995)
        else:
            v = rng.normal(5000.0, 40.0, n)
        if case == "nonfinite" and n:
            v[::17] = np.nan
            v[5] = np.inf
        out.append(v)
    return out


def fold(stats_mod, parts, **kw):
    s = stats_mod.StreamingStats(**kw)
    for p in parts:
        s.add(p)
    return s


CASES = ["unimodal", "bimodal", "nonfinite", "ties"]
QS = [0.1, 5.0, 50.0, 95.0, 99.9]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("threshold", [10_000, 700], ids=["exact", "crossing"])
def test_streaming_stats_matches_jax(case, threshold):
    """Folded batch by batch with 64 centroids: exact throughout, or
    crossing to the sketch at the third non-empty batch."""
    parts = batches(case)
    got = fold(tstats, parts, max_centroids=64, exact_threshold=threshold)
    ref = fold(jstats, parts, max_centroids=64, exact_threshold=threshold)
    assert got.is_exact == ref.is_exact == (threshold == 10_000)
    assert got.n == ref.n
    assert got.percentiles(QS) == ref.percentiles(QS)
    xs = np.concatenate([np.percentile(np.concatenate(parts)[np.isfinite(
        np.concatenate(parts))], [0, 1, 50, 99, 100]), [-1e9, 1e9]])
    np.testing.assert_array_equal(got.cdf(xs), ref.cdf(xs))
    assert got.percentile_ci(QS) == ref.percentile_ci(QS)
    assert got.sketch_warnings() == ref.sketch_warnings()
    np.testing.assert_equal(got.stats(), ref.stats())
    if not got.is_exact:
        np.testing.assert_array_equal(got._cent_v, ref._cent_v)
        np.testing.assert_array_equal(got._cent_w, ref._cent_w)


def test_sketch_warning_is_logged_once(caplog):
    got = fold(tstats, batches("bimodal"), max_centroids=64, exact_threshold=700)
    ref = fold(jstats, batches("bimodal"), max_centroids=64, exact_threshold=700)
    with caplog.at_level("WARNING", logger="erpl_monte_carlo_sim_tpu_torch.mc.stats"):
        assert got.stats()["sketch_warning"] == ref.stats()["sketch_warning"]
        got.stats()
    mine = [r for r in caplog.records if r.name == "erpl_monte_carlo_sim_tpu_torch.mc.stats"]
    assert len(mine) == 1 and "quantile sketch" in mine[0].getMessage()


def test_empty_stream_matches_jax():
    got, ref = tstats.StreamingStats(), jstats.StreamingStats()
    got.add(np.array([np.nan]))
    ref.add(np.array([np.nan]))
    np.testing.assert_equal(got.stats(), ref.stats())
    np.testing.assert_equal(got.cdf([1.0]), ref.cdf([1.0]))
    np.testing.assert_equal(got.percentile_ci(), ref.percentile_ci())


@pytest.mark.parametrize("case", ["unimodal", "nonfinite"])
@pytest.mark.parametrize("k", [1, 64, 4096])
def test_tail_reservoir_matches_jax(case, k):
    got, ref = ttail.TailReservoir(k), jtail.TailReservoir(k)
    for p in batches(case):
        got.add(p)
        ref.add(p)
    assert got.n == ref.n
    np.testing.assert_array_equal(got.hi, ref.hi)
    np.testing.assert_array_equal(got.lo, ref.lo)
    other_t, other_j = ttail.TailReservoir(k), jtail.TailReservoir(k)
    other_t.add(batches(case, seed=1)[0])
    other_j.add(batches(case, seed=1)[0])
    got.merge(other_t)
    ref.merge(other_j)
    np.testing.assert_array_equal(got.hi, ref.hi)
    np.testing.assert_array_equal(got.lo, ref.lo)
    packed_t, packed_j = {}, {}
    got.to_arrays(packed_t, "t.")
    ref.to_arrays(packed_j, "t.")
    assert packed_t.keys() == packed_j.keys()
    back = ttail.TailReservoir.from_arrays(packed_j, "t.")
    assert (back.n, back.k) == (ref.n, ref.k)
    np.testing.assert_array_equal(back.hi, ref.hi)


def test_footprint_accumulator_matches_jax():
    rng = np.random.default_rng(4)
    got, ref = tstats.FootprintAccumulator(), jstats.FootprintAccumulator()
    assert got.footprint().keys() == ref.footprint().keys()
    for n in (40, 0, 1, 257):
        x = rng.normal(3000.0, 60.0, n)
        y = 0.4 * x + rng.normal(0.0, 25.0, n)
        mx, my = (x.mean(), y.mean()) if n else (0.0, 0.0)
        moments = (n, mx, my, ((x - mx) ** 2).sum(), ((y - my) ** 2).sum(),
                   ((x - mx) * (y - my)).sum())
        got.add(*moments)
        ref.add(*moments)
    np.testing.assert_equal(got.footprint(), ref.footprint())


@pytest.mark.parametrize("n_valid", [0, 1, 300])
def test_exceedance_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    vals = np.round(rng.normal(0.0, 1.0, 400), 1)
    vals[7] = np.nan
    mask = np.zeros(400, bool)
    mask[:n_valid] = True
    ts = [-5.0, -0.5, 0.0, 0.3, 5.0]
    np.testing.assert_equal(tstats.exceedance(vals, mask, ts),
                            jstats.exceedance(vals, mask, ts))
    for k in {0, n_valid // 3, n_valid}:
        np.testing.assert_equal(tstats._wilson(k, n_valid), jstats._wilson(k, n_valid))


@pytest.mark.parametrize("split", [3, 5], ids=["before_crossing", "after_crossing"])
def test_stream_pack_roundtrips_between_packages(split):
    """A stream packed by either package, before or after its crossing to
    the sketch, unpacks in the other and goes on to the whole run's state
    bit for bit: the part boundaries of the exact buffer survive, so a
    crossing after the resume compresses as the whole run's did."""
    threshold = 700
    parts = batches("unimodal")
    live_t = fold(tstats, parts[:split], max_centroids=64, exact_threshold=threshold)
    live_j = fold(jstats, parts[:split], max_centroids=64, exact_threshold=threshold)
    assert live_t.is_exact == (split == 3)
    packed_t, packed_j = {}, {}
    tckpt._pack_stream(live_t, packed_t, "s.")
    jckpt._pack_stream(live_j, packed_j, "s.")
    assert packed_t.keys() == packed_j.keys()
    for k in packed_t:
        np.testing.assert_array_equal(packed_t[k], packed_j[k])
    from_j = tckpt._unpack_stream(packed_j, "s.", threshold)
    from_t = jckpt._unpack_stream(packed_t, "s.", threshold)
    whole = fold(jstats, parts, max_centroids=64, exact_threshold=threshold)
    for s in (from_j, from_t):
        s.max_centroids = 64
        for p in parts[split:]:
            s.add(p)
        assert s.percentiles(QS) == whole.percentiles(QS)
        np.testing.assert_equal(s.stats(), whole.stats())
