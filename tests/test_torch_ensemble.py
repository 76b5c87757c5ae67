"""PyTorch port, ``mc.ensemble`` against the JAX package's: the per-member
moments merged over slabs (counts exact, moments at rtol 1e-12), the
post-stratified mixture, ``member_exceedance`` and its refusals, and the
analyzer's gate on the ensemble's shape."""

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.mc import ensemble as J
from erpl_monte_carlo_sim_tpu_torch.mc import ensemble as T

METRICS = ("apogee_altitude", "range", "flight_time")


def slabs(k, sizes, seed):
    """Per-slab (members, valid, metrics), member means apart, with NaN and
    invalid lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        members = rng.integers(0, k, n)
        valid = rng.random(n) > 0.2
        metrics = {m: 1000.0 * (i + 1) + 50.0 * members + rng.normal(size=n)
                   for i, m in enumerate(METRICS)}
        metrics["range"][rng.random(n) < 0.05] = np.nan
        out.append((members, valid, metrics))
    return out


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-12, atol=0.0, err_msg=what)


def same_block(got, ref):
    assert got["n_members"] == ref["n_members"]
    for row, rrow in zip(got["members"], ref["members"]):
        for key in ("member", "n_drawn", "n_valid"):
            assert row[key] == rrow[key], key
        for m in METRICS:
            assert row[m]["n"] == rrow[m]["n"]
            close([row[m]["mean"], row[m]["std"]], [rrow[m]["mean"], rrow[m]["std"]], m)
    for m in METRICS:
        close([got["post_stratified"][m]["mean"], got["post_stratified"][m]["stderr"]],
              [ref["post_stratified"][m]["mean"], ref["post_stratified"][m]["stderr"]], m)


@pytest.mark.parametrize("k,sizes", [(2, [64]), (3, [40, 40, 7]), (5, [200, 3, 100])])
def test_accumulator_matches_jax(k, sizes):
    got, ref = T.EnsembleAccumulator(k), J.EnsembleAccumulator(k)
    for members, valid, metrics in slabs(k, sizes, seed=k):
        got.add(members, valid, metrics)
        ref.add(members, valid, metrics)
    same_block(got.block(), ref.block())


def test_a_member_without_lanes_leaves_the_mixture_undefined():
    acc = T.EnsembleAccumulator(3)
    members, valid, metrics = slabs(2, [30], seed=1)[0]
    acc.add(members, valid, metrics)
    block = acc.block()
    assert block["members"][2]["n_drawn"] == 0
    assert np.isnan(block["post_stratified"]["apogee_altitude"]["mean"])
    with pytest.raises(ValueError, match=">= 2 members"):
        T.EnsembleAccumulator(1)


def test_gate_on_the_base_wind():
    grid = np.linspace(0.0, 1.0, 4)
    assert T.EnsembleAccumulator.from_base_wind(None) is None
    assert T.EnsembleAccumulator.from_base_wind((grid, np.zeros((4, 3)))) is None
    assert T.EnsembleAccumulator.from_base_wind((grid, np.zeros((1, 4, 3)))) is None
    acc = T.EnsembleAccumulator.from_base_wind((torch.as_tensor(grid), torch.zeros(3, 4, 3)))
    assert acc.k == 3


def test_member_exceedance_matches_jax():
    k = 3
    members, valid, metrics = slabs(k, [300], seed=4)[0]
    acc = T.EnsembleAccumulator(k)
    acc.add(members, valid, metrics)
    analysis = {"wind_members": members, "ensemble": acc.block(), "metrics": metrics,
                "valid_mask": valid, "metrics_is_sample": False}
    for t in (2040.0, 2100.0, 5000.0):
        got = T.member_exceedance(analysis, "range", t)
        ref = J.member_exceedance(analysis, "range", t)
        assert got[0]["threshold"] == ref[0]["threshold"]
        for row, rrow in zip(got[0]["members"], ref[0]["members"]):
            assert (row["n"], row["n_exceed"]) == (rrow["n"], rrow["n_exceed"])
            close([row["probability"], *row["ci95"]], [rrow["probability"], *rrow["ci95"]],
                  "member")
        close([got[0]["post_stratified"]["probability"], got[0]["post_stratified"]["stderr"]],
              [ref[0]["post_stratified"]["probability"], ref[0]["post_stratified"]["stderr"]],
              "post")
    for bad, match in (({"importance": {"shift": {}}}, "importance-sampled"),
                       ({"metrics_is_sample": True}, "streaming run"),
                       ({"wind_members": None}, "no per-lane ensemble")):
        with pytest.raises(ValueError, match=match):
            T.member_exceedance({**analysis, **bad}, "range", 2100.0)
