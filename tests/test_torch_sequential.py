"""PyTorch port, the stopping criteria of ``run_to_precision`` against the
JAX package's: the same value streams (slab-sized batches of valid-lane
values, with non-finite ones) through both, the same ``satisfied()`` after
every batch and equal report blocks; the spec parser's results and refusals."""

import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu.mc import sequential as jseq
from erpl_monte_carlo_sim_tpu_torch.mc import sequential as tseq

SPECS = {
    "mean_stderr": {"metric": "apogee_altitude", "mean_stderr": 2.0},
    "qmc_mean_stderr": {"metric": "range", "qmc_mean_stderr": 1.5},
    "exceed_go": {"metric": "apogee_altitude", "exceed": 5150.0, "p_limit": 0.05},
    "exceed_no_go": {"metric": "apogee_altitude", "exceed": 4950.0, "p_limit": 0.3},
    "exceed_halfwidth": {"metric": "max_speed", "exceed": 5000.0, "ci_halfwidth": 0.04},
    "quantile_halfwidth": {"metric": "flight_time", "percentile": 90.0, "ci_halfwidth": 6.0},
    "deep_quantile": {"metric": "range", "percentile": 99.9, "ci_halfwidth": 50.0},
}


def stream(seed=0):
    """Slab-sized batches, one empty, some with NaN and inf."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (40, 0, 130, 257, 300, 512, 700):
        v = rng.normal(5000.0, 60.0, n)
        if n > 100:
            v[::50] = np.nan
            v[3] = np.inf
        out.append(v)
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_criterion_matches_jax(name):
    got = tseq.parse_criterion(dict(SPECS[name]))
    ref = jseq.parse_criterion(dict(SPECS[name]))
    assert type(got).__name__ == type(ref).__name__
    seen_t, seen_j = [], []
    for batch in stream():
        got.update(batch)
        ref.update(batch)
        seen_t.append(got.satisfied())
        seen_j.append(ref.satisfied())
        np.testing.assert_equal(got.block(), ref.block())
    assert seen_t == seen_j
    assert any(seen_t) or name == "deep_quantile"  # every stream decides but the deep tail


@pytest.mark.parametrize("spec", [
    {"metric": "altitude", "mean_stderr": 1.0},
    {"metric": "range", "mean_stderr": 0.0},
    {"metric": "range", "exceed": 1.0, "p_limit": 1.0},
    {"metric": "range", "percentile": 100.0, "ci_halfwidth": 1.0},
    {"metric": "range", "exceed": 1.0},
    {"metric": "range", "qmc_mean_stderr": 1.0, "min_replicates": 1},
    ["metric", "range"],
], ids=["metric", "target", "p_limit", "percentile", "keys", "extra_key", "type"])
def test_parse_criterion_refuses_as_jax(spec):
    with pytest.raises((ValueError, TypeError)) as ref:
        jseq.parse_criterion(spec)
    with pytest.raises(ref.type) as got:
        tseq.parse_criterion(spec)
    assert str(got.value) == str(ref.value)
