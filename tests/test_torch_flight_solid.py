"""PyTorch port, flight core with the solid motor (10-knot thrust curve,
mass flow following the thrust multiplier) against the JAX package's
``simulate_summary_batch``, lane for lane, at the bars of
tests/test_torch_flight.py."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_flight import BARS, compare, jax_batch, run_both

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_solid_matches_jax(dtype):
    ref, got = run_both(*jax_batch("solid", dtype))
    compare(ref, got, BARS[dtype])
    assert (ref.n_steps > 1000).all()
