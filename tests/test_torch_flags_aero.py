"""PyTorch port, the aerodynamic and guard opt-ins
(``energy_consistent_aero``, ``stall_limited_moments``, ``speed_guard``),
each alone: the port's ``simulate_summary_batch`` against the JAX package's
on the same dispersed window, at the bars of tests/test_torch_flight.py
(tests/test_torch_flags.py holds the check and the other opt-ins)."""

import pytest

from test_torch_flags import DTYPES, GROUPS, check_opt_in


@DTYPES
@pytest.mark.parametrize("flag", GROUPS["test_torch_flags_aero.py"])
def test_opt_in_matches_jax(flag, dtype):
    check_opt_in(flag, dtype)
