"""PyTorch port, the non-finite stop and the tiered timestep's opt-ins
(``terminate_nonfinite=False``, ``descent_dt_scale``,
``ascent_q_threshold``), each alone: the port's ``simulate_summary_batch``
against the JAX package's on the same dispersed window, at the bars of
tests/test_torch_flight.py (tests/test_torch_flags.py holds the check and the
other opt-ins)."""

import pytest

from test_torch_flags import DTYPES, GROUPS, check_opt_in


@DTYPES
@pytest.mark.parametrize("flag", GROUPS["test_torch_flags_tiered.py"])
def test_opt_in_matches_jax(flag, dtype):
    check_opt_in(flag, dtype)
