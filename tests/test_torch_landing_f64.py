"""PyTorch port, the tiered flag sets to landing in float64 on the low-apogee
scenes of tests/test_descent.py: the port's flights against the JAX
package's, and the emulated kernel's against the port's plain version. The
two checks share the plain version's flights (tests/test_torch_descent.py
``plain_to_landing``); tests/test_torch_landing_f32.py holds float32."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_descent import (check_emulated_tiered_set_to_landing,
                                check_full_flights_set_to_landing, landing_builds)
from test_torch_kernel_emulated import build_emulated

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated(tmp_path_factory, landing_builds())


@pytest.mark.parametrize("dtype", [jnp.float64], ids=["f64"])
@pytest.mark.parametrize("integrator", ["rk4", "rk2"])
def test_full_flights_set_to_landing_matches_jax(integrator, dtype):
    check_full_flights_set_to_landing(integrator, dtype)


@pytest.mark.parametrize("dtype", [torch.float64], ids=["f64"])
@pytest.mark.parametrize("name", ["full_flights", "full_flights+rk2"])
def test_emulated_tiered_sets_to_landing(emulated, name, dtype):
    check_emulated_tiered_set_to_landing(emulated, name, dtype)
