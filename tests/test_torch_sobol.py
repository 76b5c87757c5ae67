"""PyTorch port, ``ops.sobol`` against the JAX package's ``ops/sobol.py``:
the scrambled Sobol integers bit for bit for the same seeds (several
``(n, d, scrambles)``, d = 640 and n not a power of two among them), the
hash on edge words, the unit conversion bit for bit and strictly inside
(0, 1) in float32, normals within 4 ulp, and the properties
tests/test_sobol_ops.py pins (net strata, bijective scramble, replicates)
on seeds drawn under a threefry key, which are JAX's seeds for that key."""

import filecmp
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.ops import sobol as J
from erpl_monte_carlo_sim_tpu_torch.ops import prng
from erpl_monte_carlo_sim_tpu_torch.ops import sobol as T

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_seeds(key, scrambles, d):
    """The seeds ``J.sobol_uniform(key, ...)`` scrambles with, as the port's
    int64 words."""
    return np.asarray(jax.random.bits(key, (scrambles, d), "uint32")).astype(np.int64)


def ulps(a, b):
    """How many float ulps of the larger magnitude ``a`` and ``b`` differ by."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(a.dtype))


@pytest.mark.parametrize("n,d,scrambles", [(1000, 43, 8), (24, 640, 3), (257, 7, 1)])
def test_points_match_jax_bit_for_bit(n, d, scrambles):
    key = jax.random.PRNGKey(n + d)
    seeds = jax_seeds(key, scrambles, d)
    v = jnp.asarray(J.direction_numbers(d))
    base = J._sobol_bits(n // scrambles, v)
    ref = jax.vmap(lambda s: J._owen_scramble(base, s))(jnp.asarray(seeds, jnp.uint32))
    got = T.sobol_points(n, d, torch.as_tensor(seeds))
    assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 1 << 32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).reshape(n, d).astype(np.int64))


def test_unscrambled_bits_match_jax_at_640_dims():
    v = J.direction_numbers(640)
    ref = np.asarray(J._sobol_bits(300, jnp.asarray(v))).astype(np.int64)
    got = T._sobol_bits(300, torch.as_tensor(T.direction_numbers(640).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hash32_edge_words_match_jax():
    words = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0x7FEB352D, 0x846CA68B,
             0x9E3779B9, 0xFFFFFFFE, 0xFFFFFFFF]
    ref = np.asarray(J._hash32(jnp.asarray(words, jnp.uint32))).astype(np.int64)
    np.testing.assert_array_equal(T._hash32(torch.tensor(words)).numpy(), ref)
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    ref = np.asarray(J._hash32(jnp.asarray(words.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(T._hash32(torch.as_tensor(words)).numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_uniform_bit_for_bit_and_normal_within_4_ulp(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    key = jax.random.PRNGKey(5)
    seeds = torch.as_tensor(jax_seeds(key, 4, 23))
    u = T.sobol_uniform(None, 512, 23, 4, dtype, seeds=seeds)
    np.testing.assert_array_equal(u.numpy(), np.asarray(J.sobol_uniform(key, 512, 23, 4,
                                                                         dtype=jdt)))
    z = T.sobol_normal(None, 512, 23, 4, dtype, seeds=seeds).numpy()
    assert ulps(z, np.asarray(J.sobol_normal(key, 512, 23, 4, dtype=jdt))).max() <= 4


def test_float32_unit_strictly_inside_01():
    words = [0, 1, (1 << 23) - 1, 1 << 23, 0xFFFFFE00, 0xFFFFFFFF]
    u = T._to_unit(torch.tensor(words), torch.float32)
    ref = np.asarray(J._to_unit(jnp.asarray(words, jnp.uint32), jnp.float32))
    np.testing.assert_array_equal(u.numpy(), ref)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.isfinite(torch.special.ndtri(u)).all()


def test_scramble_preserves_net_strata():
    """1024 scrambled points of dimensions (0, 1) still land one per 32 x 32
    stratum."""
    u = T.sobol_uniform(prng.prng_key(9), 1024, 2, dtype=torch.float64).numpy()
    h, _, _ = np.histogram2d(u[:, 0], u[:, 1], bins=32, range=[[0, 1], [0, 1]])
    assert (h == 1).all()


def test_scramble_is_bijective_per_seed():
    x = (torch.arange(1 << 16, dtype=torch.int64) * 65521) & 0xFFFFFFFF
    y = T._owen_scramble(x[:, None], torch.tensor([0xDEADBEEF]))[:, 0]
    assert torch.unique(y).numel() == y.numel()


def test_generator_seeds_replicates_and_marginals():
    """The key's seeds are ``jax.random.bits``'; the same key, the JAX
    package's points."""
    key = prng.prng_key(1)
    np.testing.assert_array_equal(T.draw_seeds(key, 4, 3).numpy(),
                                  jax_seeds(jax.random.PRNGKey(1), 4, 3))
    u = T.sobol_uniform(key, 1024, 3, 4, torch.float64).numpy()
    np.testing.assert_array_equal(u, np.asarray(J.sobol_uniform(
        jax.random.PRNGKey(1), 1024, 3, 4, dtype=jnp.float64)))
    blocks = u.reshape(4, 256, 3)
    for i in range(1, 4):
        assert not np.allclose(blocks[0], blocks[i])
        assert np.abs(blocks[i].mean(axis=0) - 0.5).max() < 4e-3
    with pytest.raises(ValueError, match="multiple"):
        T.sobol_uniform(key, 10, 3, 4)


def test_direction_table_is_the_jax_packages():
    assert filecmp.cmp(ROOT / "erpl_monte_carlo_sim_tpu_torch" / "data" / "sobol_directions.npz",
                       ROOT / "erpl_monte_carlo_sim_tpu" / "data" / "sobol_directions.npz",
                       shallow=False)
    assert T.max_dims() == J.max_dims() == 640
    with pytest.raises(ValueError, match="baked table"):
        T.direction_numbers(T.max_dims() + 1)
