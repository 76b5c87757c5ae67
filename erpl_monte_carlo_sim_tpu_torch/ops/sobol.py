"""Scrambled Sobol points on the device (``erpl_monte_carlo_sim_tpu/ops/sobol.py``).

The quasi-Monte Carlo sampler of ``mc.dispersions`` draws its points here:

* direction numbers: the first 640 dimensions of Joe-Kuo
  ``new-joe-kuo-6.21201``, in ``data/sobol_directions.npz`` (the JAX
  package's table, copied);
* generation: the Gray-code direct form, ``x_i = XOR_{j in bits(gray(i))}
  v_j``, one XOR pass per live bit of the point index;
* scrambling: nested-uniform (Owen) scrambling with the digit permutations
  drawn from a hash: output bit ``b`` flips by a hash of the input's more
  significant bits and a per-(dimension, bit) key. It keeps every coordinate
  marginally uniform and the (t, m, s)-net strata;
* conversion to (0, 1) at bin centres, so that ``ndtri`` stays finite;
  normals are the inverse CDF in float64, rounded.

The integers are the JAX package's bit for bit for the same seeds. torch's
``uint32`` has no shifts or additions on every backend, so the 32-bit words
live in ``int64`` and every step keeps them below 2**32: XOR and right
shifts cannot leave that range, and a product with a 32-bit constant is
formed from its two 16-bit halves (``_mul32``), each partial below 2**49.

The per-(scramble, dimension) seeds are ``bits(key, (scrambles, d))`` under
the run's threefry key (``random``), as the JAX package draws them with
``jax.random.bits``, or are given as a ``seeds`` tensor (a seam of the
tests).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import random

__all__ = ["direction_numbers", "max_dims", "sobol_points", "sobol_uniform", "sobol_normal",
           "draw_seeds", "ndtri"]

_M32 = 0xFFFFFFFF
_TABLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                      "sobol_directions.npz")


@functools.lru_cache(maxsize=1)
def _table() -> np.ndarray:
    with np.load(_TABLE) as z:
        return z["v"]


def max_dims() -> int:
    """The largest dimension count the table holds."""
    return int(_table().shape[0])


def direction_numbers(d: int) -> np.ndarray:
    """The first ``d`` Joe-Kuo direction-number rows, ``[d, 32]`` uint32."""
    t = _table()
    if not 1 <= d <= t.shape[0]:
        raise ValueError(f"sobol dimension {d} outside the baked table (1..{t.shape[0]}); "
                         "regenerate with scripts/gen_sobol_directions.py if more are needed")
    return t[:d]


def _sobol_bits(n: int, v: torch.Tensor) -> torch.Tensor:
    """Unscrambled Sobol integers of points 0..n-1, ``[n, d]`` int64 below
    2**32, from direction numbers ``v`` (``[d, 32]`` int64)."""
    i = torch.arange(n, dtype=torch.int64, device=v.device)
    gray = i ^ (i >> 1)
    x = torch.zeros((n, v.shape[0]), dtype=torch.int64, device=v.device)
    for j in range(max(1, (n - 1).bit_length())):
        bit = (gray >> j) & 1
        x = x ^ (bit[:, None] * v[None, :, j])
    return x


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for ``a`` below 2**32 and a 32-bit constant ``b``,
    without a product past 2**49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _hash32(z: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 avalanche mix (public domain constants)."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x7FEB352D)
    z = z ^ (z >> 15)
    z = _mul32(z, 0x846CA68B)
    return z ^ (z >> 16)


def _owen_scramble(x: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Nested-uniform scramble of ``[n, d]`` Sobol integers with per-dimension
    seeds ``[..., d]`` (int64 below 2**32); leading seed dimensions
    broadcast, so ``[K, d]`` seeds give ``[K, n, d]`` independent scrambles.
    Bit ``b`` of the output flips by a hash of the input's bits above ``b``
    and a per-(dimension, bit) key: 32 hash rounds."""
    bits = torch.arange(32, dtype=torch.int64, device=x.device)
    keys = _hash32(seeds[..., None] ^ _hash32((bits * 0x9E3779B9) & _M32))  # [..., d, 32]
    y = x
    for b in range(32):
        prefix = x >> (b + 1) if b < 31 else torch.zeros_like(x)
        flip = _hash32(prefix ^ keys[..., b].unsqueeze(-2)) & 1
        y = y ^ (flip << b)
    return y


def _to_unit(x: torch.Tensor, dtype) -> torch.Tensor:
    """Bin centres in (0, 1). In float32 the words drop to 23 bits, so that
    ``k + 0.5`` is exact for every bin: with 24 bits the top bin rounds to
    1.0 and ``ndtri`` gives +inf."""
    if dtype == torch.float64:
        return (x.to(torch.float64) + 0.5) * 2.0 ** -32
    return ((x >> 9).to(dtype) + 0.5) * 2.0 ** -23


def draw_seeds(key: torch.Tensor, scrambles: int, d: int) -> torch.Tensor:
    """``[scrambles, d]`` 32-bit scramble seeds (int64) on the key's device:
    ``jax.random.bits(key, (scrambles, d), uint32)``."""
    return random.bits(key, (scrambles, d))


def sobol_points(n: int, d: int, seeds: torch.Tensor) -> torch.Tensor:
    """``[n, d]`` scrambled Sobol integers (int64 below 2**32) on the seeds'
    device: ``K = seeds.shape[0]`` contiguous blocks of ``n / K`` points,
    each the same base points under its own scramble (``K`` independent
    randomized-QMC replicates)."""
    scrambles = seeds.shape[0]
    if n % scrambles:
        raise ValueError("n must be a multiple of scrambles")
    if tuple(seeds.shape) != (scrambles, d):
        raise ValueError(f"seeds must be [scrambles, {d}], got {tuple(seeds.shape)}")
    v = torch.as_tensor(direction_numbers(d).astype(np.int64), device=seeds.device)
    base = _sobol_bits(n // scrambles, v)
    return _owen_scramble(base, seeds.to(torch.int64)).reshape(n, d)


def sobol_uniform(key, n: int, d: int, scrambles: int = 1, dtype=torch.float32, *,
                  seeds: torch.Tensor | None = None) -> torch.Tensor:
    """``[n, d]`` scrambled Sobol points in (0, 1): ``sobol_points`` on
    ``seeds``, or on seeds drawn under ``key`` (``draw_seeds``)."""
    if seeds is None:
        if key is None:
            raise ValueError("sobol_uniform needs a key or seeds")
        seeds = draw_seeds(key, scrambles, d)
    elif seeds.shape[0] != scrambles:
        raise ValueError(f"{seeds.shape[0]} seed rows for {scrambles} scrambles")
    return _to_unit(sobol_points(n, d, seeds), dtype)


def ndtri(u: torch.Tensor) -> torch.Tensor:
    """The inverse normal CDF of ``u``, evaluated in float64 and rounded to
    ``u``'s dtype: within half an ulp in float32, where torch's float32
    evaluation errs by up to 4.3 ulps and the JAX package's by up to 4.5
    (measured on 2M points against float64)."""
    return torch.special.ndtri(u.to(torch.float64)).to(u.dtype)


def sobol_normal(key, n: int, d: int, scrambles: int = 1, dtype=torch.float32, *,
                 seeds: torch.Tensor | None = None) -> torch.Tensor:
    """``[n, d]`` standard-normal scrambled Sobol draws (``ndtri``)."""
    return ndtri(sobol_uniform(key, n, d, scrambles, dtype, seeds=seeds))
