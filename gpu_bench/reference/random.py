"""``jax.random``'s draws in plain PyTorch: the functions the JAX package calls
(``PRNGKey``, ``split``, ``fold_in``, ``bits``, ``uniform``, ``normal``,
``randint``, and the vmapped per-lane ``normal`` of the wind draw), key for
key, so that a seed gives the JAX package's lanes on the CPU and on the card.

Keys are ``[..., 2]`` int64 tensors holding two uint32 words
(``ops/prng.py``). Every draw is the plain PyTorch computation of
``ops/prng.py``, on the key's device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .ops.prng import M32, as_key, draw, prng_key

__all__ = ["prng_key", "as_key", "split", "fold_in", "bits", "uniform", "normal",
           "lane_normal", "randint"]


def _draw(key: torch.Tensor, kind: str, shape, **kw) -> torch.Tensor:
    return draw(key, kind, shape, **kw)


def split(key: torch.Tensor, num: int | Sequence[int] = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[*key.shape[:-1], *shape, 2]`` keys."""
    return _draw(key, "keys", num)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count ``(0, data
    mod 2**32)``, ``[*key.shape[:-1], 2]``."""
    return _draw(key, "keys", (), offset=int(data) & M32)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words below 2**32."""
    return _draw(key, "bits", shape)


def uniform(key: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: the unit
    draw times ``maxval - minval`` plus ``minval`` in one fused multiply-add,
    clamped below at ``minval``."""
    return _draw(key, "uniform", shape, dtype=dtype, minval=minval, maxval=maxval)


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: ``sqrt(2) erf_inv(u)`` of a
    uniform on ``(nextafter(-1, 0), 1)``."""
    return _draw(key, "normal", shape, dtype=dtype)


def lane_normal(key: torch.Tensor, n: int, shape=(), dtype=torch.float32,
                sub=None) -> torch.Tensor:
    """``[*key.shape[:-1], n, *shape]`` normals, lane ``b`` drawn under
    ``split(key, n)[b]``, or under ``split(split(key, n)[b])[sub]``: the
    ``jax.vmap`` of ``normal`` over ``split(key, n)`` that draws each lane's
    turbulence, in one launch on the card."""
    return _draw(key, "normal", shape, dtype=dtype, lanes=int(n), sub=sub)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two 32-bit
    draws from ``split(key)`` folded into the span ``maxval - minval``."""
    return _draw(key, "randint", shape, minval=int(minval), maxval=int(maxval))
