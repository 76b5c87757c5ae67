"""Elementwise math helpers (port of ``erpl_monte_carlo_sim_tpu/ops/math.py``).

Only what the flight needs: ``safe_norm``, ``safe_sqrt`` and the native
inverse trig.
The JAX package's polynomial atan/atan2/asin and ``powf`` exist because the
TPU's Pallas lowering lacks those primitives; PyTorch and CUDA have them.
"""

from __future__ import annotations

import torch

__all__ = ["safe_norm", "safe_sqrt", "arctan2", "arcsin"]


def safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a NaN-free gradient at exactly zero: the sqrt of the
    same sum of squares where it is positive, else 0 (``x > 0`` routes a
    NaN sum to 0, as the JAX package's does)."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    ok = sq > 0.0
    return torch.where(ok, torch.sqrt(torch.where(ok, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a NaN-free gradient at exactly zero; NaN still propagates.

    The guard is ``~(x <= 0)``, not ``x > 0``: both route x == 0 to the
    constant-0 branch, but the former sends NaN through ``sqrt`` so a
    diverged lane's NaN speed/range stays NaN and the ``isfinite``
    divergence checks still see it."""
    ok = ~(x <= 0.0)
    return torch.where(ok, torch.sqrt(torch.where(ok, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y, x)


def arcsin(x: torch.Tensor) -> torch.Tensor:
    return torch.asin(x)
