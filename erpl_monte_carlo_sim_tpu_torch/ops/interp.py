"""Clamped piecewise-linear table lookup (``erpl_monte_carlo_sim_tpu/ops/interp.py``).

Both functions evaluate the JAX package's tent-basis form term for term:
node ``n`` gets weight ``clip(min(up, down), 0, 1)`` with
``up = (xc - (x_n - left_n)) / left_n`` and
``down = ((x_n + right_n) - xc) / right_n``, and the result is the weighted
sum of the table values. This is ``np.interp``'s clamped-linear rule, and
evaluating the same expressions keeps the port equal to the JAX package to
the last bits (a two-point lerp need not be: ``x_i + dx_i`` need not equal
``x_{i+1}`` in floating point). It also keeps the JAX package's NaN
behaviour: a non-finite table value poisons every query, because its zero
weight times NaN is NaN.
"""

from __future__ import annotations

import torch

__all__ = ["interpolate_1d", "interpolate_vec", "tent_weights"]


def tent_weights(x: torch.Tensor, x_table: torch.Tensor) -> torch.Tensor:
    """Tent weights ``[..., K]`` of the queries ``x [...]`` on ``x_table [K]``."""
    xc = torch.minimum(torch.maximum(x, x_table[0]), x_table[-1])
    # duplicate-knot guard (the JAX package's 1e-30 floor)
    dx = torch.clamp_min(torch.diff(x_table), 1e-30)
    one = torch.ones_like(dx[:1])
    left = torch.cat([one, dx])
    right = torch.cat([dx, one])
    xc = xc[..., None]
    up = (xc - (x_table - left)) / left
    down = ((x_table + right) - xc) / right
    return torch.clamp(torch.minimum(up, down), 0.0, 1.0)


def interpolate_1d(x, x_table: torch.Tensor, y_table: torch.Tensor) -> torch.Tensor:
    """``np.interp(x, x_table, y_table)`` for any-shaped ``x``; tables ``[K]``."""
    x = torch.as_tensor(x, dtype=x_table.dtype, device=x_table.device)
    return torch.sum(tent_weights(x, x_table) * y_table, dim=-1)


def interpolate_vec(x, x_table: torch.Tensor, y_table: torch.Tensor) -> torch.Tensor:
    """Interpolate a vector table ``y_table [..., N, C]`` at ``x [...]``;
    returns ``[..., C]``. A shared ``[N, C]`` table broadcasts over ``x``."""
    x = torch.as_tensor(x, dtype=x_table.dtype, device=x_table.device)
    w = tent_weights(x, x_table)
    comps = [torch.sum(w * y_table[..., :, c], dim=-1)
             for c in range(y_table.shape[-1])]
    return torch.stack(comps, dim=-1)
