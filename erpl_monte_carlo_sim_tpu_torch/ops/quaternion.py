"""Quaternion conversions (``erpl_monte_carlo_sim_tpu/ops/quaternion.py``).

Storage order ``[w, x, y, z]``; Euler order intrinsic "xyz" (roll, pitch,
yaw); a vertical launch is pitch ~ -pi/2.
"""

from __future__ import annotations

import math

import torch

from .math import arcsin, arctan2

__all__ = ["normalize_quaternion", "euler_to_quaternion", "quaternion_to_euler"]


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) ``[..., 4]``; norms at or below 1e-12 -> identity."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    identity = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])],
                         dim=-1)
    ok = norm > 1e-12
    safe = torch.where(ok, norm, torch.ones_like(norm))
    return torch.where(ok, q / safe, identity)


def euler_to_quaternion(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic-xyz Euler angles -> ``[..., 4]`` ``[w, x, y, z]``."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` quaternion -> ``[..., 3]`` ``[roll, pitch, yaw]``, with the
    +/-90 deg pitch clamp."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = 2 * (w * y - z * x)
    pitch = torch.where(
        torch.abs(sinp) >= 1,
        torch.sign(sinp) * (math.pi / 2),
        arcsin(torch.clamp(sinp, -1.0, 1.0)),
    )
    yaw = arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)
