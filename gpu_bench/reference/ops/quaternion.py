"""Quaternion algebra and attitude kinematics
(``erpl_monte_carlo_sim_tpu/ops/quaternion.py``), over ``[..., 4]``
quaternions and ``[..., 3, 3]`` matrices.

Storage order ``[w, x, y, z]``; Euler order intrinsic "xyz" (roll, pitch,
yaw); a vertical launch is pitch ~ -pi/2.
"""

from __future__ import annotations

import math

import torch

from .math import arcsin, arctan2

__all__ = ["normalize_quaternion", "quaternion_multiply", "quaternion_to_rotation_matrix",
           "rotate_by_matrix", "rotate_by_matrix_t", "angular_velocity_to_quaternion_rate",
           "euler_to_quaternion", "quaternion_to_euler"]


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) ``[..., 4]``; norms at or below 1e-12 -> identity."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    identity = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])],
                         dim=-1)
    ok = norm > 1e-12
    safe = torch.where(ok, norm, torch.ones_like(norm))
    return torch.where(ok, q / safe, identity)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of ``[w, x, y, z]`` quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Body->inertial ``[..., 3, 3]`` matrix of a quaternion, normalized first."""
    w, x, y, z = normalize_quaternion(q).unbind(-1)
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_by_matrix(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for ``[..., 3, 3]`` matrices and ``[..., 3]`` vectors, as
    the JAX package sums it: three products added left to right a row."""
    return torch.stack([R[..., i, 0] * v[..., 0] + R[..., i, 1] * v[..., 1]
                        + R[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def rotate_by_matrix_t(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R.T @ v``, summed as ``rotate_by_matrix`` sums."""
    return torch.stack([R[..., 0, i] * v[..., 0] + R[..., 1, i] * v[..., 1]
                        + R[..., 2, i] * v[..., 2] for i in range(3)], dim=-1)


def angular_velocity_to_quaternion_rate(omega: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Quaternion kinematics with Baumgarte norm correction (gain 0.5):
    ``0.5 q (x) [0, omega] - 0.5 (q.q - 1) q``."""
    omega_q = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    q_dot = 0.5 * quaternion_multiply(q, omega_q)
    norm_error = torch.sum(q * q, dim=-1, keepdim=True) - 1.0
    return q_dot - 0.5 * norm_error * q


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
