"""Aerodynamic angles, frame transforms and flow quantities
(``erpl_monte_carlo_sim_tpu/ops/frames.py``), over ``[..., 3]`` vectors.
Every guarded branch is given finite inputs, so the untaken side of each
mask is finite."""

from __future__ import annotations

import torch

from .math import arctan2, safe_norm

GAMMA_AIR = 1.4
R_AIR = 287.053  # J/(kg K)

__all__ = ["mach_number", "angle_of_attack", "sideslip_angle", "wind_to_body_matrix",
           "GAMMA_AIR", "R_AIR"]


def mach_number(velocity: torch.Tensor, temperature) -> torch.Tensor:
    """Mach number of a ``[..., 3]`` velocity at a static temperature."""
    return safe_norm(velocity) / torch.sqrt(GAMMA_AIR * R_AIR * temperature)


def angle_of_attack(velocity_body: torch.Tensor) -> torch.Tensor:
    """``atan2(w, u)``; 0 when both ``|u|`` and ``|w|`` are below 1e-6."""
    u, w = velocity_body[..., 0], velocity_body[..., 2]
    degenerate = (torch.abs(u) < 1e-6) & (torch.abs(w) < 1e-6)
    u_s = torch.where(degenerate, 1.0, u)
    w_s = torch.where(degenerate, 0.0, w)
    return torch.where(degenerate, 0.0, arctan2(w_s, u_s))


def sideslip_angle(velocity_body: torch.Tensor) -> torch.Tensor:
    """``atan2(v, sqrt(u^2 + w^2))``; 0 when the xz speed is below 1e-6."""
    u, v, w = velocity_body.unbind(-1)
    sq = u * u + w * w
    degenerate = sq < 1e-12
    v_xz = torch.sqrt(torch.where(degenerate, 1.0, sq))
    v_s = torch.where(degenerate, 0.0, v)
    return torch.where(degenerate, 0.0, arctan2(v_s, v_xz))


def wind_to_body_matrix(alpha, beta) -> torch.Tensor:
    """``[..., 3, 3]`` rotation from wind axes (x along the relative wind)
    to body axes; positive alpha is nose-up, positive beta nose-right."""
    alpha, beta = torch.as_tensor(alpha), torch.as_tensor(beta)
    alpha, beta = torch.broadcast_tensors(alpha, beta)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    rows = ((ca * cb, -sb, sa * cb),
            (ca * sb, cb, sa * sb),
            (-sa, torch.zeros_like(ca), ca))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
