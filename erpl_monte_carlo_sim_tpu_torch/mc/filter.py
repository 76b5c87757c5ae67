"""Physics-bounds outlier filter (``erpl_monte_carlo_sim_tpu/mc/filter.py``):
one lane mask plus a reason bitmask, decoded on the host for reports."""

from __future__ import annotations

import dataclasses

import torch

from ..engine.simulate import FlightSummary

__all__ = ["OutlierBounds", "outlier_mask", "decode_reasons", "REASON_NAMES"]


@dataclasses.dataclass(frozen=True)
class OutlierBounds:
    """Physical bounds for a suborbital sounding rocket."""

    max_apogee: float = 80000.0  # m
    min_apogee: float = 100.0  # m
    max_range: float = 200000.0  # m
    max_flight_time: float = 600.0  # s
    # energy sanity: v_max^2 / (2 g) with a 20% margin
    theoretical_max_velocity: float = 1200.0
    energy_margin: float = 1.2

    @property
    def energy_limit_altitude(self) -> float:
        return self.theoretical_max_velocity**2 / (2 * 9.81) * self.energy_margin


# bit i of the reason mask
REASON_NAMES = (
    "non-finite values",
    "apogee above max",
    "apogee below min",
    "range above max",
    "flight time above max",
    "apogee exceeds theoretical energy limit",
    "diverged during integration",
)


def outlier_mask(summary: FlightSummary, bounds: OutlierBounds = OutlierBounds()):
    """``(valid [n] bool, reasons [n] int32)``; a lane is valid iff reasons == 0."""
    apogee, rng, ft = summary.apogee_altitude, summary.range, summary.flight_time
    bits = (
        ~(torch.isfinite(apogee) & torch.isfinite(rng) & torch.isfinite(ft)),
        apogee > bounds.max_apogee,
        apogee < bounds.min_apogee,
        rng > bounds.max_range,
        ft > bounds.max_flight_time,
        apogee > bounds.energy_limit_altitude,
        summary.diverged,
    )
    reasons = torch.zeros_like(apogee, dtype=torch.int32)
    for i, b in enumerate(bits):
        reasons = reasons + b.to(torch.int32) * (1 << i)
    return reasons == 0, reasons


def decode_reasons(reason_bits: int) -> list:
    """Reason bitmask -> list of reason strings."""
    return [name for i, name in enumerate(REASON_NAMES) if reason_bits & (1 << i)]
