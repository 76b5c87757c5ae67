"""Integration / event configuration (``erpl_monte_carlo_sim_tpu/engine/config.py``).

A frozen, hashable dataclass of plain Python values, field for field the
JAX package's ``SimConfig`` (see that file for what each opt-in flag does).
The port's flight paths implement the parity defaults of the opt-in flags;
``require_parity_flags`` refuses the others (ROADMAP P7 brings them).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["SimConfig", "require_parity_flags"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Integration parameters. Defaults reproduce the reference simulator:
    5 ms RK4 step, 10 ms forward-Euler rail step on an 18.288 m rail, 300 s
    max flight, 20 N m s/rad pitch/yaw damping, ground at 0.5 m while
    descending, 100 km cutoff, apogee detection above 1 km with coast
    timeouts of 60/120/300 s above 50/25 km."""

    dt: float = 0.005
    rail_dt: float = 0.01
    max_time: float = 300.0
    rail_length: float = 18.288
    max_rail_steps: int = 4096

    pitch_damping: float = 20.0
    yaw_damping: float = 20.0

    ground_altitude: float = 0.5
    excessive_altitude: float = 100000.0
    apogee_min_altitude: float = 1000.0
    coast_alt_hi: float = 50000.0
    coast_alt_mid: float = 25000.0
    coast_time_hi: float = 60.0
    coast_time_mid: float = 120.0
    coast_time_lo: float = 300.0

    # stop a lane as diverged once its state is non-finite
    terminate_nonfinite: bool = True
    speed_guard: float = float("inf")  # m/s

    # opt-in fast modes and physics variants (parity defaults)
    wind_eval_per_step: bool = False
    wind_table_bf16: bool = False
    integrator: str = "rk4"
    energy_consistent_aero: bool = False
    descent_dt_scale: int = 1
    descent_settle_time: float = 2.0
    ascent_q_threshold: float = 0.0

    # loop unrolling: results are identical for any value
    unroll: int = 1

    # trajectory recording (not used by the summary path)
    record_derived: bool = True
    record_stride: int = 1
    record_channels: tuple | None = None

    def __post_init__(self):
        if self.integrator not in ("rk4", "rk2"):
            raise ValueError(
                f"integrator must be 'rk4' or 'rk2', got {self.integrator!r}"
            )

    @property
    def max_steps(self) -> int:
        """Bound on main-loop steps."""
        return int(math.ceil(self.max_time / self.dt))


# opt-in flags and their parity values; the port's flight paths implement
# only these values so far
_PARITY_FLAGS = {
    "terminate_nonfinite": True,
    "speed_guard": float("inf"),
    "wind_eval_per_step": False,
    "wind_table_bf16": False,
    "integrator": "rk4",
    "energy_consistent_aero": False,
    "descent_dt_scale": 1,
    "ascent_q_threshold": 0.0,
}


def require_parity_flags(cfg: SimConfig) -> None:
    """Raise ``NotImplementedError`` for any opt-in flag away from its
    parity default."""
    bad = [f"{k}={getattr(cfg, k)!r}" for k, v in _PARITY_FLAGS.items()
           if getattr(cfg, k) != v]
    if bad:
        raise NotImplementedError(
            f"SimConfig flags not ported yet (ROADMAP P7): {', '.join(bad)}")
