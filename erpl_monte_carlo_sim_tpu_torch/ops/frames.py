"""Physical constants of the air model (``erpl_monte_carlo_sim_tpu/ops/frames.py``)."""

GAMMA_AIR = 1.4
R_AIR = 287.053  # J/(kg K)

__all__ = ["GAMMA_AIR", "R_AIR"]
