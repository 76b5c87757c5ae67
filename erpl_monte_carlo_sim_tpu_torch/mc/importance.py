"""Importance sampling's weights and weighted means
(``erpl_monte_carlo_sim_tpu/mc/importance.py``, the part the analyzer
reports).

``sample_dispersions(importance_shift=...)`` draws the named Gaussian
multiplier channels with their means shifted by ``theta`` sigmas. Against
the nominal distribution each lane then weighs ``exp(sum_c(-theta_c z_c +
theta_c^2 / 2))``, with ``z_c = (multiplier - 1) / sigma_c`` the recorded
standardized draw, so the weights come back from the sample alone. The
estimators are self-normalized ratios: the outlier filter's validity
indicator is weighted like the numerator, and the weights are needed only
up to a constant. The effective sample size ``(sum w)^2 / sum w^2`` says
how many plain lanes the run is worth.
"""

from __future__ import annotations

import numpy as np

from ..utils.convert import to_numpy

__all__ = ["TILTABLE", "log_weights", "weighted_mean"]

# the channels importance_shift may tilt: channel -> (sample field, its
# sigma from (params, motor))
TILTABLE = {
    "mass": ("mass_multiplier", lambda p, m: float(p.mass_uncertainty)),
    "motor_thrust": ("motor_thrust_multiplier", lambda p, m: float(m.thrust_uncertainty)),
    "motor_flow": ("motor_flow_multiplier", lambda p, m: float(m.mass_flow_uncertainty)),
    "density": ("density_multiplier",
                lambda p, m: float(p.atmospheric_density_uncertainty)),
}


def log_weights(sample, params, motor, importance_shift) -> np.ndarray:
    """Each lane's log likelihood ratio back to the nominal distribution,
    float64 on the host. ``sample`` holds the draws made under the shifted
    proposal (device tensors or host arrays)."""
    lw = None
    for name, theta in dict(importance_shift).items():
        field, sig_fn = TILTABLE[name]
        sigma = sig_fn(params, motor)
        if sigma <= 0.0:
            raise ValueError(f"channel {name!r} has zero sigma; it cannot have been tilted")
        z = (np.asarray(to_numpy(getattr(sample, field)), np.float64) - 1.0) / sigma
        term = -theta * z + 0.5 * theta * theta
        lw = term if lw is None else lw + term
    if lw is None:
        lw = np.zeros(np.shape(sample.mass_multiplier)[0])
    return lw


def _nw(log_w: np.ndarray) -> np.ndarray:
    """The weights normalized by their largest (no overflow)."""
    lw = np.asarray(log_w, np.float64)
    return np.exp(lw - lw.max())


def weighted_mean(values, mask, log_w) -> dict:
    """Self-normalized estimate of E[value | valid] under the nominal
    distribution, with its delta-method stderr and the effective sample
    size; ``mask`` is the validity indicator, weighted in the denominator
    over every lane."""
    v = np.asarray(values, np.float64)
    m = np.asarray(mask, bool) & np.isfinite(v)
    w = _nw(log_w)
    n = w.size
    den = float((w * m).sum())
    if den <= 0.0:
        return {"mean": float("nan"), "stderr": float("nan"), "n_eff": 0.0, "n": n}
    mu = float((w * np.where(m, v, 0.0)).sum() / den)
    # delta method on the ratio sum(w y 1) / sum(w 1): per-lane residuals
    r = w * np.where(m, v - mu, 0.0)
    var = float((r ** 2).sum()) / den ** 2
    w_used = w * m
    n_eff = float(w_used.sum() ** 2 / max((w_used ** 2).sum(), 1e-300))
    return {"mean": mu, "stderr": float(np.sqrt(var)), "n_eff": n_eff, "n": n}
