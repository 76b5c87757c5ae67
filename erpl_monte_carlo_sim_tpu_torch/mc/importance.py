"""Importance sampling's weights and weighted estimators
(``erpl_monte_carlo_sim_tpu/mc/importance.py``).

``sample_dispersions(importance_shift=...)`` draws the named Gaussian
multiplier channels with their means shifted by ``theta`` sigmas. Against
the nominal distribution each lane then weighs ``exp(sum_c(-theta_c z_c +
theta_c^2 / 2))``, with ``z_c = (multiplier - 1) / sigma_c`` the recorded
standardized draw, so the weights come back from the sample alone. The
estimators are self-normalized ratios: the outlier filter's validity
indicator is weighted like the numerator, and the weights are needed only
up to a constant. The effective sample size ``(sum w)^2 / sum w^2`` says
how many plain lanes the run is worth.

``shift_from_gradients`` picks a tilt from the metric's linear response
(the design-point rule); ``auto_shift``, which gets that response from one
reverse pass through the differentiable flight (``engine.diff``).
"""

from __future__ import annotations

import numpy as np

from ..utils.convert import to_numpy

__all__ = ["TILTABLE", "log_weights", "weighted_mean", "weighted_tail",
           "shift_from_gradients", "auto_shift"]

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


def weighted_tail(values, mask, log_w, thresholds) -> list:
    """Self-normalized estimate of P(value > t | valid) per threshold under
    the nominal distribution, with its delta-method stderr and the tail's
    effective sample size (the weights of the exceeding lanes). A threshold
    no lane exceeds reads probability 0 with a NaN stderr: vacuous, not
    certain."""
    v = np.asarray(values, np.float64)
    m = np.asarray(mask, bool) & np.isfinite(v)
    w = _nw(log_w)
    den = float((w * m).sum())
    out = []
    for t in np.atleast_1d(np.asarray(thresholds, np.float64)):
        if den <= 0.0:
            out.append({"threshold": float(t), "probability": float("nan"),
                        "stderr": float("nan"), "n_eff_tail": 0.0, "method": "importance"})
            continue
        hit = m & (v > t)
        if not hit.any():
            out.append({"threshold": float(t), "probability": 0.0, "stderr": float("nan"),
                        "n_eff_tail": 0.0, "method": "importance"})
            continue
        p = float((w * hit).sum() / den)
        r = w * (hit.astype(np.float64) - p) * m
        se = float(np.sqrt((r ** 2).sum()) / den)
        wt = w * hit
        n_eff = float(wt.sum() ** 2 / max((wt ** 2).sum(), 1e-300))
        out.append({"threshold": float(t), "probability": p, "stderr": se,
                    "n_eff_tail": n_eff, "method": "importance"})
    return out


# importance channel -> the sensitivity gradient's channel; only the
# Gaussian multipliers are tiltable
_AUTO_GRAD = {
    "mass": "mass_multiplier",
    "motor_thrust": "thrust_multiplier",
    "motor_flow": "flow_multiplier",
    "density": "density_multiplier",
}


def shift_from_gradients(value, grads, sigmas, threshold, frac: float = 0.75,
                         min_theta: float = 0.05):
    """First-order design-point tilt for P(metric > threshold): with the
    metric linearized as ``value + sum_c r_c z_c`` (``r_c = grads[c] *
    sigmas[c]`` over the tiltable channels), the proposal mean moves
    ``frac`` of the way to the nearest point of the failure boundary,
    ``z* = (threshold - value) / ||r||`` along ``r / ||r||``; channels whose
    tilt is below ``min_theta`` are dropped. Returns ``(shift, info)``, the
    ``importance_shift`` dict and a JSON-ready diagnostic block."""
    if not np.isfinite(value):
        raise ValueError(f"nominal metric value is non-finite ({value}); the flight "
                         "itself diverges — fix the configuration before tilting")
    resp = {}
    for name in _AUTO_GRAD:
        g = grads.get(name)
        sigma = sigmas.get(name, 0.0)
        if g is None or sigma <= 0.0:
            continue
        r = float(g) * float(sigma)
        if not np.isfinite(r):
            raise ValueError(
                f"non-finite gradient for tiltable channel {name!r} "
                f"(gradient*sigma = {r}); the reverse pass through the "
                "flight is NaN — use a windowed SimConfig (max_time) or "
                "energy_consistent_aero, then retry auto tilting")
        resp[name] = r
    lin = float(np.sqrt(sum(r * r for r in resp.values())))
    info = {"metric_nominal": float(value), "threshold": float(threshold),
            "sigma_linear": lin, "response": resp, "frac": float(frac)}
    if lin <= 0.0:
        raise ValueError(
            "metric has zero linear response to every tiltable channel "
            f"({tuple(_AUTO_GRAD)}); auto tilting cannot help — tilt by "
            "hand or use GPD extrapolation")
    z_star = (float(threshold) - float(value)) / lin
    info["z_star"] = z_star
    shift = {}
    for name, r in resp.items():
        theta = frac * z_star * r / lin
        if abs(theta) >= min_theta:
            shift[name] = theta
    info["shift"] = dict(shift)
    return shift, info


def auto_shift(scene, ic, cfg, metric, threshold, params=None, frac: float = 0.75,
               min_theta: float = 0.05):
    """The tilt for P(metric > threshold), picked automatically: one reverse
    pass through the differentiable flight gives every channel's gradient
    (``cli.sensitivity.metric_sensitivities``), the dispersion laws give the
    sigmas, and ``shift_from_gradients``' design-point rule does the rest.
    Returns ``(shift, info)``."""
    # the gradient helpers live with the CLI they serve, which imports mc
    from ..cli.sensitivity import _channel_sigmas, metric_sensitivities
    from .dispersions import UncertaintyParams

    if params is None:
        params = UncertaintyParams()
    value, grads = metric_sensitivities(scene, ic, cfg, metric=metric)
    csig = _channel_sigmas(scene, params)
    g = {name: float(grads[field]) for name, field in _AUTO_GRAD.items()}
    s = {name: float(csig[field]) for name, field in _AUTO_GRAD.items()}
    return shift_from_gradients(float(value), g, s, threshold, frac=frac, min_theta=min_theta)
