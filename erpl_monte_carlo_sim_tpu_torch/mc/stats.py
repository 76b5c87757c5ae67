"""Masked statistics for Monte Carlo summaries (``erpl_monte_carlo_sim_tpu/mc/stats.py``).

``masked_stats`` reduces on the tensors' device; the percentile confidence
intervals and the landing footprint are host NumPy, as in the JAX package.
Percentiles use ``np.percentile``'s linear rule; std is the population std.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PERCENTILES", "masked_stats", "order_stat_ranks", "percentile_ci",
           "landing_footprint"]

PERCENTILES = (5.0, 25.0, 50.0, 75.0, 95.0)


def masked_stats(values: torch.Tensor, mask: torch.Tensor) -> dict:
    """mean/std/min/max/percentiles over ``values[mask & finite]``; NaNs
    (and ``n == 0``) when no lane is valid."""
    mask = mask & torch.isfinite(values)
    n_valid = torch.sum(mask)
    denom = torch.clamp_min(n_valid, 1)
    mean = torch.sum(torch.where(mask, values, 0.0)) / denom
    dev = values - mean
    var = torch.sum(torch.where(mask, dev * dev, 0.0)) / denom
    std = torch.sqrt(var)
    vmin = torch.min(torch.where(mask, values, torch.inf))
    vmax = torch.max(torch.where(mask, values, -torch.inf))

    # invalid lanes sort to +inf; index the valid prefix with the linear rule
    sorted_vals = torch.sort(torch.where(mask, values, torch.inf)).values
    qs = torch.tensor(PERCENTILES, dtype=values.dtype, device=values.device)
    idx = qs / 100.0 * torch.clamp_min(n_valid - 1, 0).to(values.dtype)
    lo = torch.floor(idx).long()
    hi = torch.ceil(idx).long()
    frac = idx - lo.to(values.dtype)
    v_lo, v_hi = sorted_vals[lo], sorted_vals[hi]
    pct = v_lo + (v_hi - v_lo) * frac

    empty = n_valid == 0
    return {
        "mean": torch.where(empty, torch.nan, mean),
        "std": torch.where(empty, torch.nan, std),
        "min": torch.where(empty, torch.nan, vmin),
        "max": torch.where(empty, torch.nan, vmax),
        "percentiles": torch.where(empty, torch.nan, pct),
        "n": n_valid,
    }


def order_stat_ranks(n: int, q_frac: float, conf: float = 0.95) -> tuple:
    """1-indexed order-statistic ranks ``(l, u)`` bracketing the population
    ``q_frac`` quantile with probability >= ``conf`` (unclamped: ``l`` may be
    0 and ``u`` may be ``n + 1``)."""
    from scipy.stats import binom

    alpha = 1.0 - conf
    l = int(binom.ppf(alpha / 2.0, n, q_frac))
    u = int(binom.ppf(1.0 - alpha / 2.0, n, q_frac)) + 1
    return l, u


def percentile_ci(values, mask, qs=PERCENTILES, conf: float = 0.95) -> list:
    """Distribution-free ``[[lo, hi], ...]`` intervals on the percentiles
    ``qs`` (in percent) from order statistics; NaN with < 2 valid lanes."""
    v = np.asarray(values, np.float64)
    m = np.asarray(mask, bool) & np.isfinite(v)
    v = np.sort(v[m])
    n = int(v.size)
    out = []
    for q in np.atleast_1d(np.asarray(qs, np.float64)):
        if n < 2:
            out.append([float("nan"), float("nan")])
            continue
        l, u = order_stat_ranks(n, q / 100.0, conf)
        out.append([float(v[max(l, 1) - 1]), float(v[min(u, n) - 1])])
    return out


# 2-DOF chi-square quantiles: P(z1^2 + z2^2 <= c) = p  =>  c = -2 ln(1-p)
_CHI2_2DOF = {"0.95": 5.991464547107979, "0.99": 9.21034037197618}


def _ellipses(cov: np.ndarray) -> dict:
    """95%/99% dispersion-ellipse axes from a 2x2 landing covariance."""
    evals, evecs = np.linalg.eigh(cov)
    e_minor, e_major = max(evals[0], 0.0), max(evals[1], 0.0)
    v = evecs[:, 1]
    out = {"orientation_deg": float(np.degrees(np.arctan2(v[1], v[0])))}
    for tag, c in _CHI2_2DOF.items():
        out[f"ellipse{tag.replace('0.', '')}"] = {
            "semi_major_m": float(np.sqrt(c * e_major)),
            "semi_minor_m": float(np.sqrt(c * e_minor)),
        }
    return out


def _sobol2(n: int) -> np.ndarray:
    """The first two Sobol dimensions (Joe-Kuo direction numbers: van der
    Corput, then the x + 1 polynomial), points 0..n-1, as uint32 [n, 2]."""
    v = np.zeros((2, 32), np.uint32)
    m = 1
    for k in range(32):
        v[0, k] = 1 << (31 - k)
        v[1, k] = m << (31 - k)
        m = (m << 1) ^ m
    i = np.arange(n, dtype=np.uint32)
    gray = i ^ (i >> np.uint32(1))
    x = np.zeros((n, 2), np.uint32)
    for j in range(max(1, (n - 1).bit_length())):
        bit = (gray >> np.uint32(j)) & np.uint32(1)
        x ^= bit[:, None] * v[None, :, j]
    return x


def _gaussian_cep(cov: np.ndarray) -> float:
    """Median miss distance of the fitted 2-D Gaussian, from a deterministic
    2^16-point Sobol sample."""
    from scipy.special import ndtri

    evals = np.maximum(np.linalg.eigvalsh(cov), 0.0)
    z = ndtri((_sobol2(1 << 16).astype(np.float64) + 0.5) * 2.0 ** -32)
    d2 = evals[1] * z[:, 0] ** 2 + evals[0] * z[:, 1] ** 2
    return float(np.sqrt(np.median(d2)))


def landing_footprint(x, y) -> dict:
    """Landing footprint of valid, finite impact points: mean, population
    covariance, 95%/99% ellipses and the empirical CEP."""
    n = int(np.size(x))
    if n == 0:
        nan = float("nan")
        return {"n": 0, "mean_m": [nan, nan], "cov_m2": [[nan, nan], [nan, nan]],
                "orientation_deg": nan,
                "ellipse95": {"semi_major_m": nan, "semi_minor_m": nan},
                "ellipse99": {"semi_major_m": nan, "semi_minor_m": nan},
                "cep_m": nan, "cep_method": "empirical"}
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mx, my = float(x.mean()), float(y.mean())
    dx, dy = x - mx, y - my
    cov = np.array([[np.mean(dx * dx), np.mean(dx * dy)],
                    [np.mean(dx * dy), np.mean(dy * dy)]])
    block = {"n": n, "mean_m": [mx, my], "cov_m2": cov.tolist()}
    block.update(_ellipses(cov))
    block["cep_m"] = float(np.median(np.hypot(dx, dy)))
    block["cep_method"] = "empirical"
    return block
