"""The statistics of an analysis, worked out again from its per-lane
flights: the outlier filter, the masked moments and percentiles, the
order-statistic intervals, the landing footprint, the observed parameter
ranges, the per-lane records, and a go/no-go row's exceedance and verdict.

The rules are those of the port's ``mc/filter.py`` and ``mc/stats.py`` and
of ``cli/launch_window.py`` as of commit 848e839 (population std,
``np.percentile``'s linear rule, binomial order-statistic ranks, the Wilson
interval). Everything is torch on the host, in float64, or in ``compute``
for the low-precision control; the ranks come from ``scipy.stats.binom``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PERCENTILES", "outlier_reasons", "analysis_numbers", "gonogo_numbers",
           "RANGE_FIELDS", "RECORD_LIMIT"]

PERCENTILES = (5.0, 25.0, 50.0, 75.0, 95.0)
# the physics bounds of the outlier filter
MAX_APOGEE, MIN_APOGEE, MAX_RANGE, MAX_FLIGHT_TIME = 80000.0, 100.0, 200000.0, 600.0
ENERGY_LIMIT = 1200.0 ** 2 / (2 * 9.81) * 1.2
RANGE_FIELDS = ("initial_position_offset", "initial_velocity_offset", "initial_attitude_offset",
                "initial_angular_velocity_offset", "mass_multiplier", "thrust_multiplier",
                "wind_speed", "wind_direction", "density_multiplier", "random_seed")
# the records of valid lanes and of outliers an analysis materializes
RECORD_LIMIT = 1000
RECORD_FIELDS = ("apogee_altitude", "range", "flight_time")
_WILSON_Z = 1.959963984540054


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def outlier_reasons(lanes: dict, dtype=torch.float64) -> np.ndarray:
    """Each lane's reason bits (0: valid), the filter's seven tests."""
    apo, rng, ft = (_t(lanes[k], dtype) for k in ("apogee_altitude", "range", "flight_time"))
    bits = (~(torch.isfinite(apo) & torch.isfinite(rng) & torch.isfinite(ft)),
            apo > MAX_APOGEE, apo < MIN_APOGEE, rng > MAX_RANGE, ft > MAX_FLIGHT_TIME,
            apo > ENERGY_LIMIT, torch.as_tensor(np.asarray(lanes["diverged"]) != 0))
    reasons = torch.zeros(apo.shape, dtype=torch.int64)
    for i, b in enumerate(bits):
        reasons += b.to(torch.int64) << i
    return reasons.numpy()


def _ranks(n: int, q: float, conf: float = 0.95) -> tuple:
    from scipy.stats import binom

    alpha = 1.0 - conf
    return int(binom.ppf(alpha / 2.0, n, q)), int(binom.ppf(1.0 - alpha / 2.0, n, q)) + 1


def _moments(v: torch.Tensor, prefix: str, out: dict) -> None:
    """Mean, population std, min, max, linear-rule percentiles and their
    order-statistic intervals of the valid finite values ``v``."""
    n = v.numel()
    if n == 0:
        for k in ("mean", "std", "min", "max"):
            out[f"{prefix}.{k}"] = math.nan
        return
    mean = v.sum() / n
    out[f"{prefix}.mean"] = float(mean)
    out[f"{prefix}.std"] = float(torch.sqrt(((v - mean) * (v - mean)).sum() / n))
    s = torch.sort(v).values
    out[f"{prefix}.min"], out[f"{prefix}.max"] = float(s[0]), float(s[-1])
    for q in PERCENTILES:
        idx = q / 100.0 * (n - 1)
        lo, hi = math.floor(idx), math.ceil(idx)
        frac = torch.as_tensor(idx - lo, dtype=v.dtype)
        out[f"{prefix}.p{q:g}"] = float(s[lo] + (s[hi] - s[lo]) * frac)
        if n >= 2:
            l, u = _ranks(n, q / 100.0)
            out[f"{prefix}.p{q:g}.ci_lo"] = float(s[max(l, 1) - 1])
            out[f"{prefix}.p{q:g}.ci_hi"] = float(s[min(u, n) - 1])


def _footprint(x: torch.Tensor, y: torch.Tensor, out: dict, prefix="footprint") -> None:
    n = x.numel()
    out[f"{prefix}.n"] = n
    if n == 0:
        return
    mx, my = x.sum() / n, y.sum() / n
    dx, dy = x - mx, y - my
    cxx, cyy, cxy = (dx * dx).sum() / n, (dy * dy).sum() / n, (dx * dy).sum() / n
    out[f"{prefix}.mean_x"], out[f"{prefix}.mean_y"] = float(mx), float(my)
    out[f"{prefix}.cov_xx"], out[f"{prefix}.cov_yy"] = float(cxx), float(cyy)
    out[f"{prefix}.cov_xy"] = float(cxy)
    evals = np.linalg.eigvalsh(np.array([[float(cxx), float(cxy)], [float(cxy), float(cyy)]]))
    for tag, c in (("95", 5.991464547107979), ("99", 9.21034037197618)):
        out[f"{prefix}.ellipse{tag}.major"] = float(np.sqrt(c * max(evals[1], 0.0)))
        out[f"{prefix}.ellipse{tag}.minor"] = float(np.sqrt(c * max(evals[0], 0.0)))
    out[f"{prefix}.cep"] = float(torch.quantile(torch.hypot(dx, dy).double(), 0.5)
                                 .to(x.dtype)) if x.dtype != torch.float64 else \
        float(np.median(np.hypot(dx.numpy(), dy.numpy())))


def analysis_numbers(lanes: dict, sample: dict, dtype=torch.float64) -> tuple:
    """``(numbers, exact)`` of a single-call analysis of ``lanes`` (every
    lane's ``LANE_FIELDS``) drawn as ``sample`` (``SAMPLE_FIELDS``): the
    float statistics by name, and the quantities that must agree exactly
    (counts, the valid mask, the records' lane ids and values)."""
    reasons = outlier_reasons(lanes, dtype)
    valid = reasons == 0
    num, exact = {}, {}
    n = valid.size
    exact["n_samples"] = np.array([valid.sum()])
    exact["n_outliers"] = np.array([n - valid.sum()])
    exact["reasons"] = reasons
    for k in ("apogee_altitude", "range", "flight_time"):
        v = _t(lanes[k], dtype)
        _moments(v[torch.as_tensor(valid) & torch.isfinite(v)], k, num)
    lp = np.asarray(lanes["landing_position"])
    fin = valid & np.isfinite(lp[:, 0]) & np.isfinite(lp[:, 1])
    _footprint(_t(lp[fin, 0], dtype), _t(lp[fin, 1], dtype), num)
    if valid.any():
        for k in RANGE_FIELDS:
            arr = np.asarray(sample[k])[valid]
            arr = arr.reshape(arr.shape[0], -1)
            t = _t(arr, dtype if arr.dtype.kind == "f" else torch.float64)
            for j in range(arr.shape[1]):
                num[f"ranges.{k}.{j}.min"] = float(t[:, j].min())
                num[f"ranges.{k}.{j}.max"] = float(t[:, j].max())
    for tag, ids in (("results", np.nonzero(valid)[0]), ("outliers", np.nonzero(~valid)[0])):
        ids = ids[:RECORD_LIMIT]
        exact[f"{tag}.simulation_id"] = ids
        for k in RECORD_FIELDS:
            exact[f"{tag}.{k}"] = np.asarray(lanes[k], np.float64)[ids]
    return num, exact


def _wilson(k: int, n: int, dtype) -> tuple:
    if n == 0:
        return math.nan, math.nan
    z = torch.as_tensor(_WILSON_Z, dtype=dtype)
    p = torch.as_tensor(k / n, dtype=dtype)
    den = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / den
    half = z * torch.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return max(float(center - half), 0.0), min(float(center + half), 1.0)


def gonogo_numbers(lanes: dict, range_limit: float, p_limit: float,
                   dtype=torch.float64) -> tuple:
    """``(numbers, exact)`` of a go/no-go row over one candidate's lanes:
    counts, the apogee's and range's mean and std, the range's 95th
    percentile, the footprint's mean and CEP, the range exceedance with its
    Wilson interval, and the verdict (go iff the interval's upper end is at
    most ``p_limit``)."""
    reasons = outlier_reasons(lanes, dtype)
    valid = reasons == 0
    full, num = {}, {}
    for k in ("apogee_altitude", "range"):
        v = _t(lanes[k], dtype)
        _moments(v[torch.as_tensor(valid) & torch.isfinite(v)], k, full)
    for k in ("apogee_altitude.mean", "apogee_altitude.std", "range.mean", "range.std",
              "range.p95"):
        num[k] = full.get(k, math.nan)
    lp = np.asarray(lanes["landing_position"])
    fin = valid & np.isfinite(lp[:, 0]) & np.isfinite(lp[:, 1])
    fp = {}
    _footprint(_t(lp[fin, 0], dtype), _t(lp[fin, 1], dtype), fp)
    for k in ("footprint.mean_x", "footprint.mean_y", "footprint.cep"):
        num[k] = fp.get(k, math.nan)
    rng = np.asarray(lanes["range"], np.float64)
    ok = valid & np.isfinite(rng)
    k_ex, n_ok = int((_t(rng[ok], dtype) > range_limit).sum()), int(ok.sum())
    lo, hi = _wilson(k_ex, n_ok, dtype)
    num["p_range_exceed"] = k_ex / n_ok if n_ok else math.nan
    num["p_range_exceed.ci_lo"], num["p_range_exceed.ci_hi"] = lo, hi
    exact = {"n_valid": np.array([valid.sum()]), "n_outliers": np.array([(~valid).sum()]),
             "n_exceed": np.array([k_ex]), "go": np.array([int(hi <= p_limit)])}
    return num, exact
