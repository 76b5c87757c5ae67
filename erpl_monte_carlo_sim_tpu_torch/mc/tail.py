"""Tail extrapolation by peaks over threshold
(``erpl_monte_carlo_sim_tpu/mc/tail.py``), host NumPy.

Counting answers P(metric > t) only while lanes land past ``t``. A
generalized Pareto distribution fitted to the sample's largest values
(probability-weighted moments, Hosking & Wallis 1987) extrapolates the
survival function past the data's reach, from a plain run and without a
tilt direction. The bootstrap resamples the exceedances with
``np.random.default_rng(seed)`` and draws the threshold's exceedance rate
from a Jeffreys Beta, in the JAX package's order, so the same seed gives the
same interval.

``TailReservoir`` keeps the exact top-k and bottom-k values across slabs:
streaming runs keep one per headline metric, it rides the mid-run checkpoint
and ``save_summaries``, and ``tail_from_analysis`` fits it when the per-lane
arrays are only a prefix. Importance-tilted runs are refused: their tails
are ``mc.importance.weighted_tail``'s.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TailReservoir", "fit_gpd_pwm", "gpd_tail", "tail_from_analysis"]


class TailReservoir:
    """The ``k`` largest (``hi``) and smallest (``lo``) finite values seen
    over a stream of batches, sorted, and the count ``n`` of values seen:
    exact order statistics, independent of batch order."""

    def __init__(self, k: int = 4096):
        self.k = int(k)
        self.n = 0
        self.hi = np.empty(0)
        self.lo = np.empty(0)

    def add(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        self.n += v.size
        hi = np.concatenate([self.hi, v])
        lo = np.concatenate([self.lo, v])
        if hi.size > self.k:
            hi = np.partition(hi, hi.size - self.k)[hi.size - self.k:]
            lo = np.partition(lo, self.k)[:self.k]
        self.hi = np.sort(hi)
        self.lo = np.sort(lo)

    def merge(self, other: "TailReservoir") -> None:
        """Exact merge of another reservoir (the union's top k lies in the
        parts' top ks); not ``add`` of its arrays, which would count a value
        held in both of a small reservoir's sides twice."""
        self.n += other.n
        hi = np.concatenate([self.hi, other.hi])
        lo = np.concatenate([self.lo, other.lo])
        self.hi = np.sort(hi)[-min(self.k, hi.size):]
        self.lo = np.sort(lo)[:min(self.k, lo.size)]

    def to_arrays(self, out: dict, prefix: str) -> None:
        """Serialize into ``out`` under ``prefix``: the one layout of both
        checkpoint formats (``mc.checkpoint``, ``mc.slab_checkpoint``)."""
        out[prefix + "hi"] = self.hi
        out[prefix + "lo"] = self.lo
        out[prefix + "nk"] = np.asarray([self.n, self.k], np.int64)

    @classmethod
    def from_arrays(cls, z, prefix: str) -> "TailReservoir":
        """Inverse of ``to_arrays`` (``z``: a loaded npz or a mapping)."""
        n_seen, k_keep = (int(x) for x in z[prefix + "nk"])
        r = cls(k_keep)
        r.n = n_seen
        r.hi = np.array(z[prefix + "hi"], np.float64)
        r.lo = np.array(z[prefix + "lo"], np.float64)
        return r


def fit_gpd_pwm(exceedances) -> tuple:
    """``(shape xi, scale sigma)`` of a GPD fitted to positive exceedances by
    probability-weighted moments (Hosking's ``k`` is ``-xi``); survival
    ``(1 + xi y / sigma)^(-1/xi)``, ``exp(-y / sigma)`` at ``xi = 0``.
    Degenerate samples (constant or tied tails, a collapsed scale) raise
    ValueError."""
    y = np.sort(np.asarray(exceedances, np.float64))
    n = y.size
    if n < 10:
        raise ValueError(f"need >= 10 exceedances to fit a tail, got {n}")
    # a0 = E[X], a1 = E[X (1 - F(X))] with the plotting position (n-1-i)/(n-1)
    # at the i-th ascending order statistic
    a0 = y.mean()
    a1 = (((n - 1.0 - np.arange(n)) / (n - 1.0)) * y).mean()
    denom = a0 - 2.0 * a1
    if not (a0 > 0.0) or abs(denom) < 1e-12 * a0:
        raise ValueError("degenerate exceedances (constant or heavily tied tail) — "
                         "the GPD fit is undefined; use counting or change n_tail")
    k = a0 / denom - 2.0
    sigma = a0 * (1.0 + k)
    if not np.isfinite(sigma) or sigma <= 0.0:
        raise ValueError("GPD fit collapsed (non-positive scale) — exceedances are "
                         "too degenerate to extrapolate; use counting or change n_tail")
    return float(-k), float(sigma)


def _gpd_sf(y, xi, sigma):
    """GPD survival at exceedances ``y >= 0``; zero past a bounded tail's
    end (``xi < 0``)."""
    y = np.maximum(np.asarray(y, np.float64), 0.0)
    if abs(xi) < 1e-9:
        return np.exp(-y / sigma)
    arg = 1.0 + xi * y / sigma
    if xi < 0.0:
        return np.where(arg > 0.0, np.maximum(arg, 0.0) ** (-1.0 / xi), 0.0)
    return arg ** (-1.0 / xi)


def gpd_tail(values, n_total: int, thresholds, *, side: str = "upper",
             n_tail: int = 1000, n_boot: int = 500, seed: int = 0) -> dict:
    """GPD extrapolation from the ``n_tail`` most extreme ``values`` of a
    sample of ``n_total`` (the values may be the whole sample or its
    retained extremes). Returns ``{"fit": {...}, "exceedance": [{threshold,
    probability, method, ci95 | note}, ...]}``: P(X > t) on the upper side,
    P(X < t) on the lower; thresholds inside the fitted threshold are
    counted among the values (``method="count"``), NaN where the retained
    window does not cover their rank. ``n_boot=0`` skips the bootstrap."""
    if side not in ("upper", "lower"):
        raise ValueError("side must be 'upper' or 'lower'")
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if side == "lower":
        v = -v
    v = np.sort(v)
    if n_total < v.size:
        raise ValueError("n_total is smaller than the provided values")
    n_tail = int(min(n_tail, v.size - 1))
    if n_tail < 10:
        raise ValueError(f"need >= 10 exceedances (have {v.size} values); lower n_tail "
                         "or provide more extremes")
    u = v[-(n_tail + 1)]  # the (n_tail + 1)-th largest value
    exc = v[-n_tail:] - u
    p_u = n_tail / float(n_total)
    xi, sigma = fit_gpd_pwm(exc)

    ts = np.atleast_1d(np.asarray(thresholds, np.float64))
    ts_i = -ts if side == "lower" else ts
    count_p = (v.size - np.searchsorted(v, ts_i, side="right")) / float(n_total)
    p = np.where(ts_i > u, p_u * _gpd_sf(ts_i - u, xi, sigma), count_p)
    in_window = (ts_i > v[0]) | (v.size == n_total)

    rng = np.random.default_rng(seed)
    boots = np.empty((n_boot, ts.size))
    for b in range(n_boot):
        yb = rng.choice(exc, size=n_tail, replace=True)
        try:
            xib, sigb = fit_gpd_pwm(yb)
        except ValueError:
            boots[b] = np.nan
            continue
        pub = rng.beta(n_tail + 0.5, n_total - n_tail + 0.5)
        boots[b] = np.where(ts_i > u, pub * _gpd_sf(ts_i - u, xib, sigb), np.nan)
    extr = ts_i > u
    lohi = np.full((2, ts.size), np.nan)
    if n_boot > 0 and extr.any():
        lohi[:, extr] = np.nanpercentile(boots[:, extr], [2.5, 97.5], axis=0)

    out = {
        "fit": {
            "side": side,
            "threshold": float(u if side == "upper" else -u),
            "n_tail": n_tail,
            "n_total": int(n_total),
            "p_threshold": p_u,
            "shape_xi": xi,
            "scale_sigma": sigma,
            # probability-weighted moments hold for |xi| < 0.5
            "pwm_regime_ok": bool(abs(xi) < 0.5),
        },
        "exceedance": [],
    }
    for j, t in enumerate(ts):
        extrapolated = bool(ts_i[j] > u)
        row = {"threshold": float(t),
               "probability": float(p[j]) if in_window[j] else float("nan"),
               "method": "gpd" if extrapolated else "count"}
        if extrapolated and n_boot > 0:
            row["ci95"] = [float(lohi[0, j]), float(lohi[1, j])]
        elif not in_window[j]:
            row["note"] = ("threshold below the retained extremes; use "
                           "mc.exceedance_from_analysis")
        out["exceedance"].append(row)
    return out


def tail_from_analysis(analysis: dict, metric: str, thresholds, *, side: str = "upper",
                       n_tail: int = 1000, n_boot: int = 500, seed: int = 0) -> dict:
    """``gpd_tail`` on a finished run, whatever its layout: the per-lane
    values (``summary``, or a slabbed run's ``metrics``), or a streaming
    run's ``tail_reservoirs`` when ``metrics`` is only a prefix. Valid lanes
    only, as every stats block."""
    if analysis.get("importance"):
        raise ValueError("GPD extrapolation on an importance-tilted run would describe "
                         "the SHIFTED population; use mc.importance.weighted_tail")
    res = (analysis.get("tail_reservoirs") or {}).get(metric)
    if analysis.get("metrics_is_sample") and res is not None:
        vals = res.hi if side == "upper" else res.lo
        return gpd_tail(vals, res.n, thresholds, side=side, n_tail=n_tail, n_boot=n_boot,
                        seed=seed)
    if analysis.get("summary") is not None:
        if not hasattr(analysis["summary"], metric):
            raise KeyError(f"no per-lane data for metric {metric!r}")
        vals = np.asarray(getattr(analysis["summary"], metric))
    else:
        metrics = analysis.get("metrics") or {}
        if metric not in metrics:
            raise KeyError(f"no per-lane data for metric {metric!r}")
        vals = np.asarray(metrics[metric])
    mask = np.asarray(analysis["valid_mask"]) & np.isfinite(vals)
    return gpd_tail(vals[mask], int(mask.sum()), thresholds, side=side, n_tail=n_tail,
                    n_boot=n_boot, seed=seed)
