"""Masked statistics for Monte Carlo summaries (``erpl_monte_carlo_sim_tpu/mc/stats.py``).

``masked_stats`` reduces on the tensors' device; everything else is host
NumPy, as in the JAX package, and gives its numbers bit for bit on the same
arrays: the percentile confidence intervals, the landing footprint, the
slab-mergeable ``StreamingStats`` and ``FootprintAccumulator`` of slabbed
runs, and the exceedance queries. Percentiles use ``np.percentile``'s linear
rule; std is the population std.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["PERCENTILES", "masked_stats", "order_stat_ranks", "percentile_ci",
           "landing_footprint", "StreamingStats", "FootprintAccumulator", "exceedance",
           "exceedance_from_analysis"]

log = logging.getLogger(__name__)

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


def _gaussian_cep(cov: np.ndarray) -> float:
    """Median miss distance of the fitted 2-D Gaussian, from a deterministic
    2^16-point sample of the first two unscrambled Sobol dimensions
    (``ops.sobol``'s construction)."""
    from scipy.special import ndtri

    from ..ops.sobol import _sobol_bits, direction_numbers

    evals = np.maximum(np.linalg.eigvalsh(cov), 0.0)
    v = torch.as_tensor(direction_numbers(2).astype(np.int64))
    z = ndtri((_sobol_bits(1 << 16, v).numpy().astype(np.float64) + 0.5) * 2.0 ** -32)
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


# ------------------------------------------------ streaming (slabbed runs)
def _compress_centroids(vals: np.ndarray, weights: np.ndarray, k: int):
    """Compress weighted points to at most ``k`` equal-mass centroids: points
    are bucketed by the midpoint of their cumulative mass (monotone in value
    order, so bucket means stay sorted) and each bucket collapses to its
    weighted mean. The bound is on rank, about 1/(2k) of the total mass;
    across an empty density gap (a bimodal metric) the value error can reach
    the gap's width."""
    order = np.argsort(vals, kind="stable")
    v = vals[order]
    w = weights[order]
    cw = np.cumsum(w)
    total = cw[-1]
    bucket = np.minimum(((cw - 0.5 * w) / total * k).astype(np.int64), k - 1)
    wsum = np.bincount(bucket, weights=w, minlength=k)
    vsum = np.bincount(bucket, weights=w * v, minlength=k)
    keep = wsum > 0
    return vsum[keep] / wsum[keep], wsum[keep]


class StreamingStats:
    """Single-pass, slab-mergeable statistics of one scalar metric.

    Moments, min and max accumulate exactly (float64 Chan/Welford merge).
    Until ``exact_threshold`` values have been added the raw values are kept
    and percentiles are ``np.percentile``'s; past it every batch is
    compressed to ``max_centroids`` weighted centroids, which recompress at
    8x, so memory stays O(max_centroids) whatever the count."""

    def __init__(self, max_centroids: int = 8192, exact_threshold: int = 4_194_304):
        self.max_centroids = max_centroids
        self.exact_threshold = exact_threshold
        self._exact_parts: list | None = []
        self._cent_v = np.empty(0)
        self._cent_w = np.empty(0)
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = np.inf
        self._max = -np.inf
        self._warned = False

    def add(self, values: np.ndarray) -> None:
        """Fold in one batch (non-finite values are dropped)."""
        v = np.asarray(values, np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        nb = v.size
        mb = float(v.mean())
        m2b = float(((v - mb) ** 2).sum())
        if self.n == 0:
            self.n, self._mean, self._m2 = nb, mb, m2b
        else:
            delta = mb - self._mean
            tot = self.n + nb
            self._mean += delta * nb / tot
            self._m2 += m2b + delta * delta * self.n * nb / tot
            self.n = tot
        self._min = min(self._min, float(v.min()))
        self._max = max(self._max, float(v.max()))
        if self._exact_parts is not None:
            self._exact_parts.append(v)
            if self.n > self.exact_threshold:
                # each kept part compresses on its own, as it would have
                for part in self._exact_parts:
                    self._add_sketch(part, np.ones_like(part))
                self._exact_parts = None
            return
        self._add_sketch(v, np.ones_like(v))

    def _add_sketch(self, vals, weights):
        cv, cw = _compress_centroids(vals, weights, self.max_centroids)
        self._cent_v = np.concatenate([self._cent_v, cv])
        self._cent_w = np.concatenate([self._cent_w, cw])
        if self._cent_v.size > 8 * self.max_centroids:
            self._cent_v, self._cent_w = _compress_centroids(
                self._cent_v, self._cent_w, self.max_centroids)

    @property
    def is_exact(self) -> bool:
        return self._exact_parts is not None

    def _centroid_curve(self) -> tuple:
        """Sorted centroid values and the mass midpoint of each."""
        order = np.argsort(self._cent_v, kind="stable")
        cv = self._cent_v[order]
        cw = self._cent_w[order]
        return cv, np.cumsum(cw) - 0.5 * cw

    def percentiles(self, qs=PERCENTILES) -> list:
        if self.n == 0:
            return [float("nan")] * len(qs)
        if self._exact_parts is not None:
            vals = np.concatenate(self._exact_parts)
            return [float(x) for x in np.percentile(vals, list(qs))]
        cv, mid = self._centroid_curve()
        # np.percentile's rank q/100*(n-1); a unit point at rank r has mass
        # midpoint r + 0.5
        targets = np.asarray(qs, np.float64) / 100.0 * (self.n - 1) + 0.5
        return [float(x) for x in np.interp(targets, mid, cv)]

    def cdf(self, xs) -> np.ndarray:
        """P(value <= x) per query point: exact while the raw values are
        kept, interpolated on the sketch after; certain outside [min, max]."""
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        if self.n == 0:
            return np.full(xs.shape, np.nan)
        if self._exact_parts is not None:
            vals = np.concatenate(self._exact_parts)
            return (vals[None, :] <= xs[:, None]).mean(axis=1)
        cv, mid = self._centroid_curve()
        p = np.interp(xs, cv, mid) / self.n
        p = np.where(xs < cv[0], mid[0] / self.n, p)
        p = np.where(xs >= cv[-1], mid[-1] / self.n, p)
        p = np.where(xs < self._min, 0.0, p)
        p = np.where(xs >= self._max, 1.0, p)
        return p

    def percentile_ci(self, qs=PERCENTILES, conf: float = 0.95) -> list:
        """``percentile_ci``'s order-statistic intervals: exact while the raw
        values are kept; on the sketch the binomial ranks are widened by its
        rank bound (n / (2 max_centroids)) before the lookup, and the bounds
        clamp to the exact min and max."""
        if self.n < 2:
            return [[float("nan")] * 2 for _ in np.atleast_1d(qs)]
        if self._exact_parts is not None:
            vals = np.concatenate(self._exact_parts)
            return percentile_ci(vals, np.ones(vals.shape, bool), qs, conf)
        cv, mid = self._centroid_curve()
        slack = self.n / (2.0 * self.max_centroids)
        out = []
        for q in np.atleast_1d(np.asarray(qs, np.float64)):
            l, u = order_stat_ranks(self.n, q / 100.0, conf)
            r_lo = (max(l, 1) - 0.5) - slack
            r_hi = (min(u, self.n) - 0.5) + slack
            lo = float(np.interp(r_lo, mid, cv))
            hi = float(np.interp(r_hi, mid, cv))
            out.append([max(lo, self._min), min(hi, self._max)])
        return out

    def sketch_warnings(self, qs=PERCENTILES, warn_frac: float = 0.05) -> list:
        """One message per requested percentile whose target rank falls
        between two centroids more than ``warn_frac`` of the std apart (a
        density gap, where the sketch's value error can approach the gap);
        empty while the raw values are kept."""
        if self._exact_parts is not None or self.n < 2:
            return []
        sigma = float(np.sqrt(self._m2 / self.n))
        if not np.isfinite(sigma) or sigma == 0.0:
            return []
        cv, mid = self._centroid_curve()
        out = []
        for q in np.atleast_1d(np.asarray(qs, np.float64)):
            target = q / 100.0 * (self.n - 1) + 0.5
            i = int(np.searchsorted(mid, target))
            if i <= 0 or i >= cv.size:
                continue
            gap = float(cv[i] - cv[i - 1])
            if gap > warn_frac * sigma:
                out.append(f"p{q:g} interpolates across a {gap / sigma:.2f}-sigma "
                           "centroid gap (multimodal metric?) — sketch value "
                           "error can approach the gap width")
        return out

    def stats(self) -> dict:
        """The analysis' stats block (``_host_stats``'s schema), with a
        ``sketch_warning`` list (logged once) where a percentile crosses a
        wide centroid gap."""
        if self.n == 0:
            nan = float("nan")
            return {"mean": nan, "std": nan, "min": nan, "max": nan,
                    "percentiles": [nan] * len(PERCENTILES),
                    "percentile_ci": [[nan, nan]] * len(PERCENTILES)}
        out = {
            "mean": self._mean,
            "std": float(np.sqrt(self._m2 / self.n)),
            "min": self._min,
            "max": self._max,
            "percentiles": self.percentiles(),
            "percentile_ci": self.percentile_ci(),
        }
        warnings = self.sketch_warnings()
        if warnings:
            out["sketch_warning"] = warnings
            if not self._warned:
                self._warned = True
                log.warning("quantile sketch: %s", "; ".join(warnings))
        return out


class FootprintAccumulator:
    """The landing footprint of a slabbed run from per-slab centred moments
    ``(n, mean_x, mean_y, M2x, M2y, Cxy)``, merged in float64 (Chan): mean,
    covariance and ellipses are exact; the CEP is the fitted Gaussian's
    (``cep_method="gaussian"``), since per-lane distances are not kept."""

    def __init__(self):
        self.n = 0
        self.mx = self.my = 0.0
        self.m2x = self.m2y = self.cxy = 0.0

    def add(self, n: int, mx: float, my: float, m2x: float, m2y: float,
            cxy: float) -> None:
        n = int(n)
        if n == 0:
            return
        na, nb = self.n, n
        tot = na + nb
        dx = float(mx) - self.mx
        dy = float(my) - self.my
        w = na * nb / tot
        self.m2x += float(m2x) + dx * dx * w
        self.m2y += float(m2y) + dy * dy * w
        self.cxy += float(cxy) + dx * dy * w
        self.mx += dx * nb / tot
        self.my += dy * nb / tot
        self.n = tot

    def footprint(self) -> dict:
        if self.n == 0:
            return landing_footprint(np.empty(0), np.empty(0))
        cov = np.array([[self.m2x, self.cxy], [self.cxy, self.m2y]]) / self.n
        block = {"n": self.n, "mean_m": [self.mx, self.my], "cov_m2": cov.tolist()}
        block.update(_ellipses(cov))
        block["cep_m"] = _gaussian_cep(cov)
        block["cep_method"] = "gaussian"
        return block


# ------------------------------------------------------------- exceedance
def _wilson(k: int, n: int, z: float = 1.959963984540054) -> tuple:
    """Wilson 95% score interval of a binomial proportion."""
    if n == 0:
        return (float("nan"), float("nan"))
    p = k / n
    den = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / den
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(center - half, 0.0), min(center + half, 1.0))


def exceedance(values, mask, thresholds) -> list:
    """P(metric > t | valid) per threshold over ``values[mask & finite]``,
    exact, with its Wilson 95% interval."""
    v = np.asarray(values, np.float64)
    m = np.asarray(mask, bool) & np.isfinite(v)
    v = v[m]
    n = int(v.size)
    out = []
    for t in np.atleast_1d(np.asarray(thresholds, np.float64)):
        k = int((v > t).sum())
        lo, hi = _wilson(k, n)
        out.append({"threshold": float(t), "probability": (k / n) if n else float("nan"),
                    "n_exceed": k, "n": n, "ci95": [lo, hi], "method": "exact"})
    return out


def exceedance_from_analysis(analysis: dict, metric: str, thresholds) -> list:
    """Exceedance probabilities of a finished run, whatever its layout: exact
    with the Wilson interval where per-lane values exist (``summary``, or
    ``metrics`` with ``valid_mask``, or a stream that still keeps its raw
    values); from the quantile sketch otherwise (``method="sketch"``, no
    interval); over the kept prefix (``method="sample_prefix"``) for a
    streaming run's metric without a sketch. Importance-sampled analyses
    (``importance``) go through ``mc.importance.weighted_tail``
    (``method="importance"``): a plain count of a tilted population would
    answer another question."""
    imp = analysis.get("importance")
    if imp is not None:
        from .importance import weighted_tail

        if analysis.get("summary") is not None:
            if not hasattr(analysis["summary"], metric):
                raise KeyError(f"no per-lane data for metric {metric!r}")
            vals = getattr(analysis["summary"], metric)
        else:
            metrics = analysis.get("metrics") or {}
            if metric not in metrics:
                raise KeyError(f"no per-lane data for metric {metric!r}")
            vals = metrics[metric]
        return weighted_tail(vals, analysis["valid_mask"], imp["log_weights"], thresholds)
    streams = analysis.get("streams") or {}
    if analysis.get("metrics_is_sample") and metric in streams:
        s = streams[metric]
        if s.is_exact:
            vals = np.concatenate(s._exact_parts) if s.n else np.empty(0)
            return exceedance(vals, np.ones(vals.shape, bool), thresholds)
        ts = np.atleast_1d(np.asarray(thresholds, np.float64))
        ps = s.cdf(ts)
        return [{"threshold": float(t), "probability": float(1.0 - p), "n": s.n,
                 "method": "sketch"} for t, p in zip(ts, ps)]
    if analysis.get("summary") is not None:
        if not hasattr(analysis["summary"], metric):
            raise KeyError(f"no per-lane data or sketch for metric {metric!r}")
        return exceedance(getattr(analysis["summary"], metric), analysis["valid_mask"],
                          thresholds)
    metrics = analysis.get("metrics")
    if metrics is None or metric not in metrics:
        raise KeyError(f"no per-lane data or sketch for metric {metric!r}")
    out = exceedance(metrics[metric], analysis["valid_mask"], thresholds)
    if analysis.get("metrics_is_sample"):
        for row in out:
            row["method"] = "sample_prefix"
    return out
