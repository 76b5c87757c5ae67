"""Stopping criteria of ``run_to_precision`` (``erpl_monte_carlo_sim_tpu/mc/sequential.py``).

Each criterion folds in one slab's valid-lane values of its metric, answers
``satisfied()`` and reports a ``block()``. ``run_to_precision`` checks them
after every slab and stops at the first slab boundary where all hold: since
slab k's lanes depend only on ``(seed, k, slab)``, that run is exactly
``run_monte_carlo(n_samples=n_used)``. Counts treat valid lanes as i.i.d.;
stopping on the data makes the final interval's coverage slightly below
nominal (the optional-stopping caveat), second order at slab-sized looks.
"""

from __future__ import annotations

import numpy as np

from .stats import StreamingStats, _wilson, order_stat_ranks

__all__ = ["MeanStderr", "QmcMeanStderr", "ExceedanceDecision", "ExceedanceHalfwidth",
           "QuantileHalfwidth", "parse_criterion", "HEADLINE_METRICS"]

HEADLINE_METRICS = ("apogee_altitude", "range", "flight_time", "max_speed")


def _finite(vals_valid) -> np.ndarray:
    v = np.asarray(vals_valid, np.float64)
    return v[np.isfinite(v)]


class _Criterion:
    metric: str

    def update(self, vals_valid: np.ndarray) -> None:
        raise NotImplementedError

    def satisfied(self) -> bool:
        raise NotImplementedError

    def block(self) -> dict:
        raise NotImplementedError


class MeanStderr(_Criterion):
    """Stop when the stderr of the metric's mean is at most ``target``
    (population variance, as the stats blocks; needs two lanes)."""

    def __init__(self, metric: str, target: float):
        if target <= 0:
            raise ValueError(f"mean_stderr target must be > 0, got {target}")
        self.metric = metric
        self.target = float(target)
        self.n = 0
        self.s = 0.0
        self.s2 = 0.0

    def update(self, vals_valid: np.ndarray) -> None:
        v = _finite(vals_valid)
        self.n += int(v.size)
        self.s += float(v.sum())
        self.s2 += float((v * v).sum())

    def stderr(self) -> float:
        if self.n < 2:
            return float("inf")
        mean = self.s / self.n
        var = max(self.s2 / self.n - mean * mean, 0.0)
        return float(np.sqrt(var / self.n))

    def satisfied(self) -> bool:
        return self.stderr() <= self.target

    def block(self) -> dict:
        return {"kind": "mean_stderr", "metric": self.metric, "target": self.target,
                "n": self.n, "mean": (self.s / self.n) if self.n else float("nan"),
                "stderr": self.stderr() if self.n >= 2 else float("nan"),
                "satisfied": bool(self.satisfied())}


class ExceedanceDecision(_Criterion):
    """Stop when P(metric > threshold) is decided against ``p_limit``: the
    Wilson 95% interval lies wholly below it (``"go"``) or above it
    (``"no_go"``)."""

    def __init__(self, metric: str, threshold: float, p_limit: float):
        if not 0.0 < p_limit < 1.0:
            raise ValueError(f"p_limit must be in (0, 1), got {p_limit}")
        self.metric = metric
        self.threshold = float(threshold)
        self.p_limit = float(p_limit)
        self.n = 0
        self.k = 0

    def update(self, vals_valid: np.ndarray) -> None:
        v = _finite(vals_valid)
        self.n += int(v.size)
        self.k += int((v > self.threshold).sum())

    def decision(self):
        if self.n == 0:
            return None
        lo, hi = _wilson(self.k, self.n)
        if hi <= self.p_limit:
            return "go"
        if lo > self.p_limit:
            return "no_go"
        return None

    def satisfied(self) -> bool:
        return self.decision() is not None

    def block(self) -> dict:
        lo, hi = _wilson(self.k, self.n)
        return {"kind": "exceedance_decision", "metric": self.metric,
                "threshold": self.threshold, "p_limit": self.p_limit, "n": self.n,
                "n_exceed": self.k,
                "probability": (self.k / self.n) if self.n else float("nan"),
                "ci95": [lo, hi], "decision": self.decision(),
                "satisfied": bool(self.satisfied())}


class ExceedanceHalfwidth(_Criterion):
    """Stop when the Wilson 95% interval of P(metric > threshold) has a
    half-width of at most ``target``."""

    def __init__(self, metric: str, threshold: float, target: float):
        if target <= 0:
            raise ValueError(f"ci_halfwidth target must be > 0, got {target}")
        self.metric = metric
        self.threshold = float(threshold)
        self.target = float(target)
        self.n = 0
        self.k = 0

    def update(self, vals_valid: np.ndarray) -> None:
        v = _finite(vals_valid)
        self.n += int(v.size)
        self.k += int((v > self.threshold).sum())

    def halfwidth(self) -> float:
        if self.n == 0:
            return float("inf")
        lo, hi = _wilson(self.k, self.n)
        return (hi - lo) / 2.0

    def satisfied(self) -> bool:
        return self.halfwidth() <= self.target

    def block(self) -> dict:
        lo, hi = _wilson(self.k, self.n)
        return {"kind": "exceedance_halfwidth", "metric": self.metric,
                "threshold": self.threshold, "target": self.target, "n": self.n,
                "n_exceed": self.k,
                "probability": (self.k / self.n) if self.n else float("nan"),
                "ci95": [lo, hi], "halfwidth": self.halfwidth() if self.n else float("nan"),
                "satisfied": bool(self.satisfied())}


class QmcMeanStderr(_Criterion):
    """Stop when the randomized-QMC stderr of the mean (the spread of slab
    means, each slab its own scramble) is at most ``target``, after at least
    ``min_replicates`` slabs. Meaningful only with ``sampler="sobol"``, which
    the port does not have yet (ROADMAP P12): ``run_to_precision`` refuses
    it."""

    requires_sobol = True

    def __init__(self, metric: str, target: float, min_replicates: int = 4):
        if target <= 0:
            raise ValueError(f"qmc_mean_stderr target must be > 0, got {target}")
        if min_replicates < 2:
            raise ValueError(f"min_replicates must be >= 2, got {min_replicates}")
        self.metric = metric
        self.target = float(target)
        self.min_replicates = int(min_replicates)
        self.slab_means: list = []
        self.slab_ns: list = []

    def update(self, vals_valid: np.ndarray) -> None:
        v = _finite(vals_valid)
        if v.size:  # an all-invalid slab is no replicate
            self.slab_means.append(float(v.mean()))
            self.slab_ns.append(int(v.size))

    def mean(self) -> float:
        if not self.slab_means:
            return float("nan")
        m = np.asarray(self.slab_means)
        w = np.asarray(self.slab_ns, np.float64)
        return float((m * w).sum() / w.sum())

    def stderr(self) -> float:
        k = len(self.slab_means)
        if k < self.min_replicates:
            return float("inf")
        m = np.asarray(self.slab_means)
        return float(m.std(ddof=1) / np.sqrt(k))

    def satisfied(self) -> bool:
        return self.stderr() <= self.target

    def block(self) -> dict:
        k = len(self.slab_means)
        return {"kind": "qmc_mean_stderr", "metric": self.metric, "target": self.target,
                "n": int(sum(self.slab_ns)), "n_replicates": k,
                "min_replicates": self.min_replicates, "mean": self.mean(),
                "stderr": self.stderr() if k >= self.min_replicates else float("nan"),
                "satisfied": bool(self.satisfied())}


class QuantileHalfwidth(_Criterion):
    """Stop when the distribution-free 95% interval of the ``percentile``-th
    percentile has a half-width of at most ``target``. While either
    order-statistic rank lies outside the sample the half-width is ``inf``;
    values accumulate in a ``StreamingStats``, whose rank slack widens the
    interval past its exact buffer."""

    def __init__(self, metric: str, percentile: float, target: float,
                 max_centroids: int = 8192, exact_threshold: int = 262_144):
        if not 0.0 < percentile < 100.0:
            raise ValueError(f"percentile must be in (0, 100), got {percentile}")
        if target <= 0:
            raise ValueError(f"ci_halfwidth target must be > 0, got {target}")
        self.metric = metric
        self.percentile = float(percentile)
        self.target = float(target)
        self.stream = StreamingStats(max_centroids, exact_threshold)

    def update(self, vals_valid: np.ndarray) -> None:
        self.stream.add(vals_valid)

    def ci(self) -> list:
        n = self.stream.n
        if n < 2:
            return [float("nan"), float("nan")]
        l, u = order_stat_ranks(n, self.percentile / 100.0)
        if l < 1 or u > n:
            return [-float("inf"), float("inf")]
        return self.stream.percentile_ci([self.percentile])[0]

    def halfwidth(self) -> float:
        lo, hi = self.ci()
        return (hi - lo) / 2.0 if np.isfinite(hi - lo) else float("inf")

    def satisfied(self) -> bool:
        return self.halfwidth() <= self.target

    def block(self) -> dict:
        n = self.stream.n
        est = self.stream.percentiles([self.percentile])[0] if n else float("nan")
        return {"kind": "quantile_halfwidth", "metric": self.metric,
                "percentile": self.percentile, "target": self.target, "n": n,
                "estimate": est, "ci95": self.ci(), "halfwidth": self.halfwidth(),
                "satisfied": bool(self.satisfied())}


def parse_criterion(spec) -> _Criterion:
    """A criterion from its spec dict (a criterion passes through):
    ``{"metric": m, "mean_stderr": x}``, ``{"metric": m, "qmc_mean_stderr": x}``,
    ``{"metric": m, "exceed": t, "p_limit": p}``,
    ``{"metric": m, "exceed": t, "ci_halfwidth": h}`` or
    ``{"metric": m, "percentile": q, "ci_halfwidth": h}``."""
    if isinstance(spec, _Criterion):
        return spec
    if not isinstance(spec, dict):
        raise TypeError(f"criterion must be a dict or Criterion, got {type(spec)}")
    metric = spec.get("metric")
    if metric not in HEADLINE_METRICS:
        raise ValueError(f"criterion metric must be one of {HEADLINE_METRICS}, "
                         f"got {metric!r}")
    keys = set(spec) - {"metric"}
    if keys == {"mean_stderr"}:
        return MeanStderr(metric, spec["mean_stderr"])
    if keys == {"qmc_mean_stderr"}:
        return QmcMeanStderr(metric, spec["qmc_mean_stderr"])
    if keys == {"exceed", "p_limit"}:
        return ExceedanceDecision(metric, spec["exceed"], spec["p_limit"])
    if keys == {"exceed", "ci_halfwidth"}:
        return ExceedanceHalfwidth(metric, spec["exceed"], spec["ci_halfwidth"])
    if keys == {"percentile", "ci_halfwidth"}:
        return QuantileHalfwidth(metric, spec["percentile"], spec["ci_halfwidth"])
    raise ValueError(
        "criterion spec must be {metric, mean_stderr}, {metric, qmc_mean_stderr}, "
        "{metric, exceed, p_limit}, {metric, exceed, ci_halfwidth}, "
        f"or {{metric, percentile, ci_halfwidth}}; got keys {sorted(spec)}")
