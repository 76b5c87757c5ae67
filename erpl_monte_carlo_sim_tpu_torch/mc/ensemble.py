"""Post-stratified statistics over a forecast ensemble
(``erpl_monte_carlo_sim_tpu/mc/ensemble.py``).

With an ensemble base wind (``wind[K, N, 3]``) every lane perturbs a
uniformly drawn member (``mc.dispersions``), so each member is a stratum of
known probability 1/K. That gives per-member rows (which forecast drives the
spread or the risk) and a post-stratified mixture estimator, the member
means weighted by the exact 1/K instead of the realized lane shares:

    mean_ps   = (1/K) sum_k mean_k
    stderr_ps = sqrt((1/K^2) sum_k var_k / n_k)

(population variance within a member, its lanes taken as i.i.d.; under
``sampler="sobol"`` or ``antithetic`` the stderr is conservative). A member
without a valid lane leaves the post-stratified values NaN.
"""

from __future__ import annotations

import numpy as np

from .stats import _wilson

__all__ = ["EnsembleAccumulator", "member_exceedance", "METRICS"]

METRICS = ("apogee_altitude", "range", "flight_time")


class EnsembleAccumulator:
    """Per-member moments of the headline metrics that merge slab by slab:
    Welford moments over each member's valid lanes, and the members' drawn
    and valid lane counts. ``add`` folds in one slab; ``block`` renders the
    analysis block."""

    @classmethod
    def from_base_wind(cls, base_wind) -> "EnsembleAccumulator | None":
        """An accumulator when ``base_wind`` carries an ensemble of at least
        two members (``[K >= 2, N, 3]``), else None (a single forecast or a
        one-member ensemble gets no block). Reads the shape only."""
        if base_wind is None:
            return None
        shape = tuple(np.shape(base_wind[1]))  # a tensor's own shape: no copy
        if len(shape) == 3 and shape[0] >= 2:
            return cls(int(shape[0]))
        return None

    def __init__(self, n_members: int):
        if n_members < 2:
            raise ValueError(f"ensemble stats need >= 2 members, got {n_members}")
        self.k = int(n_members)
        self.n_drawn = np.zeros(self.k, np.int64)
        self.n_valid = np.zeros(self.k, np.int64)
        self._n = {m: np.zeros(self.k, np.int64) for m in METRICS}
        self._mean = {m: np.zeros(self.k) for m in METRICS}
        self._m2 = {m: np.zeros(self.k) for m in METRICS}

    def add(self, members: np.ndarray, valid: np.ndarray, metrics: dict) -> None:
        """Fold in one slab: ``members [n]`` int, ``valid [n]`` bool,
        ``metrics`` {name: [n] float}, all on the host."""
        members = np.asarray(members)
        valid = np.asarray(valid, bool)
        self.n_drawn += np.bincount(members, minlength=self.k)
        self.n_valid += np.bincount(members[valid], minlength=self.k)
        for name in METRICS:
            v = np.asarray(metrics[name], np.float64)
            ok = valid & np.isfinite(v)
            mem, vv = members[ok], v[ok]
            nb = np.bincount(mem, minlength=self.k).astype(np.float64)
            sb = np.bincount(mem, weights=vv, minlength=self.k)
            mb = np.divide(sb, nb, out=np.zeros(self.k), where=nb > 0)
            m2b = np.bincount(mem, weights=(vv - mb[mem]) ** 2, minlength=self.k)
            # Chan's parallel merge per member, float64
            na = self._n[name].astype(np.float64)
            tot = na + nb
            delta = mb - self._mean[name]
            safe_tot = np.where(tot > 0, tot, 1.0)
            self._mean[name] += np.where(tot > 0, delta * nb / safe_tot, 0.0)
            self._m2[name] += m2b + np.where(tot > 0, delta * delta * na * nb / safe_tot, 0.0)
            self._n[name] = tot.astype(np.int64)

    def block(self) -> dict:
        """The ``analysis["ensemble"]`` block."""
        members = []
        for j in range(self.k):
            row = {"member": j, "n_drawn": int(self.n_drawn[j]),
                   "n_valid": int(self.n_valid[j])}
            for name in METRICS:
                n = int(self._n[name][j])
                row[name] = {"n": n,
                             "mean": self._mean[name][j] if n else float("nan"),
                             "std": float(np.sqrt(self._m2[name][j] / n)) if n
                             else float("nan")}
            members.append(row)
        post = {}
        for name in METRICS:
            n = self._n[name].astype(np.float64)
            if (n >= 1).all():
                mean_ps = float(self._mean[name].mean())
                var_k = self._m2[name] / n  # population variance
                with np.errstate(divide="ignore"):
                    se2 = float((var_k / n).sum()) / self.k ** 2
                stderr = float(np.sqrt(se2)) if (n >= 2).all() else float("nan")
            else:
                mean_ps, stderr = float("nan"), float("nan")
            post[name] = {"mean": mean_ps, "stderr": stderr}
        return {"n_members": self.k, "members": members, "post_stratified": post}


def member_exceedance(analysis: dict, metric: str, threshold: float) -> list:
    """P(metric > threshold | member k) with its Wilson 95% interval for each
    member, and the post-stratified mixture probability ``(1/K) sum_k p_k``
    with a stderr from each member's Wilson half-width (not zero where a
    member has no or only exceeding lanes). Needs the per-lane layout:
    ``analysis["wind_members"]`` beside every lane's metric (single calls,
    and slabbed runs that keep every lane). An importance-sampled run is
    refused: its raw counts answer the tilted distribution."""
    if analysis.get("importance"):
        raise ValueError("importance-sampled run: member_exceedance counts unweighted "
                         "lanes; use mc.exceedance_from_analysis (whole mixture) or "
                         "weight per member with mc.importance.weighted_tail")
    members = analysis.get("wind_members")
    ens = analysis.get("ensemble")
    if members is None or ens is None:
        raise ValueError("no per-lane ensemble data: run with an ensemble base_wind "
                         "and within the metrics sample cap")
    metrics = analysis.get("metrics")
    if metrics is not None and metric in metrics:
        vals = np.asarray(metrics[metric], np.float64)
    elif analysis.get("summary") is not None:
        vals = np.asarray(getattr(analysis["summary"], metric), np.float64)
    else:
        raise KeyError(f"no per-lane data for metric {metric!r}")
    valid = np.asarray(analysis["valid_mask"], bool)[:vals.size]
    members = np.asarray(members)[:vals.size]
    if analysis.get("metrics_is_sample"):
        raise ValueError("streaming run: per-lane data is a capped sample; "
                         "member_exceedance would silently answer on the prefix only")
    k = int(ens["n_members"])
    ok = valid & np.isfinite(vals)
    out = []
    p_sum, se2_sum, defined = 0.0, 0.0, True
    z95 = 1.959963984540054
    for j in range(k):
        sel = ok & (members == j)
        n = int(sel.sum())
        hits = int((vals[sel] > threshold).sum())
        lo, hi = _wilson(hits, n)
        p = hits / n if n else float("nan")
        out.append({"member": j, "n": n, "n_exceed": hits, "probability": p,
                    "ci95": [lo, hi]})
        if n == 0:
            defined = False
        else:
            p_sum += p
            se2_sum += ((hi - lo) / (2.0 * z95)) ** 2
    post = {"probability": p_sum / k if defined else float("nan"),
            "stderr": (float(np.sqrt(se2_sum)) / k) if defined else float("nan")}
    return [{"threshold": float(threshold), "members": out, "post_stratified": post}]
