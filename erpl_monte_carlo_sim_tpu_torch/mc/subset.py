"""Subset simulation for deep-tail probabilities and quantiles
(``erpl_monte_carlo_sim_tpu/mc/subset.py``), host NumPy over a callable.

Estimates P(g(U) >= T) for U ~ N(0, I_d) down to about 1e-9 at a few
thousand evaluations per decade (Au & Beck 2001, with the adaptive
conditional sampler of Papaioannou et al. 2015): the tail is a product of
conditional probabilities through thresholds chosen as each level's (1 -
p0) quantile, and each level's conditional population comes from
preconditioned Crank-Nicolson chains, ``u' = sqrt(1 - beta^2) u + beta
xi``, which leave N(0, I) invariant, so a step is accepted when ``g(u') >=
t_j``. The chains advance together: a level is ``chain_len - 1`` batched
evaluations of ``n_keep`` lanes each (one K1 launch each when the analyzer
drives ``g``, ``mc.subset_driver``).

Each level's estimate adds ``(1 - p_j) / (p_j n) * (1 + gamma_j)`` to the
squared coefficient of variation, ``gamma_j`` the chains' autocorrelation
inflation; levels are treated as independent (Au & Beck sec. 6.3, slightly
optimistic; ``pool_subset_runs`` gives the between-seed error bar instead).

The random numbers come from ``np.random.default_rng(seed)`` in the JAX
package's order (the level-0 population, then one ``standard_normal((n_keep,
d))`` per chain step), so the same ``g`` gives the same result dict.
"""

from __future__ import annotations

import numpy as np

__all__ = ["subset_simulation", "subset_quantile", "pool_subset_runs",
           "pool_subset_quantiles"]


def _chain_gamma(G: np.ndarray, t: float) -> tuple:
    """Autocorrelation inflation factor for the estimate
    ``mean(G >= t)`` over a chain-structured population.

    ``G`` is ``[chain_len, n_chains]`` (step-major). Returns
    ``(p_hat, gamma)`` with ``gamma = 2 * sum_k (1 - k/chain_len) rho_k``
    (Au & Beck eq. 29), clamped to >= 0; gamma = 0 for i.i.d. chains.
    """
    I = (G >= t).astype(np.float64)
    cl = I.shape[0]
    p = float(I.mean())
    r0 = p * (1.0 - p)
    if r0 <= 0.0 or cl < 2:
        return p, 0.0
    gamma = 0.0
    for k in range(1, cl):
        # lag-k autocovariance along chains, averaged over chains
        rk = float((I[:-k] * I[k:]).mean()) - p * p
        gamma += 2.0 * (1.0 - k / cl) * (rk / r0)
    return p, max(gamma, 0.0)


def _advance_chains(rng, evaluate, cur_u, cur_g, t_level, beta, chain_len,
                    target_accept):
    """Advance ``n_keep`` pCN chains ``chain_len - 1`` steps conditioned
    on ``g >= t_level``. Returns ``(u, g, G_chain, acc_rates, beta)``
    with ``u``/``g`` the concatenated step-major population
    (``[chain_len * n_keep, ...]``) and ``G_chain`` ``[chain_len,
    n_keep]``. The rng consumption order is part of the determinism
    contract: one ``standard_normal((n_keep, d))`` per step."""
    cur_u = cur_u.copy()
    cur_g = cur_g.copy()
    d = cur_u.shape[1]
    n_keep = cur_u.shape[0]
    steps_u = [cur_u.copy()]
    steps_g = [cur_g.copy()]
    acc_rates = []
    for step in range(1, chain_len):
        xi = rng.standard_normal((n_keep, d))
        prop = np.sqrt(1.0 - beta * beta) * cur_u + beta * xi
        gp = evaluate(prop)
        acc = gp >= t_level
        cur_u = np.where(acc[:, None], prop, cur_u)
        cur_g = np.where(acc, gp, cur_g)
        steps_u.append(cur_u.copy())
        steps_g.append(cur_g.copy())
        a = float(acc.mean())
        acc_rates.append(a)
        # aCS-style damped adaptation toward target_accept; exact
        # invariance holds at any fixed beta, adaptation only tunes
        # mixing (vanishing-adaptation schedule)
        beta = float(np.clip(
            beta * np.exp((a - target_accept) / np.sqrt(step)),
            0.01, 0.99,
        ))
    u = np.concatenate(steps_u, axis=0)
    g = np.concatenate(steps_g, axis=0)
    return u, g, np.stack(steps_g, axis=0), acc_rates, beta


def subset_simulation(g_fn, d: int, *, threshold: float,
                      n_per_level: int = 2048, p0: float = 0.125,
                      seed: int = 0, beta0: float = 0.6,
                      target_accept: float = 0.3,
                      max_levels: int = 15,
                      return_population: bool = False) -> dict:
    """Estimate ``P(g_fn(U) >= threshold)`` for ``U ~ N(0, I_d)``.

    ``g_fn``: maps a ``[n, d]`` float array of standard normals to ``[n]``
    metric values. Non-finite outputs are treated as ``-inf`` — they never
    exceed any threshold and never seed a chain (an invalid/diverged
    flight cannot certify an exceedance; callers wanting the complementary
    convention should fold it into ``g_fn``). Called with two batch
    shapes only: ``n_per_level`` and ``round(p0 * n_per_level)``.

    ``p0``: level survival fraction; ``n_per_level`` must be divisible by
    ``n_keep = round(p0 * n_per_level)``. Smaller p0 = fewer levels of
    longer chains; 0.1-0.3 is standard.

    Deterministic in ``seed`` for a fixed configuration and a
    deterministic ``g_fn``.

    Returns a dict: ``probability``, ``log10_probability``, ``cov``
    (coefficient of variation, delta), lognormal ``ci95``,
    ``valid_fraction`` (finite fraction at level 0), ``n_levels``,
    ``n_sims``, ``stalled`` (True when the run ended before its
    intermediate thresholds reached ``threshold`` — level budget
    exhausted, or a level could not raise the threshold — the estimate
    then reflects counting at the stall point and, if no sample exceeds,
    ``probability`` is 0.0 with ``cov`` inf: an honest "not observable
    at this budget", not a certificate), and
    per-level ``levels`` diagnostics (threshold, conditional probability,
    acceptance rate, gamma, beta).

    ``return_population=True`` additionally returns ``u_final`` /
    ``g_final`` — the last level's population (``[n, d]`` / ``[n]``).
    The lanes with ``g_final >= threshold`` are samples of the FAILURE
    REGION's conditional distribution (MCMC-correlated, not i.i.d.):
    their per-dimension statistics are the empirical design point —
    which inputs drive the tail (see
    ``MonteCarloAnalyzer.subset_tail``'s ``failure_channels`` block).
    """
    n = int(n_per_level)
    if not (0.0 < p0 < 1.0):
        raise ValueError(f"p0 must be in (0, 1), got {p0}")
    n_keep = int(round(p0 * n))
    if n_keep < 2:
        raise ValueError(
            f"p0 * n_per_level = {p0 * n} keeps fewer than 2 seeds"
        )
    if n % n_keep:
        raise ValueError(
            f"n_per_level ({n}) must be divisible by n_keep ({n_keep}); "
            "pick p0 = 1/k or adjust n_per_level"
        )
    if max_levels < 1:
        raise ValueError("max_levels must be >= 1")
    chain_len = n // n_keep
    threshold = float(threshold)
    rng = np.random.default_rng(seed)

    def evaluate(u):
        g = np.asarray(g_fn(u), np.float64).reshape(-1)
        if g.shape[0] != u.shape[0]:
            raise ValueError(
                f"g_fn returned {g.shape[0]} values for {u.shape[0]} lanes"
            )
        return np.where(np.isfinite(g), g, -np.inf)

    u = rng.standard_normal((n, d))
    g = evaluate(u)
    valid_fraction = float(np.isfinite(g).mean())
    # Step-major chain layout of the CURRENT population ([chain_len,
    # n_keep]); None at level 0 (i.i.d., gamma = 0).
    G_chain = None

    beta = float(beta0)
    levels = []
    log_p = 0.0
    delta_sq = 0.0
    n_sims = n
    stalled = False
    t_prev = -np.inf

    for level in range(max_levels):
        order = np.argsort(g)[::-1]  # descending; -inf sinks
        t_cand = float(g[order[n_keep - 1]])
        last = (t_cand >= threshold or level == max_levels - 1
                or not np.isfinite(t_cand) or t_cand <= t_prev)
        t_level = threshold if t_cand >= threshold else t_cand
        if last:
            if t_cand < threshold:
                # level budget exhausted, fewer than n_keep finite
                # samples, or a threshold that refuses to rise (atomic/
                # bounded metric): counting at `threshold` on this
                # population is still an unbiased conditional estimate —
                # but it can be 0.
                stalled = True
            if G_chain is None:
                p_fin = float((g >= threshold).mean())
                gamma = 0.0
            else:
                p_fin, gamma = _chain_gamma(G_chain, threshold)
            if p_fin > 0.0:
                log_p += np.log(p_fin)
                delta_sq += (1.0 - p_fin) / (p_fin * n) * (1.0 + gamma)
                probability = float(np.exp(log_p))
                cov = float(np.sqrt(delta_sq))
            else:
                probability, cov = 0.0, float("inf")
            levels.append({"threshold": threshold, "p": p_fin,
                           "accept_rate": None, "gamma": gamma,
                           "beta": beta})
            break
        # intermediate level: survival fraction is p0 by construction
        p_lvl, gamma = (p0, 0.0) if G_chain is None \
            else _chain_gamma(G_chain, t_level)
        log_p += np.log(p_lvl)
        delta_sq += (1.0 - p_lvl) / (p_lvl * n) * (1.0 + gamma)
        t_prev = t_level

        # --- conditional resampling: n_keep pCN chains of chain_len steps
        u, g, G_chain, acc_rates, beta = _advance_chains(
            rng, evaluate, u[order[:n_keep]], g[order[:n_keep]],
            t_level, beta, chain_len, target_accept)
        n_sims += n_keep * (chain_len - 1)
        levels.append({
            "threshold": t_level, "p": p_lvl,
            "accept_rate": float(np.mean(acc_rates)) if acc_rates else None,
            "gamma": gamma, "beta": beta,
        })

    out_pop = {"u_final": u, "g_final": g} if return_population else {}
    return {
        **out_pop,
        "probability": probability,
        "log10_probability": (float(np.log10(probability))
                              if probability > 0 else -float("inf")),
        "cov": cov,
        "ci95": [probability * float(np.exp(-1.96 * cov)),
                 probability * float(np.exp(1.96 * cov))]
        if np.isfinite(cov) else [0.0, float("nan")],
        "valid_fraction": valid_fraction,
        "threshold": threshold,
        "n_per_level": n, "p0": p0, "chain_len": chain_len,
        "n_levels": len(levels), "n_sims": n_sims,
        "stalled": stalled, "seed": int(seed),
        "levels": levels,
    }


def subset_quantile(g_fn, d: int, *, p_target: float,
                    n_per_level: int = 2048, p0: float = 0.125,
                    seed: int = 0, beta0: float = 0.6,
                    target_accept: float = 0.3,
                    return_population: bool = False) -> dict:
    """The inverse problem: estimate the threshold ``T`` with
    ``P(g_fn(U) >= T) = p_target`` for ``U ~ N(0, I_d)`` — a deep-tail
    QUANTILE ("what bound holds at 1e-6?") far beyond the reach of
    direct order statistics (which need ~10/p_target samples).

    Same machinery as :func:`subset_simulation`, driven by level count
    instead of a stopping threshold: run ``m`` intermediate levels with
    ``m`` chosen so the residual fraction ``r = p_target / p0**m`` lands
    in ``(p0, 1]``, then read ``T`` off the final conditional population
    as its upper-``r`` order statistic. The returned
    ``ci95_threshold`` converts the cumulative Au & Beck probability cov
    into threshold units through the same population's order statistics
    (ranks at ``r * exp(+-1.96 delta)``) — inheriting the
    level-independence approximation, so pool seeds
    (:func:`pool_subset_quantiles`) when the decision is tight.

    ``g_fn`` contract and determinism as in :func:`subset_simulation`
    (non-finite -> -inf: an invalid flight never certifies a bound, so
    ``p_target`` is a JOINT exceed-AND-valid fraction). ``stalled=True``
    when a level could not raise its threshold (atomic/bounded metric)
    or the residual rank fell below 1 lane — ``threshold`` then reports
    the deepest resolvable order statistic, a best-effort bound, not a
    certificate.

    Reference counterpart: none — the reference's quantiles stop at the
    fixed percentiles of a fixed-n run (`monte_carlo.py:444-459`).
    """
    n = int(n_per_level)
    if not (0.0 < p_target < 1.0):
        raise ValueError(f"p_target must be in (0, 1), got {p_target}")
    if not (0.0 < p0 < 1.0):
        raise ValueError(f"p0 must be in (0, 1), got {p0}")
    n_keep = int(round(p0 * n))
    if n_keep < 2:
        raise ValueError(
            f"p0 * n_per_level = {p0 * n} keeps fewer than 2 seeds"
        )
    if n % n_keep:
        raise ValueError(
            f"n_per_level ({n}) must be divisible by n_keep ({n_keep}); "
            "pick p0 = 1/k or adjust n_per_level"
        )
    chain_len = n // n_keep
    p_target = float(p_target)
    # intermediate level count: residual r = p_target / p0^m in (p0, 1];
    # exact powers run one fewer level so the final read sits at the
    # (1 - p0) point of its population, not at its minimum
    m_int = int(np.ceil(np.log(p_target) / np.log(p0))) - 1
    m_int = max(m_int, 0)
    rng = np.random.default_rng(seed)

    def evaluate(u):
        g = np.asarray(g_fn(u), np.float64).reshape(-1)
        if g.shape[0] != u.shape[0]:
            raise ValueError(
                f"g_fn returned {g.shape[0]} values for {u.shape[0]} lanes"
            )
        return np.where(np.isfinite(g), g, -np.inf)

    u = rng.standard_normal((n, d))
    g = evaluate(u)
    valid_fraction = float(np.isfinite(g).mean())
    G_chain = None
    beta = float(beta0)
    levels = []
    delta_sq = 0.0
    n_sims = n
    stalled = False
    t_prev = -np.inf

    for _ in range(m_int):
        order = np.argsort(g)[::-1]
        t_level = float(g[order[n_keep - 1]])
        if not np.isfinite(t_level) or t_level <= t_prev:
            stalled = True  # atomic/bounded metric: cannot condition deeper
            break
        p_lvl, gamma = (p0, 0.0) if G_chain is None \
            else _chain_gamma(G_chain, t_level)
        delta_sq += (1.0 - p_lvl) / (p_lvl * n) * (1.0 + gamma)
        t_prev = t_level
        u, g, G_chain, acc_rates, beta = _advance_chains(
            rng, evaluate, u[order[:n_keep]], g[order[:n_keep]],
            t_level, beta, chain_len, target_accept)
        n_sims += n_keep * (chain_len - 1)
        levels.append({
            "threshold": t_level, "p": p_lvl,
            "accept_rate": float(np.mean(acc_rates)) if acc_rates else None,
            "gamma": gamma, "beta": beta,
        })

    # final read: upper-residual order statistic of the conditional
    # population (conditioned on p0^len(levels))
    residual = p_target / p0 ** len(levels)
    g_desc = np.sort(g)[::-1]

    def _t_at(frac):
        rank = int(np.ceil(frac * n))
        if rank < 1:
            return None
        return float(g_desc[min(rank, n) - 1])

    t_hat = _t_at(residual)
    if t_hat is None or not np.isfinite(t_hat):
        # residual rank below 1 lane (stalled run), or the order
        # statistic landed on an invalid lane: report the deepest
        # resolvable finite value
        stalled = True
        fin = g_desc[np.isfinite(g_desc)]
        t_hat = float(fin[0]) if fin.size else float("nan")
    if G_chain is None:
        gamma_fin = 0.0
    else:
        _, gamma_fin = _chain_gamma(G_chain, t_hat)
    delta_sq += (1.0 - residual) / (max(residual, 1.0 / n) * n) \
        * (1.0 + gamma_fin)
    cov = float(np.sqrt(delta_sq))
    # probability cov -> threshold units via the same order statistics;
    # larger fraction = deeper into the bulk = LOWER threshold
    t_lo = _t_at(min(residual * np.exp(1.96 * cov), 1.0))
    t_hi = _t_at(residual * np.exp(-1.96 * cov))
    levels.append({"threshold": t_hat, "p": residual,
                   "accept_rate": None, "gamma": gamma_fin,
                   "beta": beta})

    out_pop = {"u_final": u, "g_final": g} if return_population else {}
    return {
        **out_pop,
        "threshold": t_hat,
        "ci95_threshold": [t_lo, t_hi if t_hi is not None else t_hat],
        "p_target": p_target,
        "cov": cov,
        "valid_fraction": valid_fraction,
        "n_per_level": n, "p0": p0, "chain_len": chain_len,
        "n_levels": len(levels), "n_sims": n_sims,
        "stalled": stalled, "seed": int(seed),
        "levels": levels,
    }


def pool_subset_quantiles(runs: list) -> dict:
    """Pool K independent :func:`subset_quantile` runs (same
    configuration, different seeds): mean threshold with a Student-t
    between-seed 95% CI — threshold units, no level-independence
    approximation. Companion to :func:`pool_subset_runs`; see its
    docstring for why the empirical spread is the honest error bar."""
    if len(runs) < 2:
        raise ValueError(f"pooling needs >= 2 runs, got {len(runs)}")
    for key in ("p_target", "n_per_level", "p0"):
        vals = {r[key] for r in runs}
        if len(vals) != 1:
            raise ValueError(
                f"runs disagree on {key}: {sorted(vals)} — pool only "
                "identically-configured runs (different seeds)"
            )
    seeds = [r["seed"] for r in runs]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds in pooled runs: {seeds}")

    ts = np.array([r["threshold"] for r in runs], np.float64)
    fin = ts[np.isfinite(ts)]
    K = ts.size
    if fin.size >= 2:
        from scipy.stats import t as _student_t

        mean = float(fin.mean())
        sd = float(fin.std(ddof=1))
        se = sd / np.sqrt(fin.size)
        tq = float(_student_t.ppf(0.975, fin.size - 1))
        ci = [float(mean - tq * se), float(mean + tq * se)]
    else:
        mean = float(fin[0]) if fin.size else float("nan")
        sd = float("nan")
        ci = [float("nan"), float("nan")]
    return {
        "threshold": mean,
        "threshold_sd": sd,
        "ci95_threshold": ci,
        "p_target": runs[0]["p_target"],
        "n_per_level": runs[0]["n_per_level"],
        "p0": runs[0]["p0"],
        "n_runs": K,
        "stalled_runs": int(sum(bool(r["stalled"]) for r in runs)),
        "seeds": [int(s) for s in seeds],
        "n_sims": int(sum(r["n_sims"] for r in runs)),
        "valid_fraction": float(np.mean(
            [r["valid_fraction"] for r in runs])),
        "runs": list(runs),
    }


def pool_subset_runs(runs: list) -> dict:
    """Pool K independent ``subset_simulation`` runs (same configuration,
    different seeds) into one estimate with an EMPIRICAL between-seed CI.

    Why this exists: the single-run ``cov`` treats levels as independent
    (Au & Beck sec. 6.3, a known-optimistic approximation) — measured on
    flight metrics, the realized between-seed spread of log10(p) runs
    1.5-2.2x the reported cov (the JAX package's NOTES.md subset study). The between-seed
    spread needs no independence approximation: it is the honest error
    bar when the decision is tight, at the cost of K runs.

    Pooled outputs:

    - ``probability``: the arithmetic mean of the run probabilities —
      each run's estimator is (nearly) unbiased in p, so the mean is the
      unbiased combiner; zero runs count as 0.
    - ``probability_geomean``: geometric mean over the positive runs —
      the center of the log-space interval (median-flavored; subset
      estimates are approximately lognormal).
    - ``ci95``: Student-t interval on mean log(p) over the positive runs,
      exponentiated (so centered on the geometric mean). Any zero run
      forces the lower bound to 0.0 (the interval is conditional on
      positivity otherwise). Fewer than 2 positive runs: ``[0.0, nan]``.
    - ``cov_empirical``: stderr of mean log(p) over positive runs — the
      pooled estimate's cov on the same (relative) scale as the per-run
      ``cov``. ``inf`` with <2 positive runs.
    - ``cov_reported_mean``: mean of the per-run Au & Beck ``cov``s.
    - ``spread_ratio``: sd(log p, ddof=1) / cov_reported_mean — the
      calibration factor; >1 means the analytic cov under-covers (the
      flight-metric measurements sit at 1.5-2.2). NaN with <2 positive
      runs or when no per-run cov is finite.
    - ``runs``: the input dicts, verbatim (per-level diagnostics intact).

    Raises ``ValueError`` unless all runs share ``threshold``,
    ``n_per_level`` and ``p0`` and there are at least 2 of them.
    """
    if len(runs) < 2:
        raise ValueError(f"pooling needs >= 2 runs, got {len(runs)}")
    for key in ("threshold", "n_per_level", "p0"):
        vals = {r[key] for r in runs}
        if len(vals) != 1:
            raise ValueError(
                f"runs disagree on {key}: {sorted(vals)} — pool only "
                "identically-configured runs (different seeds)"
            )
    seeds = [r["seed"] for r in runs]
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds in pooled runs: {seeds}")

    ps = np.array([r["probability"] for r in runs], np.float64)
    K = ps.size
    pos = ps[ps > 0.0]
    n_zero = int(K - pos.size)
    prob = float(ps.mean())

    covs = np.array([r["cov"] for r in runs], np.float64)
    fin = covs[np.isfinite(covs)]
    cov_reported = float(fin.mean()) if fin.size else float("nan")

    if pos.size >= 2:
        from scipy.stats import t as _student_t

        logs = np.log(pos)
        sd = float(logs.std(ddof=1))
        se = sd / np.sqrt(pos.size)
        tq = float(_student_t.ppf(0.975, pos.size - 1))
        geo = float(np.exp(logs.mean()))
        lo = 0.0 if n_zero else geo * float(np.exp(-tq * se))
        hi = geo * float(np.exp(tq * se))
        cov_emp = float(se)
        spread = (sd / cov_reported
                  if np.isfinite(cov_reported) and cov_reported > 0
                  else float("nan"))
    else:
        geo = float(pos[0]) if pos.size == 1 else 0.0
        lo, hi = 0.0, float("nan")
        cov_emp = float("inf")
        spread = float("nan")

    return {
        "probability": prob,
        "log10_probability": (float(np.log10(prob)) if prob > 0
                              else -float("inf")),
        "probability_geomean": geo,
        "cov": cov_emp,
        "cov_empirical": cov_emp,
        "cov_reported_mean": cov_reported,
        "spread_ratio": float(spread),
        "ci95": [lo, hi],
        "threshold": runs[0]["threshold"],
        "n_per_level": runs[0]["n_per_level"],
        "p0": runs[0]["p0"],
        "n_runs": K,
        "n_zero_runs": n_zero,
        "stalled_runs": int(sum(bool(r["stalled"]) for r in runs)),
        "seeds": [int(s) for s in seeds],
        "n_sims": int(sum(r["n_sims"] for r in runs)),
        "valid_fraction": float(np.mean(
            [r["valid_fraction"] for r in runs])),
        "runs": list(runs),
    }
