"""Sharded Monte Carlo flights and collective statistics
(``erpl_monte_carlo_sim_tpu/parallel/sharded.py``).

Each function takes this rank's shard of the lanes (a ``parallel.mesh``
lane block; every rank's shard of the same length) and returns the global
result, the same on every rank. With a mesh of one rank each is the
single-device computation. The flights are embarrassingly parallel: a
rank flies its lanes through ``engine.batch.simulate_summary_batch`` (on a
card the CUDA flight kernel, one thread a lane, no cross-lane arithmetic),
and only the reductions talk: ``torch.distributed`` collectives (the JAX
package's ``psum``/``pmin``/``pmax``/``all_gather`` in ``shard_map``)
around plain tensor ops on the rank's device.

- ``collective_stats``: the count first, then a two-pass variance and the
  extremes; percentiles exactly (one gather of the metric and a sort, at
  integer order statistics from ``mc.stats.order_stat_ranks``) up to
  ``exact_percentile_threshold`` lanes, past it from a two-pass collective
  histogram (``O(n_bins)`` bytes a rank).
- ``collective_footprint_moments`` / ``collective_footprint``,
  ``collective_cv_moments`` (float64, as ``mc.cv.cv_slab_moments``): centred
  moments, a few scalars or a ``[d, d]`` matrix a rank.
- ``collective_tail_extremes`` / ``collective_tail_carry`` /
  ``collective_tail_reservoir``: exact top-k and bottom-k order statistics
  from each rank's own top-k (a superset of the global one).
- ``collective_envelope``: per-time-bin bands of a lane-sharded trajectory.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..engine.batch import simulate_summary_batch
from ..engine.config import SimConfig
from ..engine.simulate import simulate_batch_chunked
from ..mc.stats import PERCENTILES, order_stat_ranks
from ..utils.tree import tree_map
from .mesh import LaneMesh, all_gather_lanes, all_reduce

__all__ = ["run_sharded_summaries", "gather_lanes", "collective_stats",
           "collective_footprint", "collective_footprint_moments", "collective_cv_moments",
           "collective_tail_extremes", "collective_tail_reservoir", "collective_tail_carry",
           "tail_reservoir_from_carry", "collective_envelope"]

_MIN = dist.ReduceOp.MIN


def _leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def gather_lanes(tree, mesh: LaneMesh):
    """Every rank's lanes of a batched dataclass (``[b, ...]`` leaves, e.g.
    a ``FlightSummary``) as the global batch in rank order, on every rank:
    the leaves packed into one ``[b, F]`` tensor per dtype, one gather each."""
    if mesh.group is None:
        return tree
    leaves = _leaves(tree)
    groups = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    out = [None] * len(leaves)
    for dtype, idx in groups.items():
        flat = torch.cat([leaves[i].reshape(leaves[i].shape[0], -1) for i in idx], dim=1)
        full = all_gather_lanes(flat, mesh)
        col = 0
        for i in idx:
            w = int(np.prod(leaves[i].shape[1:], dtype=np.int64))
            out[i] = full[:, col:col + w].reshape(-1, *leaves[i].shape[1:]).contiguous()
            col += w
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def run_sharded_summaries(scene_b, ic_b, axes, cfg: SimConfig, mesh: LaneMesh,
                          batch_size: int, chunk_steps=None):
    """Fly this rank's lanes (``scene_b``/``ic_b``: its shard, leading axis
    ``batch_size // mesh.size`` on batched leaves) and return the global
    ``FlightSummary`` of ``batch_size`` lanes, the same on every rank. The
    flights need no communication; the summaries are gathered once.
    ``axes`` is unused (the JAX signature's). With ``chunk_steps`` the
    rank's lanes fly ``simulate_batch_chunked``, the rank's chunks ending
    when its own lanes are done; a masked step leaves a stopped lane as it
    is, so the gathered summary is the no-mesh run's."""
    del axes
    if batch_size % mesh.size or int(ic_b.position.shape[0]) * mesh.size != batch_size:
        raise ValueError(f"a shard of {int(ic_b.position.shape[0])} lanes on each of "
                         f"{mesh.size} ranks is not a batch of {batch_size}")
    if chunk_steps is not None:
        return gather_lanes(simulate_batch_chunked(scene_b, ic_b, cfg, chunk_steps=chunk_steps),
                            mesh)
    return gather_lanes(simulate_summary_batch(scene_b, ic_b, cfg), mesh)


def _even_counts(n_local: int, extra: list, mesh: LaneMesh) -> np.ndarray:
    """``[size, 1 + len(extra)]`` host array of every rank's shard length and
    ``extra`` integer counts (one small gather: the count goes first).
    Shards of different lengths raise on every rank."""
    row = torch.tensor([[n_local, *extra]], dtype=torch.int64, device=mesh.device)
    rows = all_gather_lanes(row, mesh).cpu().numpy()
    if (rows[:, 0] != rows[0, 0]).any():
        raise ValueError(f"a batch of {int(rows[:, 0].sum())} lanes cannot shard evenly over "
                         f"{mesh.size} ranks (shards of {rows[:, 0].tolist()} lanes)")
    return rows


def _histogram_values_at_ranks(v, m, ranks, vmin, vmax, n_bins: int, mesh: LaneMesh):
    """Values at the (continuous, 0-indexed) ``ranks`` of the masked data
    without gathering it: a global ``n_bins`` histogram (one reduction of
    ``[n_bins]``) finds each rank's bucket, a refined histogram inside each
    bucket (one reduction of ``[T, n_bins]``) narrows it to
    ``range / n_bins**2``, with the mass taken as uniform in the final
    bucket. Counts are exact integers; the rank arithmetic is float64."""
    dtype = v.dtype
    span = torch.clamp_min(vmax - vmin, 1e-30)
    w = span / n_bins

    def local_hist(lo, width):
        # [T, n_bins] histogram of the shard's valid values in [lo, lo + width * n_bins)
        idx = ((v[None, :] - lo[:, None]) / width[:, None])
        idx = torch.nan_to_num(idx, nan=0.0).clamp(0, n_bins - 1).to(torch.int64)
        inside = m[None, :] & (v[None, :] >= lo[:, None]) & (
            v[None, :] < lo[:, None] + width[:, None] * n_bins)
        flat = idx + torch.arange(lo.shape[0], device=v.device)[:, None] * n_bins
        h = torch.zeros(lo.shape[0] * n_bins, dtype=torch.int64, device=v.device)
        return h.index_add_(0, flat.reshape(-1), inside.reshape(-1).to(torch.int64)).reshape(
            lo.shape[0], n_bins)

    hist = all_reduce(local_hist(vmin[None], w[None])[0], mesh)
    cdf = torch.cumsum(hist, 0).to(torch.float64)
    ranks = ranks.to(torch.float64)
    # a rank sits in the first bucket whose cumulative mass exceeds it
    bucket = torch.searchsorted(cdf, ranks, right=True).clamp(0, n_bins - 1)
    below = torch.where(bucket > 0, cdf[torch.clamp_min(bucket - 1, 0)], 0.0)
    lo2 = vmin + bucket.to(dtype) * w
    w2 = w / n_bins
    hist2 = all_reduce(local_hist(lo2, w2.expand(lo2.shape)), mesh)
    cdf2 = torch.cumsum(hist2, 1).to(torch.float64)
    within = ranks - below
    b2 = torch.searchsorted(cdf2, within[:, None], right=True)[:, 0].clamp(0, n_bins - 1)
    below2 = torch.where(b2 > 0, cdf2.gather(1, torch.clamp_min(b2 - 1, 0)[:, None])[:, 0],
                         0.0)
    in_bucket = hist2.gather(1, b2[:, None])[:, 0].to(torch.float64)
    frac = torch.where(in_bucket > 0, (within - below2) / torch.clamp_min(in_bucket, 1.0), 0.5)
    est = lo2 + (b2.to(dtype) + frac.clamp(0.0, 1.0).to(dtype)) * w2
    return torch.minimum(torch.maximum(est, vmin), vmax)


def collective_stats(values: torch.Tensor, mask, mesh: LaneMesh,
                     exact_percentile_threshold: int = 2_097_152,
                     percentile_bins: int = 4096) -> dict:
    """Masked mean, std, min, max, count, percentiles and their
    order-statistic intervals over this rank's shard ``values [b]`` (and
    ``mask``; None means every lane; non-finite values never count), the
    global result on every rank (JAX ``collective_stats``).

    The valid count goes first (one gather of two integers a rank), so the
    binomial order-statistic ranks of ``percentile_ci`` come from
    ``order_stat_ranks`` on the host; then the masked sum and the extremes
    (two reductions), then the centred sum of squares about the global mean
    (a two-pass variance, which keeps a float32 std with a large mean). Up
    to ``exact_percentile_threshold`` global lanes the percentiles are exact:
    one gather of the metric, a sort, and the values at integer order
    statistics (``np.percentile``'s linear rule), so the interval equals
    ``mc.stats.percentile_ci`` bit for bit; past it, the two-pass collective
    histogram of ``percentile_bins`` bins (``range / bins**2`` of error).
    Below 2 valid lanes the percentiles and intervals are NaN."""
    v = values
    m = torch.ones_like(v, dtype=torch.bool) if mask is None else mask.to(v.device)
    m = m & torch.isfinite(v)
    rows = _even_counts(int(v.shape[0]), [int(m.sum())], mesh)
    n, n_valid = int(rows[:, 0].sum()), int(rows[:, 1].sum())
    n_eff = max(n_valid, 1)
    qs = np.asarray(PERCENTILES, np.float64)
    k = qs.size
    pct_ranks = qs / 100.0 * max(n_valid - 1, 0)
    lo_ranks = np.empty(k)
    hi_ranks = np.empty(k)
    for i, q in enumerate(qs):
        lo, hi = order_stat_ranks(n_eff, q / 100.0)
        lo_ranks[i] = max(lo, 1) - 1
        hi_ranks[i] = min(hi, n_eff) - 1

    big = torch.tensor(math.inf, dtype=v.dtype, device=v.device)
    cnt = torch.tensor(n_valid, dtype=torch.int64, device=v.device)
    s1 = all_reduce(torch.sum(torch.where(m, v, 0.0)), mesh)
    ext = all_reduce(torch.stack([torch.min(torch.where(m, v, big)),
                                  -torch.max(torch.where(m, v, -big))]), mesh, _MIN)
    vmin, vmax = ext[0], -ext[1]
    denom = torch.clamp_min(cnt, 1)
    mean = s1 / denom
    d = torch.where(m, v - mean, 0.0)
    var = torch.clamp_min(all_reduce(torch.sum(d * d), mesh) / denom, 0.0)

    if n > exact_percentile_threshold:
        ranks = torch.as_tensor(np.concatenate([pct_ranks, lo_ranks, hi_ranks]),
                                device=v.device)
        vals = _histogram_values_at_ranks(v, m, ranks, vmin, vmax, percentile_bins, mesh)
    else:
        # integer order statistics ride as int64 (exact past 2**24 lanes);
        # only the interpolation fraction is a float
        idx = torch.as_tensor(np.concatenate([np.floor(pct_ranks), np.ceil(pct_ranks),
                                              lo_ranks, hi_ranks]).astype(np.int64),
                              device=v.device)
        frac = torch.as_tensor(pct_ranks - np.floor(pct_ranks), dtype=v.dtype, device=v.device)
        sorted_v = torch.sort(all_gather_lanes(torch.where(m, v, big), mesh)).values
        picked = sorted_v[idx]
        p_lo, p_hi = picked[:k], picked[k:2 * k]
        vals = torch.cat([p_lo + (p_hi - p_lo) * frac, picked[2 * k:]])
    pct, ci = vals[:k], torch.stack([vals[k:2 * k], vals[2 * k:]], dim=1)
    if n_valid < 2:
        pct = torch.full_like(pct, math.nan)
        ci = torch.full_like(ci, math.nan)
    return {"mean": mean, "std": torch.sqrt(var), "min": vmin, "max": vmax,
            "percentiles": pct, "percentile_ci": ci, "n": cnt}


def collective_footprint_moments(landing: torch.Tensor, mask, mesh: LaneMesh) -> tuple:
    """The ``(n, mean_x, mean_y, M2x, M2y, Cxy)`` of this rank's shard of
    landing points ``[b, 2+]`` over every rank, centred on the global mean
    (two passes), for ``mc.stats.FootprintAccumulator.add``: the arithmetic
    of ``MonteCarloAnalyzer._footprint_moments`` with each sum reduced over
    the ranks, so one rank gives its bits."""
    x, y = landing[:, 0], landing[:, 1]
    m = torch.ones_like(x, dtype=torch.bool) if mask is None else mask.to(x.device)
    m = m & torch.isfinite(x) & torch.isfinite(y)
    n = all_reduce(torch.sum(m), mesh)
    nf = torch.clamp_min(n, 1).to(x.dtype)
    s = all_reduce(torch.stack([torch.sum(torch.where(m, x, 0.0)),
                                torch.sum(torch.where(m, y, 0.0))]), mesh)
    mx, my = s[0] / nf, s[1] / nf
    dx = torch.where(m, x - mx, 0.0)
    dy = torch.where(m, y - my, 0.0)
    c = all_reduce(torch.stack([torch.sum(dx * dx), torch.sum(dy * dy), torch.sum(dx * dy)]),
                   mesh)
    out = torch.stack([n.to(torch.float64)] + [t.to(torch.float64) for t in (mx, my, *c)])
    n, *moments = out.cpu().tolist()
    return (int(n), *moments)


def collective_footprint(landing: torch.Tensor, mask, mesh: LaneMesh) -> dict:
    """The landing footprint of a lane-sharded batch (JAX
    ``collective_footprint``): ``collective_footprint_moments`` into a
    ``FootprintAccumulator`` (``cep_method="gaussian"``: per-lane miss
    distances are never gathered). Slab loops accumulate the moments
    instead and build the block once."""
    from ..mc.stats import FootprintAccumulator

    acc = FootprintAccumulator()
    acc.add(*collective_footprint_moments(landing, mask, mesh))
    return acc.footprint()


def collective_cv_moments(sample, summary, valid, mask, params, motor, mesh: LaneMesh,
                          wind_ctrl=None) -> tuple:
    """Control-variate moments of this rank's shard over every rank (JAX
    ``collective_cv_moments``): ``mc.cv.cv_slab_moments``' float64
    ``(n, mean_z, mean_t, Szz, Szt, Stt)`` for ``mc.cv.CVMoments.add``, with
    the sums and the centred ``[d, d]`` products reduced over the ranks
    (centred on the global means). ``wind_ctrl``'s per-lane leaves
    (``wind``, ``ws``, ``wd``) are the shard's, the rest shared. ``mask``
    (None: every lane) leaves the padding lanes out."""
    from ..mc.cv import _controls, _targets

    z = _controls(sample, params, motor, wind_ctrl)
    t = _targets(summary, valid, z.dtype)
    include = torch.ones(z.shape[0], dtype=torch.bool, device=z.device) if mask is None \
        else mask.to(z.device)
    inc = include[:, None]
    f64 = torch.float64
    z = torch.where(inc, z.to(f64), 0.0)
    t = torch.where(inc, t.to(f64), 0.0)
    n = all_reduce(include.sum(), mesh)
    nf = torch.clamp_min(n, 1).to(f64)
    sums = all_reduce(torch.cat([z.sum(dim=0), t.sum(dim=0)]), mesh)
    mz, mt = sums[:z.shape[1]] / nf, sums[z.shape[1]:] / nf
    zc = torch.where(inc, z - mz, 0.0)
    tc = torch.where(inc, t - mt, 0.0)
    d, tt = z.shape[1], t.shape[1]
    prods = all_reduce(torch.cat([(zc.T @ zc).reshape(-1), (zc.T @ tc).reshape(-1),
                                  (tc.T @ tc).reshape(-1)]), mesh)
    szz = prods[:d * d].reshape(d, d)
    szt = prods[d * d:d * d + d * tt].reshape(d, tt)
    stt = prods[d * d + d * tt:].reshape(tt, tt)
    return tuple(x.cpu().numpy() for x in (n, mz, mt, szz, szt, stt))


def _tail_front(values, mask, mesh: LaneMesh, k: int):
    """The tail reductions' common front: the valid mask and ``k_eff = min(k,
    shard)``; an empty or uneven batch raises on every rank."""
    rows = _even_counts(int(values.shape[0]), [], mesh)
    n = int(rows[:, 0].sum())
    if n == 0:
        raise ValueError(f"a batch of {n} lanes cannot shard over {mesh.size} ranks")
    m = torch.ones_like(values, dtype=torch.bool) if mask is None else mask.to(values.device)
    return m & torch.isfinite(values), min(int(k), int(values.shape[0]))


def _shard_extremes(v, m, k_eff: int, mesh: LaneMesh):
    """(global valid count, every rank's top-``k_eff`` and bottom-``k_eff``
    candidates gathered); invalid lanes pad with -inf (top) and +inf
    (bottom)."""
    big = torch.tensor(math.inf, dtype=v.dtype, device=v.device)
    cnt = all_reduce(torch.sum(m), mesh)
    top = torch.topk(torch.where(m, v, -big), k_eff).values
    bot = -torch.topk(torch.where(m, -v, -big), k_eff).values
    both = all_gather_lanes(torch.stack([top, bot], dim=1), mesh)
    return cnt, both[:, 0].contiguous(), both[:, 1].contiguous()


def collective_tail_extremes(values: torch.Tensor, mask, mesh: LaneMesh,
                             k: int = 4096) -> tuple:
    """``(n_valid, hi_candidates, lo_candidates)`` over every rank (JAX
    ``collective_tail_extremes``): each rank's top-k' and bottom-k' (k' =
    min(k, shard)) gathered, a superset of the global top-k and bottom-k
    (a lane of the global top-k is in its own rank's top-k'). Masked and
    non-finite lanes pad with -inf / +inf; callers drop them. An empty
    batch, or shards of different lengths, raise."""
    m, k_eff = _tail_front(values, mask, mesh, k)
    return _shard_extremes(values, m, k_eff, mesh)


def collective_tail_carry(values: torch.Tensor, mask, mesh: LaneMesh, carry=None,
                          k: int = 4096) -> tuple:
    """Streaming top-k and bottom-k across slabs, kept on the device (JAX
    ``collective_tail_carry``): this slab's collective candidates merged
    into the ``(hi[k], lo[k])`` carry (``None`` starts a run, padded with
    -inf / +inf), the same on every rank, with no per-slab readback.
    Returns ``(n_valid, (hi, lo))``, ``n_valid`` a device scalar; finish
    once with ``tail_reservoir_from_carry``."""
    m, k_eff = _tail_front(values, mask, mesh, k)
    if carry is None:
        big = torch.tensor(math.inf, dtype=values.dtype, device=values.device)
        carry = (torch.full((k,), -math.inf, dtype=values.dtype, device=values.device),
                 big.expand(k).clone())
    cnt, hi, lo = _shard_extremes(values, m, k_eff, mesh)
    new_hi = torch.topk(torch.cat([carry[0], hi]), k).values
    new_lo = -torch.topk(torch.cat([-carry[1], -lo]), k).values
    return cnt, (new_hi, new_lo)


def tail_reservoir_from_carry(carry, n: int):
    """A ``collective_tail_carry`` state as a ``mc.tail.TailReservoir``, in
    one readback at the end of a run (the padding dropped)."""
    from ..mc.tail import TailReservoir

    hi = carry[0].detach().cpu().numpy().astype(np.float64)
    lo = carry[1].detach().cpu().numpy().astype(np.float64)
    r = TailReservoir(hi.size)
    r.hi = np.sort(hi[np.isfinite(hi)])
    r.lo = np.sort(lo[np.isfinite(lo)])
    r.n = int(n)
    return r


def collective_tail_reservoir(values: torch.Tensor, mask, mesh: LaneMesh, k: int = 4096):
    """The ``mc.tail.TailReservoir`` of a lane-sharded metric (JAX
    ``collective_tail_reservoir``): exactly a single device's top-k and
    bottom-k of the same valid lanes, each side built from its own
    candidates (a lane in a rank's top and bottom is counted once)."""
    from ..mc.tail import TailReservoir

    cnt, hi, lo = collective_tail_extremes(values, mask, mesh, k)
    hi = hi.detach().cpu().numpy().astype(np.float64)
    lo = lo.detach().cpu().numpy().astype(np.float64)
    r = TailReservoir(k)
    fh = np.sort(hi[np.isfinite(hi)])
    fl = np.sort(lo[np.isfinite(lo)])
    r.hi = fh[-min(k, fh.size):]
    r.lo = fl[:min(k, fl.size)]
    r.n = int(cnt)
    return r


def collective_envelope(traj, mesh: LaneMesh, env=None, n_bins=None,
                        max_time: float = 300.0) -> dict:
    """The flight envelope of this rank's shard of a batched ``Trajectory``
    (``[b, T, ...]``) over every rank (JAX ``collective_envelope``): per
    time bin the integer count, the sum, the M2 centred on the global bin
    mean (two passes), the extremes, and the histogram bucketed on edges
    from the exact global per-bin extremes (nothing clips), each one
    reduction of ``[n_bins]`` or ``[n_bins, n_buckets]``. Returns the
    JSON-ready block of ``mc.envelope.result_block``, the schema of
    ``EnvelopeAccumulator.result()``."""
    from ..mc.envelope import (EnvelopeConfig, _bin_histogram, _bin_ids, result_block,
                               trajectory_channel)

    if env is None:
        env = EnvelopeConfig()
    if n_bins is None:
        n_bins = env.n_bins
    if n_bins is None:
        n_bins = int(math.ceil(max_time / env.bin_dt))
    n_lanes = int(_even_counts(int(traj.valid.shape[0]), [], mesh)[:, 0].sum())
    t, valid = traj.time, traj.valid
    agg = {}
    for ch in env.channels:
        value = trajectory_channel(traj, ch)
        m = (valid & torch.isfinite(value)).reshape(-1)
        ids = torch.where(m, _bin_ids(t, env.bin_dt, n_bins).reshape(-1), n_bins)
        v = value.reshape(-1)
        nseg = n_bins + 1
        n_int = all_reduce(torch.zeros(nseg, dtype=torch.int64, device=v.device).index_add_(
            0, ids, m.to(torch.int64))[:n_bins], mesh)
        s = all_reduce(torch.zeros(nseg, dtype=v.dtype, device=v.device).index_add_(
            0, ids, torch.where(m, v, 0.0))[:n_bins], mesh)
        n = n_int.to(v.dtype)
        mean = s / torch.clamp_min(n, 1.0)
        c = v - torch.cat([mean, mean.new_zeros(1)])[ids]
        m2 = all_reduce(torch.zeros(nseg, dtype=v.dtype, device=v.device).index_add_(
            0, ids, torch.where(m, c * c, 0.0))[:n_bins], mesh)
        ext = torch.full((2, nseg), math.inf, dtype=v.dtype, device=v.device)
        ext[0].scatter_reduce_(0, ids, torch.where(m, v, math.inf), "amin")
        ext[1].scatter_reduce_(0, ids, torch.where(m, -v, math.inf), "amin")
        ext = all_reduce(ext[:, :n_bins].contiguous(), mesh, _MIN)
        vmin, vmax = ext[0], -ext[1]
        # the edges from the exact global extremes, float32 as the
        # accumulator's calibration keeps them
        fin_lo = torch.where(torch.isfinite(vmin), vmin, 0.0)
        fin_hi = torch.where(torch.isfinite(vmax), vmax, 1.0)
        span = torch.clamp_min(fin_hi - fin_lo, 1e-12)
        lo64 = fin_lo - env.edge_margin * span
        hi64 = fin_hi + env.edge_margin * span
        lo = lo64.to(torch.float32)
        width = ((hi64 - lo64) / env.n_buckets).to(torch.float32)
        h, clip = _bin_histogram(t, valid, value, env.bin_dt, lo, width, n_bins,
                                 env.n_buckets)
        hc = all_reduce(torch.cat([h.reshape(-1), clip.sum().reshape(1)]), mesh)
        agg[ch] = {"n": n, "mean": mean, "m2": m2, "min": vmin, "max": vmax,
                   "hist": hc[:-1].reshape(n_bins, env.n_buckets), "lo": lo,
                   "width": width, "clipped": hc[-1]}
    host = {ch: {k: x.detach().cpu().numpy() for k, x in blk.items()}
            for ch, blk in agg.items()}
    return result_block(env, n_bins, host, n_lanes)
