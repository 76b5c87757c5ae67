"""Flight-envelope statistics: time-binned population bands over the Monte
Carlo (``erpl_monte_carlo_sim_tpu/mc/envelope.py``).

For each flight quantity (altitude, speed, Mach, angle of attack, stability
margin, drag, ...) the population's count, mean, std, min, max and quantile
band as a function of time since rail exit, over the lanes fed in. The
trajectories are re-created by seed in lane chunks
(``MonteCarloAnalyzer.flight_envelope``) and each chunk is reduced on its
device to per-bin aggregates, so the host receives ``O(n_bins)`` numbers a
chunk whatever its lanes.

Accuracy contract (the JAX package's):
- count, mean, std, min and max per bin are exact over the lanes fed in: the
  device sums a chunk's centred moments, the host merges chunks in float64
  (Chan's update);
- the quantile bands come from a fixed-edge histogram per bin
  (``n_buckets`` buckets over the first chunk's per-bin [min, max],
  widened by ``edge_margin``): one bucket width of value error; mass
  outside the calibrated span clamps into the edge buckets and is reported
  as ``clipped_frac``;
- bands are conditional on the lanes still flying in each bin.

The device reductions are plain PyTorch on the trajectory's device:
``index_add_`` and ``scatter_reduce`` over the bins, where the JAX package
contracts one-hot matrices on the TPU's MXU. Histogram counts are exact
integers either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..engine.component import hist_bucket
from ..ops.math import safe_sqrt
from .stats import PERCENTILES

__all__ = ["EnvelopeConfig", "EnvelopeAccumulator", "DEFAULT_CHANNELS",
           "trajectory_channel", "result_block"]

# Channels a Trajectory serves from its state; the others need
# SimConfig.record_derived (the default) and their channel recorded.
_STATE_CHANNELS = ("altitude", "speed")
DEFAULT_CHANNELS = (
    "altitude", "speed", "mach", "angle_of_attack", "stability_margin", "drag",
)


@dataclasses.dataclass(frozen=True)
class EnvelopeConfig:
    """What to bin and how finely: ``bin_dt`` buckets the time since rail
    exit (``n_bins`` defaults to ``ceil(max_time / bin_dt)``);
    ``record_stride`` overrides the SimConfig's for the re-simulation (None
    keeps it); ``hist_frame_stride`` feeds the histograms every Nth frame
    only (moments, min and max see every frame)."""

    channels: tuple = DEFAULT_CHANNELS
    bin_dt: float = 0.25
    n_bins: Optional[int] = None
    n_buckets: int = 128
    percentiles: tuple = PERCENTILES
    record_stride: Optional[int] = 8
    edge_margin: float = 0.05
    hist_frame_stride: int = 1


def trajectory_channel(traj, name: str) -> torch.Tensor:
    """The ``[B, T]`` values of a named envelope channel."""
    if name == "altitude":
        return traj.position[..., 2]
    if name == "speed" and "speed" not in traj.derived:
        # derived_c's expression and association (safe_sqrt(vx*vx + vy*vy +
        # vz*vz)): a sum over the last axis could round differently and
        # break the frame path's equality with the in-loop envelope
        vx, vy, vz = traj.velocity[..., 0], traj.velocity[..., 1], traj.velocity[..., 2]
        return safe_sqrt(vx * vx + vy * vy + vz * vz)
    if name in traj.derived:
        return traj.derived[name]
    raise KeyError(
        f"channel {name!r} is not recorded; state channels are "
        f"{_STATE_CHANNELS}, derived channels need record_derived=True"
    )


def _bin_ids(t: torch.Tensor, bin_dt: float, n_bins: int) -> torch.Tensor:
    return torch.clamp(torch.floor(t / bin_dt).to(torch.int32), 0, n_bins - 1).to(torch.int64)


def _bin_moments_mc(t, valid, values, bin_dt, n_bins):
    """Per-time-bin count, mean, centred M2, min and max of ``values [C,
    B, T]`` over the valid finite samples of ``t``/``valid [B, T]``: ``[C,
    n_bins]`` each. The M2 is centred on the bin means (raw squares cancel in
    float32 when the std is far below the mean)."""
    n_ch = values.shape[0]
    ids = _bin_ids(t, bin_dt, n_bins).reshape(-1)
    vals = values.reshape(n_ch, -1)
    m = valid.reshape(1, -1) & torch.isfinite(vals)
    mv = m.to(values.dtype)
    v0 = torch.where(m, vals, 0.0)
    zeros = vals.new_zeros((n_ch, n_bins))
    n = zeros.index_add(1, ids, mv)
    mean = zeros.index_add(1, ids, v0) / torch.clamp_min(n, 1.0)
    c = torch.where(m, vals - mean[:, ids], 0.0)
    m2 = zeros.index_add(1, ids, c * c)
    at = ids.expand(n_ch, -1)
    vmin = torch.full_like(zeros, math.inf).scatter_reduce(
        1, at, torch.where(m, vals, math.inf), "amin")
    vmax = torch.full_like(zeros, -math.inf).scatter_reduce(
        1, at, torch.where(m, vals, -math.inf), "amax")
    return n, mean, m2, vmin, vmax


def _bin_histogram_mc(t, valid, values, bin_dt, lo, width, n_bins, n_buckets,
                      frame_stride=1):
    """Fixed-edge per-bin histograms ``[C, n_bins, n_buckets]`` (float32,
    exact integer counts) of ``values [C, B, T]`` and the per-channel count
    of samples outside the edges ``lo``/``width [C, n_bins]``;
    ``frame_stride`` feeds every Nth frame only."""
    if frame_stride > 1:
        t = t[:, ::frame_stride]
        valid = valid[:, ::frame_stride]
        values = values[:, :, ::frame_stride]
    n_ch = values.shape[0]
    ids = _bin_ids(t, bin_dt, n_bins).reshape(-1)
    vals = values.reshape(n_ch, -1)
    m = valid.reshape(1, -1) & torch.isfinite(vals)
    lo = lo.to(vals.dtype)
    width = width.to(vals.dtype)
    frac = (vals - lo[:, ids]) / torch.clamp_min(width[:, ids], 1e-30)
    bucket = hist_bucket(frac, n_buckets)
    base = torch.arange(n_ch, device=vals.device)[:, None] * (n_bins * n_buckets)
    flat = (base + ids * n_buckets + bucket).reshape(-1)
    h = torch.zeros(n_ch * n_bins * n_buckets, dtype=torch.float32,
                    device=vals.device).index_add_(0, flat, m.to(torch.float32).reshape(-1))
    clipped = (m & ((frac < 0.0) | (frac >= n_buckets))).to(torch.float32).sum(1)
    return h.reshape(n_ch, n_bins, n_buckets), clipped


def _bin_histogram(t, valid, value, bin_dt, lo, width, n_bins, n_buckets):
    """One channel's fixed-edge per-bin histogram ``[n_bins, n_buckets]``
    and per-bin clipped counts ``[n_bins]``, as int64 counts (the JAX
    package keeps this segment-sum form for its collective path)."""
    ids = _bin_ids(t, bin_dt, n_bins).reshape(-1)
    v = value.reshape(-1)
    m = valid.reshape(-1) & torch.isfinite(v)
    lo = lo.to(v.dtype)
    width = width.to(v.dtype)
    frac = (v - lo[ids]) / torch.clamp_min(width[ids], 1e-30)
    bucket = hist_bucket(frac, n_buckets)
    ones = m.to(torch.int64)
    h = torch.zeros(n_bins * n_buckets, dtype=torch.int64, device=v.device).index_add_(
        0, ids * n_buckets + bucket, ones)
    out = (m & ((frac < 0.0) | (frac >= n_buckets))).to(torch.int64)
    clip_ct = torch.zeros(n_bins, dtype=torch.int64, device=v.device).index_add_(0, ids, out)
    return h.reshape(n_bins, n_buckets), clip_ct


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EnvelopeAccumulator:
    """Chunk-mergeable time-binned statistics over ``env.channels``. Feed
    batched trajectories with :meth:`add` (or the in-loop aggregates of
    ``engine.batch.simulate_envelope_batch`` with :meth:`add_aggregates`);
    moments, min and max merge exactly on the host in float64, histograms
    add (their edges freeze after the first chunk, which calibrates
    them)."""

    def __init__(self, cfg, env: EnvelopeConfig = EnvelopeConfig()):
        self.env = env
        n_bins = env.n_bins
        if n_bins is None:
            n_bins = int(np.ceil(cfg.max_time / env.bin_dt))
        self.n_bins = int(n_bins)
        self.n_lanes = 0
        z = lambda: np.zeros(self.n_bins, np.float64)  # noqa: E731
        self._n = {c: z() for c in env.channels}
        self._mean = {c: z() for c in env.channels}
        self._m2 = {c: z() for c in env.channels}
        self._min = {c: np.full(self.n_bins, np.inf) for c in env.channels}
        self._max = {c: np.full(self.n_bins, -np.inf) for c in env.channels}
        self._edges = None  # (lo, width): float32 [C, n_bins] tensors, frozen
        self._hist = {c: np.zeros((self.n_bins, env.n_buckets), np.float64)
                      for c in env.channels}
        self._clipped = {c: 0.0 for c in env.channels}

    def add(self, traj) -> None:
        """Fold in one batched ``Trajectory`` (``[B, T, ...]`` leaves): the
        moments and the histograms reduced on its device, one readback
        each."""
        env = self.env
        values = torch.stack([trajectory_channel(traj, ch) for ch in env.channels])
        n, mean, m2, vmin, vmax = (_host(x) for x in _bin_moments_mc(
            traj.time, traj.valid, values, env.bin_dt, self.n_bins))
        for i, ch in enumerate(env.channels):
            self._merge_moments(ch, n[i].astype(np.float64), mean[i].astype(np.float64),
                                m2[i].astype(np.float64))
            self._min[ch] = np.minimum(self._min[ch], vmin[i])
            self._max[ch] = np.maximum(self._max[ch], vmax[i])
        if self._edges is None:
            self._calibrate(vmin, vmax, values.device)
        lo, width = self._edges
        h, clip_ct = (_host(x) for x in _bin_histogram_mc(
            traj.time, traj.valid, values, env.bin_dt, lo.to(values.device),
            width.to(values.device), self.n_bins, env.n_buckets,
            frame_stride=max(1, env.hist_frame_stride)))
        for i, ch in enumerate(env.channels):
            self._hist[ch] += h[i].astype(np.float64)
            self._clipped[ch] += float(clip_ct[i])
        self.n_lanes += int(traj.valid.shape[0])

    def add_aggregates(self, agg, n_lanes: int) -> None:
        """Fold in one chunk's in-loop aggregates
        (``engine.batch.simulate_envelope_batch``): the same host merge as
        :meth:`add`. The edges must be calibrated already: feed one
        frame-based chunk (:meth:`add`) first."""
        if self._edges is None:
            raise RuntimeError(
                "histogram edges not calibrated: feed one frame-based "
                "chunk via add() before aggregate chunks"
            )
        a = {k: _host(v) for k, v in agg.items()}
        for i, ch in enumerate(self.env.channels):
            self._merge_moments(ch, np.asarray(a["n"][i], np.float64),
                                np.asarray(a["mean"][i], np.float64),
                                np.asarray(a["m2"][i], np.float64))
            self._min[ch] = np.minimum(self._min[ch], a["min"][i])
            self._max[ch] = np.maximum(self._max[ch], a["max"][i])
            self._hist[ch] += np.asarray(a["hist"][i], np.float64)
            self._clipped[ch] += float(a["clipped"][i])
        self.n_lanes += int(n_lanes)

    def _calibrate(self, vmin, vmax, device=None) -> None:
        """Freeze per-bin bucket edges from the first chunk's ``[C, n_bins]``
        min and max, widened by ``edge_margin`` (a bin with no sample gets a
        unit span; its histogram stays empty). Float32, as the JAX package
        keeps them."""
        env = self.env
        vmin = np.where(np.isfinite(vmin), vmin, 0.0)
        vmax = np.where(np.isfinite(vmax), vmax, 1.0)
        span = np.maximum(vmax - vmin, 1e-12)
        lo = vmin - env.edge_margin * span
        hi = vmax + env.edge_margin * span
        width = (hi - lo) / env.n_buckets
        self._edges = (torch.as_tensor(lo, dtype=torch.float32, device=device),
                       torch.as_tensor(width, dtype=torch.float32, device=device))

    def _merge_moments(self, ch, n_b, mean_b, m2_b) -> None:
        n_a = self._n[ch]
        tot = n_a + n_b
        safe = np.maximum(tot, 1.0)
        delta = mean_b - self._mean[ch]
        self._m2[ch] += m2_b + delta * delta * n_a * n_b / safe
        self._mean[ch] += delta * n_b / safe
        self._n[ch] = tot

    def result(self) -> dict:
        """The envelope block, JSON-ready, per channel: ``n``, ``mean``,
        ``std``, ``min``, ``max`` per bin (NaN where a bin saw no sample),
        ``percentiles`` (the histogram's bands, one bucket width of error)
        and ``clipped_frac``."""
        env = self.env
        per_channel = {}
        for i, ch in enumerate(env.channels):
            lo = (_host(self._edges[0][i]).astype(np.float64) if self._edges
                  else np.zeros(self.n_bins))
            width = (_host(self._edges[1][i]).astype(np.float64) if self._edges
                     else np.ones(self.n_bins))
            per_channel[ch] = {
                "n": self._n[ch], "mean": self._mean[ch], "m2": self._m2[ch],
                "min": self._min[ch], "max": self._max[ch], "hist": self._hist[ch],
                "lo": lo, "width": width, "clipped": self._clipped[ch],
            }
        return result_block(env, self.n_bins, per_channel, self.n_lanes)


def _hist_quantiles(hist, lo, width, n, vmin, vmax, qs) -> np.ndarray:
    """``[Q, n_bins]`` histogram quantiles (bucket-centre mass midpoints,
    linear interpolation), clamped inside the exact min/max envelope."""
    qs = np.asarray(qs, np.float64)
    n_bins, n_buckets = hist.shape
    out = np.full((qs.size, n_bins), np.nan)
    for b in range(n_bins):
        h = hist[b]
        tot = h.sum()
        if tot <= 0:
            continue
        centers = lo[b] + (np.arange(n_buckets) + 0.5) * width[b]
        mid = np.cumsum(h) - 0.5 * h
        targets = qs / 100.0 * (tot - 1.0) + 0.5
        out[:, b] = np.interp(targets, mid, centers)
    vmin = np.where(n > 0, vmin, np.nan)
    vmax = np.where(n > 0, vmax, np.nan)
    return np.clip(out, vmin[None, :], vmax[None, :])


def result_block(env: EnvelopeConfig, n_bins: int, per_channel: dict, n_lanes: int) -> dict:
    """The JSON-ready envelope block from raw per-bin aggregates:
    ``per_channel[ch]`` holds float64 ``n/mean/m2/min/max [n_bins]``,
    ``hist [n_bins, n_buckets]``, the edges ``lo``/``width [n_bins]`` and the
    scalar ``clipped`` count. ``clipped_frac`` is over the histogram's own
    sample count (under ``hist_frame_stride`` a subset of the frames)."""
    centers = (np.arange(n_bins) + 0.5) * env.bin_dt
    out = {
        "bin_dt": env.bin_dt,
        "time": [float(x) for x in centers],
        "n_lanes": n_lanes,
        "percentile_qs": [float(q) for q in env.percentiles],
        "channels": {},
    }
    for ch, blk in per_channel.items():
        n = np.asarray(blk["n"], np.float64)
        empty = n == 0
        mean = np.where(empty, np.nan, blk["mean"])
        std = np.where(empty, np.nan, np.sqrt(np.asarray(blk["m2"]) / np.maximum(n, 1.0)))
        vmin = np.where(empty, np.nan, blk["min"])
        vmax = np.where(empty, np.nan, blk["max"])
        pct = _hist_quantiles(
            np.asarray(blk["hist"], np.float64), np.asarray(blk["lo"], np.float64),
            np.asarray(blk["width"], np.float64), n, np.asarray(blk["min"], np.float64),
            np.asarray(blk["max"], np.float64), env.percentiles,
        )
        hist_total = float(np.asarray(blk["hist"], np.float64).sum())
        out["channels"][ch] = {
            "n": [int(x) for x in n],
            "mean": [float(x) for x in mean],
            "std": [float(x) for x in std],
            "min": [float(x) for x in vmin],
            "max": [float(x) for x in vmax],
            "percentiles": {
                f"{q:g}": [float(x) for x in pct[i]]
                for i, q in enumerate(env.percentiles)
            },
            "clipped_frac": (float(blk["clipped"]) / hist_total if hist_total else 0.0),
        }
    return out
