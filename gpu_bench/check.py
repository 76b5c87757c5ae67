"""The comparisons that decide ``correct``: the numbers a cell's run
compares with the plain reference (``reference/``), each held to the limit
in ``limits/<cell>.json``.

- ``draw_gap``: the drawn lanes, every leaf of every lane, as the largest
  difference over the leaf's largest magnitude.
- ``lanes_off``: the share of the checked lanes whose flight leaves any of
  the float32 bars (``RTOL``, ``ATOL``; a vector against the lane's norm, the
  range against the landing point's) or whose integer leaves (steps, chute,
  divergence) differ.
- ``lane_gap``: the widest relative gap of a checked lane's float leaves
  (against ``max(scale, 1)`` in the leaf's unit: metres, seconds, m/s).
- ``stats_gap``: the widest relative gap (against ``max(|reference|, 1)``)
  of the analysis's statistics, worked out again from its own lanes.
- ``exact_off``: how many of the quantities that must agree exactly
  (counts, the valid mask and reasons, record ids and values, the verdict)
  do not.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["CONTROL", "RTOL", "ATOL", "draw_gap", "lane_compare", "numbers_gap", "exact_off",
           "check_lanes", "FLOAT_LANE_FIELDS", "INT_LANE_FIELDS"]

# the control's precision: the nearest below the configuration's (its
# arithmetic is elementwise, no matrix product that TF32 would take)
CONTROL = {"float64": "float32", "float32": "bfloat16"}
# the float32 bars at which the port's flight kernel is held to its plain
# version lane by lane
RTOL, ATOL = 2e-5, 1e-6
FLOAT_LANE_FIELDS = ("apogee_altitude", "apogee_time", "range", "flight_time", "max_speed",
                     "landing_position", "final_velocity", "rail_exit_time", "rail_exit_speed")
INT_LANE_FIELDS = ("parachute_deployed", "diverged", "n_steps")


def _both_nan(a, b):
    return np.isnan(a) & np.isnan(b)


def draw_gap(prog: dict, ref: dict) -> float:
    """The largest difference of a drawn leaf over the leaf's largest
    magnitude, over every float leaf and lane; a missing leaf or another
    shape reads infinite."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or np.shape(p) != np.shape(r):
            return math.inf
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        if r.size == 0:
            continue
        scale = max(float(np.nanmax(np.abs(r))), np.finfo(np.float64).tiny)
        d = np.abs(p - r)
        d[_both_nan(p, r)] = 0.0
        d[np.isnan(d)] = math.inf
        worst = max(worst, float(d.max()) / scale)
    return worst


def _lane_scales(ref: dict) -> dict:
    """Each float leaf's per-lane scale: its magnitude, a vector's norm,
    the range's landing point's norm."""
    land = np.linalg.norm(np.asarray(ref["landing_position"], np.float64), axis=-1) \
        if "landing_position" in ref else None
    out = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        if k in INT_LANE_FIELDS:
            continue
        if r.ndim == 2:
            out[k] = np.broadcast_to(np.linalg.norm(r, axis=-1, keepdims=True), r.shape)
        elif k == "range" and land is not None:
            out[k] = land
        else:
            out[k] = np.abs(r)
    return out


def lane_compare(prog: dict, ref: dict) -> tuple:
    """``(lanes_off, lane_gap)`` of the checked lanes: the share of lanes
    off the bars, and the widest relative gap of a float leaf."""
    n = len(next(iter(ref.values())))
    off = np.zeros(n, bool)
    gap = 0.0
    scales = _lane_scales(ref)
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or np.shape(p) != np.shape(r):
            return 1.0, math.inf
        p, r = np.asarray(p), np.asarray(r)
        if k in INT_LANE_FIELDS:
            off |= p != r
            continue
        p, r = p.astype(np.float64), r.astype(np.float64)
        d = np.abs(p - r)
        same = _both_nan(p, r)
        d[same] = 0.0
        d[np.isnan(d)] = math.inf
        s = scales[k]
        bad = d > ATOL + RTOL * s
        off |= bad.reshape(n, -1).any(axis=1)
        rel = d / np.maximum(np.nan_to_num(s, nan=1.0), 1.0)
        gap = max(gap, float(rel.max()) if rel.size else 0.0)
    return float(off.mean()) if n else 0.0, gap


def numbers_gap(prog: dict, ref: dict) -> float:
    """The widest relative gap (against ``max(|reference|, 1)``) of the
    named numbers; a missing one reads infinite, NaN on both sides 0."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None:
            return math.inf
        p, r = float(p), float(r)
        if math.isnan(p) and math.isnan(r):
            continue
        d = abs(p - r)
        if math.isnan(d):
            return math.inf
        worst = max(worst, d / max(abs(r), 1.0))
    return worst


def exact_off(prog: dict, ref: dict) -> int:
    """How many values of the exact quantities differ (a missing or
    reshaped quantity counts all its values)."""
    bad = 0
    for k, r in ref.items():
        r = np.asarray(r)
        p = prog.get(k)
        if p is None or np.shape(p) != r.shape:
            bad += max(r.size, 1)
            continue
        p = np.asarray(p)
        if r.dtype.kind == "f" or p.dtype.kind == "f":
            p, r = p.astype(np.float64), r.astype(np.float64)
            bad += int(((p != r) & ~_both_nan(p, r)).sum())
        else:
            bad += int((p != r).sum())
    return bad


def check_lanes(rng: np.random.Generator, n: int, want: int, longest: int) -> np.ndarray:
    """The lanes a check flies again: ``want`` of ``n`` drawn without
    replacement, and the lane that ran the most steps, sorted."""
    idx = rng.choice(n, size=min(want, n), replace=False) if want < n else np.arange(n)
    return np.unique(np.append(idx, longest))
