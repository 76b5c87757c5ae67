"""Exact tail order statistics across slabs (``erpl_monte_carlo_sim_tpu/mc/tail.py``).

Only ``TailReservoir`` is ported: streaming slabbed runs keep it per headline
metric, and it rides the mid-run checkpoint and ``save_summaries``. The GPD
fits that read it (``fit_gpd_pwm``, ``gpd_tail``, ``tail_from_analysis``)
come with ROADMAP P13.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TailReservoir"]


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
