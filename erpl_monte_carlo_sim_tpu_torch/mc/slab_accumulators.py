"""Slab-loop accumulators (``erpl_monte_carlo_sim_tpu/mc/slab_accumulators.py``).

Each concern of a slabbed run is one ``SlabAccumulator``: ``update(ctx)``
folds in one slab through the shared ``SlabContext``, ``to_arrays`` /
``meta_state`` / ``restore`` carry it through the mid-run checkpoint
(``mc.slab_checkpoint``), and ``finalize`` writes its blocks of the analysis.
``MonteCarloAnalyzer._run_slabbed`` only drives the registry that
``build_registry`` returns, in the JAX package's order.

The concerns of the JAX package's sampling variants and estimators (QMC
block means, importance weights, control variates, forecast-ensemble strata)
come with ROADMAP P12 and P13; the analyzer refuses their knobs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SlabContext", "SlabAccumulator", "PrefixAccumulator", "StreamAccumulator",
           "ConvergenceAccumulator", "FootprintMomentsAccumulator", "RangesAccumulator",
           "RecordsAccumulator", "build_registry"]

HEADLINE_METRICS = ("apogee_altitude", "range", "flight_time")
PREFIX_METRICS = HEADLINE_METRICS + ("max_speed",)


def _head_np(obj, n: int):
    """Every tensor leaf of a port dataclass, its first ``n`` lanes, on the
    host: one ``.cpu()`` of the slice per leaf."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _head_np(getattr(obj, f.name), n)
                            for f in dataclasses.fields(obj)})
    return obj[:n].cpu().numpy()


class SlabContext:
    """One slab's data, shared by every accumulator: the device tensors, and
    host copies of the slab's first ``n_s`` lanes made lazily, at most once
    per array and only if an accumulator asks (``valid_np``, ``reasons_np``,
    ``slab_metrics``, ``summary_np``, ``sample_np``)."""

    def __init__(self, *, summary, sample, valid, reasons, ranges_mask, n_s: int,
                 slab: int, n_done: int):
        self.summary = summary
        self.sample = sample
        self.valid = valid
        self.reasons = reasons
        self.ranges_mask = ranges_mask
        self.n_s = n_s
        self.slab = slab
        self.n_done = n_done      # global id of the slab's lane 0
        self.n_valid_total = 0    # set by the loop after the readback
        self._cache: dict = {}

    def _get(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def valid_np(self) -> np.ndarray:
        return self._get("valid_np", lambda: self.valid[: self.n_s].cpu().numpy())

    @property
    def reasons_np(self) -> np.ndarray:
        return self._get("reasons_np", lambda: self.reasons[: self.n_s].cpu().numpy())

    @property
    def slab_metrics(self) -> dict:
        return self._get("slab_metrics", lambda: {
            k: getattr(self.summary, k)[: self.n_s].cpu().numpy() for k in PREFIX_METRICS})

    @property
    def summary_np(self):
        return self._get("summary_np", lambda: _head_np(self.summary, self.n_s))

    @property
    def sample_np(self):
        return self._get("sample_np", lambda: _head_np(self.sample, self.n_s))


class SlabAccumulator:
    """Protocol base. ``key`` names the accumulator's checkpoint state;
    ``version`` is its own schema version."""

    key: str = ""
    version: int = 1

    def update(self, ctx: SlabContext) -> None:
        raise NotImplementedError

    def to_arrays(self, arrays: dict) -> None:
        """Contribute NumPy leaves to the checkpoint (a flat npz dict)."""

    def meta_state(self):
        """JSON-native state (floats survive JSON exactly)."""
        return None

    def restore(self, z, meta) -> None:
        """Rebuild in place from the loaded npz and ``meta_state()``."""

    def finalize(self, analysis: dict, analyzer) -> None:
        """Write this concern's blocks of the analysis."""


class PrefixAccumulator(SlabAccumulator):
    """The first ``cap`` lanes' headline metrics and ``max_speed``, valid
    mask, reason bits and landing x/y. Without streaming ``cap`` is the run's
    size and the prefix is the whole run."""

    key = "prefix"

    def __init__(self, cap: int, streaming: bool):
        self.cap = cap
        self.streaming = streaming
        self.kept = 0
        self.metrics = {k: [] for k in PREFIX_METRICS}
        self.valid_parts: list = []
        self.reason_parts: list = []
        self.landing_parts: list = []

    def update(self, ctx: SlabContext) -> None:
        take = min(ctx.n_s, self.cap - self.kept)
        if take <= 0:
            return
        for k in self.metrics:
            self.metrics[k].append(ctx.slab_metrics[k][:take])
        # sliced on the device: [take, 2] comes back, not [slab, 3]
        self.landing_parts.append(ctx.summary.landing_position[:take, :2].cpu().numpy())
        self.valid_parts.append(ctx.valid_np[:take])
        self.reason_parts.append(ctx.reasons_np[:take])
        self.kept += take

    def to_arrays(self, arrays: dict) -> None:
        for k in PREFIX_METRICS:
            parts = self.metrics[k]
            arrays["metrics." + k] = np.concatenate(parts) if parts else np.empty(0, np.float32)
        for name in ("valid_parts", "reason_parts", "landing_parts"):
            parts = getattr(self, name)
            if parts:
                arrays[name] = np.concatenate(parts)

    def meta_state(self):
        return {"kept": self.kept}

    def restore(self, z, meta) -> None:
        self.kept = meta["kept"]
        self.metrics = {k: ([z["metrics." + k]] if z["metrics." + k].size else [])
                        for k in PREFIX_METRICS}
        for name in ("valid_parts", "reason_parts", "landing_parts"):
            setattr(self, name, [z[name]] if name in z else [])

    def concatenated(self) -> tuple:
        metrics = {k: np.concatenate(v) if v else np.empty(0) for k, v in self.metrics.items()}
        valid = np.concatenate(self.valid_parts) if self.valid_parts else np.zeros(0, bool)
        reasons = (np.concatenate(self.reason_parts) if self.reason_parts
                   else np.zeros(0, np.int32))
        return metrics, valid, reasons

    def finalize(self, analysis: dict, analyzer) -> None:
        metrics, valid_np, reasons_np = self.concatenated()
        analysis["metrics"] = metrics
        analysis["valid_mask"] = valid_np
        analysis["reasons"] = reasons_np
        analysis["landing_samples"] = (np.concatenate(self.landing_parts)
                                       if self.landing_parts else np.zeros((0, 2)))
        # streaming runs keep only the first metrics_sample_cap lanes here;
        # their stats blocks come from the streams, which see every lane
        analysis["metrics_is_sample"] = self.streaming


class StreamAccumulator(SlabAccumulator):
    """Per headline metric: exact moments and the quantile sketch
    (``mc.stats.StreamingStats``), and the top and bottom order statistics
    (``mc.tail.TailReservoir``)."""

    key = "stream"

    def __init__(self, exact_threshold: int):
        from .stats import StreamingStats
        from .tail import TailReservoir

        self.exact_threshold = exact_threshold
        self.stream = {k: StreamingStats(exact_threshold=exact_threshold)
                       for k in HEADLINE_METRICS}
        self.tails = {k: TailReservoir() for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        for k in self.stream:
            vals_valid = ctx.slab_metrics[k][ctx.valid_np]
            self.stream[k].add(vals_valid)
            self.tails[k].add(vals_valid)

    def to_arrays(self, arrays: dict) -> None:
        from .slab_checkpoint import _pack_stream

        for k in HEADLINE_METRICS:
            _pack_stream(self.stream[k], arrays, f"stream.{k}.")
            self.tails[k].to_arrays(arrays, f"tail.{k}.")

    def restore(self, z, meta) -> None:
        from .slab_checkpoint import _unpack_stream
        from .tail import TailReservoir

        self.stream = {k: _unpack_stream(z, f"stream.{k}.", self.exact_threshold)
                       for k in HEADLINE_METRICS}
        self.tails = {k: TailReservoir.from_arrays(z, f"tail.{k}.") for k in HEADLINE_METRICS}

    def stats_blocks(self) -> dict:
        return {k: s.stats() for k, s in self.stream.items()}

    def finalize(self, analysis: dict, analyzer) -> None:
        # the sketches stay queryable (stats.exceedance_from_analysis)
        analysis["streams"] = self.stream
        analysis["tail_reservoirs"] = self.tails


class ConvergenceAccumulator(SlabAccumulator):
    """Running mean and stderr of each headline metric after every slab
    (float64 sums, population variance, valid lanes as i.i.d.)."""

    key = "conv"

    def __init__(self):
        self.hist: list = []
        self.acc = {k: [0, 0.0, 0.0] for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        row = {"n_done": ctx.n_done + ctx.n_s, "n_valid": ctx.n_valid_total}
        for k in self.acc:
            v = ctx.slab_metrics[k][ctx.valid_np].astype(np.float64)
            v = v[np.isfinite(v)]
            a = self.acc[k]
            a[0] += v.size
            a[1] += float(v.sum())
            a[2] += float((v * v).sum())
            n_c, s_c, s2_c = a
            if n_c >= 2:
                m_c = s_c / n_c
                var_c = max(s2_c / n_c - m_c * m_c, 0.0)
                row[k] = {"mean": m_c, "stderr": float(np.sqrt(var_c / n_c))}
            else:
                row[k] = {"mean": (s_c / n_c) if n_c else float("nan"),
                          "stderr": float("nan")}
        self.hist.append(row)

    def meta_state(self):
        return {"conv_hist": self.hist, "conv_acc": self.acc}

    def restore(self, z, meta) -> None:
        self.hist = meta["conv_hist"]
        self.acc = meta["conv_acc"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["convergence"] = self.hist


class FootprintMomentsAccumulator(SlabAccumulator):
    """The landing footprint's moment merge: each slab reduces on its device
    to six numbers (``MonteCarloAnalyzer._footprint_moments``); the ellipses
    and the Gaussian CEP are built once at the end."""

    key = "footprint"

    def __init__(self, analyzer):
        from .stats import FootprintAccumulator

        self.analyzer = analyzer
        self.acc = FootprintAccumulator()

    def update(self, ctx: SlabContext) -> None:
        self.acc.add(*self.analyzer._footprint_moments(ctx.summary.landing_position,
                                                       ctx.ranges_mask))

    def to_arrays(self, arrays: dict) -> None:
        a = self.acc
        arrays["footprint"] = np.asarray([a.n, a.mx, a.my, a.m2x, a.m2y, a.cxy], np.float64)

    def restore(self, z, meta) -> None:
        n, mx, my, m2x, m2y, cxy = z["footprint"]
        a = self.acc
        a.n = int(n)
        a.mx, a.my = float(mx), float(my)
        a.m2x, a.m2y, a.cxy = float(m2x), float(m2y), float(cxy)

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["landing_footprint"] = self.acc.footprint()


class RangesAccumulator(SlabAccumulator):
    """The observed dispersion parameters' min and max, reduced on the
    slab's device (``MonteCarloAnalyzer._parameter_ranges_device``)."""

    key = "pranges"

    def __init__(self, analyzer):
        self.analyzer = analyzer
        self.pranges = None

    def update(self, ctx: SlabContext) -> None:
        pr = self.analyzer._parameter_ranges_device(ctx.sample, ctx.ranges_mask)
        self.pranges = (pr if self.pranges is None
                        else self.analyzer._merge_ranges(self.pranges, pr))

    def meta_state(self):
        return {"pranges": self.pranges}

    def restore(self, z, meta) -> None:
        self.pranges = meta["pranges"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["parameter_ranges_observed"] = self.pranges or {}


class RecordsAccumulator(SlabAccumulator):
    """Per-lane record dicts, the first ``limit`` of each kind. The slab's
    summary and sample come to the host only while records of a kind the
    slab holds are still wanted."""

    key = "records"

    def __init__(self, analyzer, limit: int):
        self.analyzer = analyzer
        self.limit = limit
        self.records: list = []
        self.outlier_records: list = []

    def update(self, ctx: SlabContext) -> None:
        valid_np = ctx.valid_np
        need_valid = len(self.records) < self.limit and valid_np.any()
        need_outlier = len(self.outlier_records) < self.limit and (~valid_np).any()
        if not (need_valid or need_outlier):
            return
        summary_np, sample_np = ctx.summary_np, ctx.sample_np
        if need_valid:
            self.records.extend(self.analyzer._materialize_records(
                summary_np, sample_np, valid_np, ctx.reasons_np, want_valid=True,
                limit=self.limit - len(self.records), offset=ctx.n_done))
        if need_outlier:
            self.outlier_records.extend(self.analyzer._materialize_records(
                summary_np, sample_np, valid_np, ctx.reasons_np, want_valid=False,
                limit=self.limit - len(self.outlier_records), offset=ctx.n_done))

    def meta_state(self):
        return {"records": self.records, "outlier_records": self.outlier_records}

    def restore(self, z, meta) -> None:
        self.records = meta["records"]
        self.outlier_records = meta["outlier_records"]

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["results"] = self.records
        analysis["outliers"] = self.outlier_records


def build_registry(analyzer, *, n_samples: int, limit: int, streaming: bool) -> list:
    """The ordered accumulators of one slabbed run; the order is the
    finalize order, the JAX package's."""
    cap = analyzer.metrics_sample_cap if streaming else n_samples
    accs: list = [PrefixAccumulator(cap, streaming)]
    if streaming:
        accs.append(StreamAccumulator(analyzer.stats_stream_threshold))
    accs += [ConvergenceAccumulator(), FootprintMomentsAccumulator(analyzer),
             RangesAccumulator(analyzer), RecordsAccumulator(analyzer, limit)]
    return accs
