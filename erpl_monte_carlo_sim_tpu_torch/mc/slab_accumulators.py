"""Slab-loop accumulators (``erpl_monte_carlo_sim_tpu/mc/slab_accumulators.py``).

Each concern of a slabbed run is one ``SlabAccumulator``: ``update(ctx)``
folds in one slab through the shared ``SlabContext``, ``to_arrays`` /
``meta_state`` / ``restore`` carry it through the mid-run checkpoint
(``mc.slab_checkpoint``), and ``finalize`` writes its blocks of the analysis.
``MonteCarloAnalyzer._run_slabbed`` only drives the registry that
``build_registry`` returns, in the JAX package's order.

The sampling variants add theirs: the Sobol slabs' block means
(``QMCAccumulator``), the importance weights (``ImportanceAccumulator``) and
the forecast ensemble's strata (``EnsembleStatsAccumulator``, with the
member column in the prefix), and the control variates their cross-moments
(``CVAccumulator``, reduced on the slab's device and merged on the host in
float64). The two-level correction runs after the loop, from the run's
seed, and keeps no slab state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SlabContext", "SlabAccumulator", "PrefixAccumulator", "StreamAccumulator",
           "ConvergenceAccumulator", "QMCAccumulator", "FootprintMomentsAccumulator",
           "ImportanceAccumulator", "CVAccumulator", "EnsembleStatsAccumulator",
           "RangesAccumulator",
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
    ``slab_metrics``, ``mem_np``, ``summary_np``, ``sample_np``)."""

    def __init__(self, *, summary, sample, valid, reasons, ranges_mask, n_s: int,
                 slab: int, n_done: int, scene_b=None):
        self.summary = summary
        self.sample = sample
        self.scene_b = scene_b    # the slab's lanes (their wind tables, for CV)
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
    def mem_np(self) -> np.ndarray:
        return self._get("mem_np", lambda: self.sample.wind_member[: self.n_s].cpu().numpy())

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
    mask, reason bits, landing x/y and, under a forecast ensemble
    (``want_members``), forecast members. Without streaming ``cap`` is the
    run's size and the prefix is the whole run."""

    key = "prefix"
    _PARTS = ("valid_parts", "reason_parts", "landing_parts", "member_parts")

    def __init__(self, cap: int, streaming: bool, want_members: bool = False):
        self.cap = cap
        self.streaming = streaming
        self.want_members = want_members
        self.kept = 0
        self.metrics = {k: [] for k in PREFIX_METRICS}
        self.valid_parts: list = []
        self.reason_parts: list = []
        self.landing_parts: list = []
        self.member_parts: list = []

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
        if self.want_members:
            self.member_parts.append(ctx.mem_np[:take])
        self.kept += take

    def to_arrays(self, arrays: dict) -> None:
        for k in PREFIX_METRICS:
            parts = self.metrics[k]
            arrays["metrics." + k] = np.concatenate(parts) if parts else np.empty(0, np.float32)
        for name in self._PARTS:
            parts = getattr(self, name)
            if parts:
                arrays[name] = np.concatenate(parts)

    def meta_state(self):
        return {"kept": self.kept}

    def restore(self, z, meta) -> None:
        self.kept = meta["kept"]
        self.metrics = {k: ([z["metrics." + k]] if z["metrics." + k].size else [])
                        for k in PREFIX_METRICS}
        for name in self._PARTS:
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
        # streaming runs keep only the first metrics_sample_cap lanes here
        # (an i.i.d. sample for prng runs only: a Sobol prefix is stratified
        # and an antithetic one drops mirror partners); their stats blocks
        # come from the streams, which see every lane
        analysis["metrics_is_sample"] = self.streaming
        if self.want_members:
            analysis["wind_members"] = (np.concatenate(self.member_parts)
                                        if self.member_parts else np.zeros(0, np.int32))


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
    (float64 sums, population variance, valid lanes as i.i.d.: under
    ``sampler="sobol"`` or ``antithetic`` the stderr is conservative, and
    ``qmc_error`` is the Sobol run's valid error bar)."""

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


class QMCAccumulator(SlabAccumulator):
    """Each slab's valid-lane mean of the headline metrics: every slab of a
    Sobol run is its own scramble, so the slab means are independent
    randomized-QMC replicates and their spread a valid error bar."""

    key = "qmc"

    def __init__(self):
        self.blocks = {k: [] for k in HEADLINE_METRICS}

    def update(self, ctx: SlabContext) -> None:
        valid_np = ctx.valid_np
        for k in self.blocks:
            self.blocks[k].append(float(ctx.slab_metrics[k][valid_np].mean())
                                  if valid_np.any() else float("nan"))

    def to_arrays(self, arrays: dict) -> None:
        for k in HEADLINE_METRICS:
            arrays["qmc." + k] = np.asarray(self.blocks[k], np.float64)

    def restore(self, z, meta) -> None:
        self.blocks = {k: [float(x) for x in z["qmc." + k]] for k in HEADLINE_METRICS}

    def finalize(self, analysis: dict, analyzer) -> None:
        if len(self.blocks["apogee_altitude"]) > 1:
            analysis["qmc_error"] = analyzer._qmc_error(self.blocks)


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


class ImportanceAccumulator(SlabAccumulator):
    """Each lane's log likelihood ratio under the importance tilt
    (``mc.importance.log_weights``). It finalizes after the prefix, whose
    metrics it weighs: importance runs never stream, so the prefix holds
    every lane."""

    key = "lw"

    def __init__(self, analyzer):
        self.analyzer = analyzer
        self.parts: list = []

    def update(self, ctx: SlabContext) -> None:
        from .importance import log_weights

        a = self.analyzer
        self.parts.append(log_weights(ctx.sample, a.uncertainty_params, a.scene.motor,
                                      a.importance_shift)[: ctx.n_s])

    def to_arrays(self, arrays: dict) -> None:
        if self.parts:
            arrays["lw"] = np.concatenate(self.parts)

    def restore(self, z, meta) -> None:
        self.parts = [z["lw"]] if "lw" in z else []

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["importance"] = analyzer._importance_block(
            {k: analysis["metrics"][k] for k in HEADLINE_METRICS}, analysis["valid_mask"],
            np.concatenate(self.parts))


class CVAccumulator(SlabAccumulator):
    """The control variates' cross-moments (``mc.cv.CVMoments``): each slab
    reduced on its device by ``cv_slab_moments`` (the padding lanes of a
    ragged last slab excluded), merged on the host."""

    key = "cv"

    def __init__(self, analyzer, base_wind):
        from .cv import CVMoments

        self.analyzer = analyzer
        self.base_wind = base_wind
        self.acc = CVMoments()

    def update(self, ctx: SlabContext) -> None:
        import torch

        from .cv import cv_slab_moments

        include = torch.arange(ctx.slab, device=ctx.valid.device) < ctx.n_s
        a = self.analyzer
        self.acc.add(cv_slab_moments(ctx.sample, ctx.summary, ctx.valid, include,
                                     a.uncertainty_params, a.scene.motor,
                                     a._cv_wind_ctrl(ctx.scene_b, ctx.sample, self.base_wind)))

    def to_arrays(self, arrays: dict) -> None:
        cv = self.acc
        if cv.n > 0:
            arrays["cv.n"] = np.asarray(cv.n)
            for name in ("mz", "mt", "szz", "szt", "stt"):
                arrays["cv." + name] = getattr(cv, name)

    def restore(self, z, meta) -> None:
        from .cv import CVMoments

        cv = CVMoments()
        if "cv.n" in z:
            cv.n = int(z["cv.n"])
            for name in ("mz", "mt", "szz", "szt", "stt"):
                setattr(cv, name, np.array(z["cv." + name], np.float64))
        self.acc = cv

    def finalize(self, analysis: dict, analyzer) -> None:
        from .cv import finalize_cv

        analysis["control_variates"] = finalize_cv(self.acc, analyzer._cv_names())


class EnsembleStatsAccumulator(SlabAccumulator):
    """The forecast ensemble's per-member moments (``mc.ensemble``), merged
    slab by slab; the members of the kept lanes are the prefix's column."""

    key = "ens"

    def __init__(self, ens_acc):
        self.acc = ens_acc

    def update(self, ctx: SlabContext) -> None:
        self.acc.add(ctx.mem_np, ctx.valid_np, ctx.slab_metrics)

    def to_arrays(self, arrays: dict) -> None:
        from .ensemble import METRICS

        ens = self.acc
        arrays["ens.n_drawn"] = ens.n_drawn
        arrays["ens.n_valid"] = ens.n_valid
        for m in METRICS:
            arrays[f"ens.n.{m}"] = ens._n[m]
            arrays[f"ens.mean.{m}"] = ens._mean[m]
            arrays[f"ens.m2.{m}"] = ens._m2[m]

    def restore(self, z, meta) -> None:
        from .ensemble import METRICS, EnsembleAccumulator

        ens = EnsembleAccumulator(int(z["ens.n_drawn"].size))
        ens.n_drawn = np.array(z["ens.n_drawn"], np.int64)
        ens.n_valid = np.array(z["ens.n_valid"], np.int64)
        for m in METRICS:
            ens._n[m] = np.array(z[f"ens.n.{m}"], np.int64)
            ens._mean[m] = np.array(z[f"ens.mean.{m}"], np.float64)
            ens._m2[m] = np.array(z[f"ens.m2.{m}"], np.float64)
        self.acc = ens

    def finalize(self, analysis: dict, analyzer) -> None:
        analysis["ensemble"] = self.acc.block()


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


def build_registry(analyzer, *, n_samples: int, limit: int, streaming: bool,
                   base_wind=None, ens_acc=None) -> list:
    """The ordered accumulators of one slabbed run; the order is the
    finalize order, the JAX package's (the prefix first: the importance
    block reads its arrays). ``base_wind``: the run's forecast, which the
    CV wind controls subtract; ``ens_acc``: the forecast ensemble's
    ``mc.ensemble.EnsembleAccumulator``, or None."""
    cap = analyzer.metrics_sample_cap if streaming else n_samples
    accs: list = [PrefixAccumulator(cap, streaming, want_members=ens_acc is not None)]
    if streaming:
        accs.append(StreamAccumulator(analyzer.stats_stream_threshold))
    accs.append(ConvergenceAccumulator())
    if analyzer.sampler == "sobol":
        accs.append(QMCAccumulator())
    accs.append(FootprintMomentsAccumulator(analyzer))
    if analyzer.importance_shift:
        accs.append(ImportanceAccumulator(analyzer))
    if analyzer.control_variates:
        accs.append(CVAccumulator(analyzer, base_wind))
    if ens_acc is not None:
        accs.append(EnsembleStatsAccumulator(ens_acc))
    accs += [RangesAccumulator(analyzer), RecordsAccumulator(analyzer, limit)]
    return accs
