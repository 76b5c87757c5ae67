"""The device trace of a measured window: ``torch.profiler`` with CPU and
CUDA activity over the window, and the benchmark's own spans
(``record_function``) around each analysis. ``Trace`` holds what the
per-layer readers take: the device's activity as intervals by name, the
union of them, and the spans."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SPAN", "Trace", "read_profile", "union"]

# the benchmark's span around each analysis of the window
SPAN = "gpu_bench.analysis"


def union(iv: np.ndarray) -> np.ndarray:
    """The union of intervals ``[k, 2]`` (start, end) as sorted disjoint
    intervals."""
    if len(iv) == 0:
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, np.float64)


def _clip_len(u: np.ndarray, lo: float, hi: float) -> float:
    """The length of the disjoint intervals ``u`` inside ``[lo, hi]``."""
    if len(u) == 0:
        return 0.0
    return float(np.clip(np.minimum(u[:, 1], hi) - np.maximum(u[:, 0], lo), 0.0, None).sum())


@dataclasses.dataclass
class Trace:
    dev_names: list        # each device activity's name
    dev: np.ndarray        # [k, 2] its start and end, seconds
    cpu_names: list        # each host operation's name (the spans left out)
    cpu: np.ndarray        # [m, 2]
    spans: np.ndarray      # [a, 2] the analyses' spans

    def __post_init__(self):
        self.busy = union(self.dev)

    @property
    def window(self) -> tuple:
        return float(self.spans[0, 0]), float(self.spans[-1, 1])

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return hi - lo

    @property
    def busy_s(self) -> float:
        return _clip_len(self.busy, *self.window)

    def device_s(self, *names: str) -> float:
        """Seconds of device activity whose name holds any of ``names``."""
        pick = [i for i, n in enumerate(self.dev_names) if any(s in n for s in names)]
        if not pick:
            return 0.0
        iv = self.dev[pick]
        return float((iv[:, 1] - iv[:, 0]).sum())

    def host_s_per_span(self) -> list:
        """Each span's length less the device activity inside it."""
        return [float(b - a) - _clip_len(self.busy, a, b) for a, b in self.spans]

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device activities that took most time, summed by name."""
        tot = {}
        for n, (a, b) in zip(self.dev_names, self.dev):
            tot[n] = tot.get(n, 0.0) + float(b - a)
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest gaps between device activity inside the window,
        each named by the host operation that overlaps it most (``host`` for
        host work outside any torch operation)."""
        lo, hi = self.window
        u = self.busy[(self.busy[:, 1] > lo) & (self.busy[:, 0] < hi)]
        edges = np.concatenate([[lo], u.ravel(), [hi]]).reshape(-1, 2) if len(u) else \
            np.array([[lo, hi]])
        gaps = [(max(float(a), lo), min(float(b), hi)) for a, b in edges]
        gaps = [g for g in gaps if g[1] > g[0]]
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:k]:
            label, best = "host", 0.0
            if len(self.cpu):
                ov = np.clip(np.minimum(self.cpu[:, 1], b) - np.maximum(self.cpu[:, 0], a),
                             0.0, None)
                j = int(np.argmax(ov))
                if ov[j] > 0.5 * (b - a):
                    label, best = self.cpu_names[j], float(ov[j])
            out.append([label, b - a])
        return out


def _events(prof):
    """``(name, is_device, start_s, end_s)`` of every profiled event."""
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            dev = "cuda" in str(e.device_type()).lower()
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            yield e.name(), dev, start, start + dur
        return
    for e in prof.events():
        dev = "cuda" in str(e.device_type).lower()
        yield e.name, dev, e.time_range.start * 1e-6, e.time_range.end * 1e-6


def read_profile(prof) -> Trace:
    """A finished ``torch.profiler.profile``'s ``Trace``. The GPU copy of a
    span (``gpu_user_annotation``) is no device activity."""
    dev_n, dev, cpu_n, cpu, spans = [], [], [], [], []
    for name, is_dev, a, b in _events(prof):
        if name.startswith("gpu_bench."):
            if not is_dev and name == SPAN:
                spans.append((a, b))
            continue
        if is_dev:
            dev_n.append(name)
            dev.append((a, b))
        elif b > a:
            cpu_n.append(name)
            cpu.append((a, b))
    spans = np.asarray(sorted(spans), np.float64).reshape(-1, 2)
    return Trace(dev_n, np.asarray(dev, np.float64).reshape(-1, 2), cpu_n,
                 np.asarray(cpu, np.float64).reshape(-1, 2), spans)
