"""Debug and observability helpers (``erpl_monte_carlo_sim_tpu/utils/debug.py``).

  * ``debug_mode()``     -- a block run under
                            ``torch.autograd.set_detect_anomaly``, the
                            counterpart of ``jax_debug_nans``;
  * ``trace_profile()``  -- a ``torch.profiler`` trace of a block (CPU and
                            CUDA activities), written as a Chrome trace;
  * ``check_finite()``   -- raise, naming the leaf, if a tensor, array or
                            parameter dataclass holds a non-finite value.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from .logging import get_logger

__all__ = ["debug_mode", "trace_profile", "check_finite"]

log = get_logger("debug")


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Run a block with ``torch.autograd.set_detect_anomaly(nans)``, and
    restore the previous setting on exit, as the JAX package restores
    ``jax_debug_nans``. Anomaly detection reports a NaN at the backward
    operation that made it, so it bites only on a differentiated path,
    which the port gains with ROADMAP P14; the forward flights of the
    kernel and the eager core are not checked by it."""
    prev = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(nans)
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


@contextlib.contextmanager
def trace_profile(log_dir: str = "profiles"):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity where a card is present) and write a Chrome trace,
    ``trace.json``, into ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def _leaves(obj, path):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, obj


def check_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` with the leaf path if any floating
    tensor or array in ``tree`` (a tensor, an array, a parameter dataclass,
    or dicts/lists of them) is non-finite."""
    for path, leaf in _leaves(tree, ""):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf) if isinstance(leaf, (np.ndarray, np.generic, float)) \
                else None
            if arr is None or arr.dtype.kind != "f":
                continue
            bad = int((~np.isfinite(arr)).sum())
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")
