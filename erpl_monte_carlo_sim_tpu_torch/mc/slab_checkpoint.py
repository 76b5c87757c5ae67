"""Mid-run checkpoint and resume of slabbed runs
(``erpl_monte_carlo_sim_tpu/mc/slab_checkpoint.py``).

``run_monte_carlo(..., checkpoint_path=p, checkpoint_every=k)`` writes the
slab loop's state to ``p`` every ``k`` slabs; the same call after a crash
resumes from it, and the result is bit for bit the uninterrupted run's (slab
k's lanes depend only on ``(seed, k, slab)``; every accumulator merges
deterministically on the host). The file goes when the run completes.

A fingerprint of every input that changes a slab's results or the
accumulators' shapes guards the resume: the scene, initial-condition and
base-wind tensors, the dispersion, simulation and outlier settings, the run's
size, slab and seed, the generator (``PRNG``), the streaming knobs, the wind
grid, the device type (a
card's run resumed on the CPU would mix two populations) and the sampling
options (sampler, scrambles, Sobol wind modes, antithetic pairs, importance
shift) and the estimators' (control variates with their wind controls, the
two-level lanes). A checkpoint of another run refuses to load.

One uncompressed ``.npz``, written atomically (a temporary file, then
``os.replace``), its parent directories created.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os

import numpy as np
import torch

from .stats import StreamingStats
from ..utils.tree import is_static

__all__ = ["run_fingerprint", "save_slab_state", "read_slab_state", "load_slab_state"]

# the container's version; each accumulator carries its own. Version 6:
# slabs are drawn by jax.random's threefry (``PRNG``); files up to version 5
# hold slabs of torch.Generator draws, other lanes for the same seed
_VERSION = 6
PRNG = "threefry2x32"


def _hash_tree(h, obj, path: str) -> None:
    """Feed the structure, every static field's value and every tensor's
    dtype, shape and bytes of a port dataclass (or tuple, or tensor) to
    ``h``."""
    h.update(path.encode())
    if obj is None:
        h.update(b"None")
    elif dataclasses.is_dataclass(obj):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if is_static(f):
                h.update(f"{path}.{f.name}={v!r}".encode())
            else:
                _hash_tree(h, v, f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _hash_tree(h, v, f"{path}[{i}]")
    else:
        t = torch.as_tensor(obj).detach()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(np.ascontiguousarray(t.cpu().numpy()).tobytes())


def run_fingerprint(analyzer, ic, n_samples, slab, seed, base_wind, limit,
                    chunk_steps=None) -> str:
    """Digest of every input that shapes the slabs' results and the
    accumulators. Equal fingerprints run identical slab sequences. A
    chunked run (``chunk_steps``) flies the stacked engine, so its slabs
    are not an unchunked run's."""
    h = hashlib.sha256()
    _hash_tree(h, analyzer.scene, "scene")
    _hash_tree(h, ic, "ic")
    _hash_tree(h, base_wind, "base_wind")
    # frozen dataclasses of plain values: repr describes them completely
    h.update(repr(analyzer.uncertainty_params).encode())
    h.update(repr(analyzer.sim_config).encode())
    h.update(repr(analyzer.bounds).encode())
    h.update(json.dumps([
        _VERSION, PRNG, int(n_samples), int(slab), int(seed), int(limit),
        int(analyzer.stats_stream_threshold), int(analyzer.metrics_sample_cap),
        int(analyzer.wind_grid_points), float(analyzer.wind_grid_top),
        analyzer.device.type, analyzer.sampler, int(analyzer.sobol_scrambles),
        int(analyzer.sobol_wind_modes), bool(analyzer.antithetic),
        [[c, float(t)] for c, t in analyzer.importance_shift],
        bool(analyzer.control_variates), int(analyzer.cv_wind_modes),
        int(analyzer.cv_wind_speed), int(analyzer.two_level_lanes),
        analyzer.wind_table_modes, None if chunk_steps is None else int(chunk_steps),
    ]).encode())
    return h.hexdigest()


def _pack_stream(s: StreamingStats, out: dict, prefix: str) -> None:
    # the warn-once latch rides along, so a resumed run logs as the whole would
    out[prefix + "moments"] = np.asarray(
        [s.n, s._mean, s._m2, s._min, s._max, float(s._warned)], np.float64)
    if s._exact_parts is not None:
        parts = s._exact_parts
        out[prefix + "exact"] = np.concatenate(parts) if parts else np.empty(0)
        # at the exact -> sketch crossing each part compresses on its own,
        # so the part boundaries are part of the state
        out[prefix + "exact_lens"] = np.asarray([p.size for p in parts], np.int64)
    else:
        out[prefix + "cent_v"] = s._cent_v
        out[prefix + "cent_w"] = s._cent_w


def _unpack_stream(z, prefix: str, exact_threshold: int) -> StreamingStats:
    s = StreamingStats(exact_threshold=exact_threshold)
    mo = z[prefix + "moments"]
    n, mean, m2, mn, mx = mo[:5]
    s.n = int(n)
    s._mean, s._m2 = float(mean), float(m2)
    s._min, s._max = float(mn), float(mx)
    s._warned = bool(mo[5]) if mo.size > 5 else False
    if prefix + "exact" in z:
        lens = z[prefix + "exact_lens"]
        s._exact_parts = (list(np.split(z[prefix + "exact"], np.cumsum(lens)[:-1]))
                          if lens.size else [])
    else:
        s._exact_parts = None
        s._cent_v = z[prefix + "cent_v"]
        s._cent_w = z[prefix + "cent_w"]
    return s


def save_slab_state(path: str, loop: dict, accs: list, fingerprint: str) -> None:
    """Atomically write the loop counters and every accumulator's state
    (its npz leaves, and its JSON state under its key and version)."""
    arrays: dict = {}
    meta = {"version": _VERSION, "fingerprint": fingerprint,
            "n_done": int(loop["n_done"]), "slab_idx": int(loop["slab_idx"]),
            "n_valid_total": int(loop["n_valid_total"]), "acc": {}}
    for acc in accs:
        acc.to_arrays(arrays)
        meta["acc"][acc.key] = {"version": acc.version, "state": acc.meta_state()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def read_slab_state(path: str) -> bytes | None:
    """The checkpoint file's bytes, or None when there is none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def load_slab_state(path: str, fingerprint: str, accs: list, raw: bytes | None) -> dict | None:
    """Restore the accumulators in place from ``raw``, the bytes
    ``read_slab_state(path)`` gave where the file lives (rank 0 of a mesh
    hands its read to every rank), and return the loop counters, or None
    when there is no checkpoint. Another format version, another run's
    fingerprint, another set of accumulators or another accumulator version
    raises: resuming into the wrong state would corrupt the results."""
    if raw is None:
        return None
    with np.load(io.BytesIO(raw)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] != _VERSION:
            drawn = (" and its slabs were drawn by torch.Generator, which this build "
                     f"replaced by jax.random's {PRNG}: resuming would mix other lanes "
                     "for the same seed" if meta["version"] < 6 else "")
            raise ValueError(f"checkpoint {path!r} uses format v{meta['version']}; "
                             f"this build writes v{_VERSION}{drawn} — delete it (or "
                             "finish the run with the build that wrote it)")
        if meta["fingerprint"] != fingerprint:
            raise ValueError(f"checkpoint {path!r} belongs to a different run "
                             "(scene/config/sampling mismatch); delete it or point "
                             "checkpoint_path elsewhere to start fresh")
        saved = meta["acc"]
        keys = [a.key for a in accs]
        if sorted(saved) != sorted(keys):
            raise ValueError(f"checkpoint {path!r} holds accumulators {sorted(saved)} "
                             f"but this run builds {sorted(keys)}; delete the checkpoint")
        for acc in accs:
            ent = saved[acc.key]
            if ent["version"] != acc.version:
                raise ValueError(f"checkpoint accumulator {acc.key!r} is schema "
                                 f"v{ent['version']}; this build expects v{acc.version} "
                                 "— delete the checkpoint")
            acc.restore(z, ent["state"])
        return {"n_done": meta["n_done"], "slab_idx": meta["slab_idx"],
                "n_valid_total": meta["n_valid_total"]}
