"""Save and load a finished analysis (``erpl_monte_carlo_sim_tpu/mc/checkpoint.py``).

One compressed ``.npz`` in the JAX package's layout, so that a file written
by one package loads in the other: a single-call analysis keeps its
``FlightSummary`` leaves (``summary.apogee_altitude``,
``summary.rail.rail_exit_time``, ...) and its dispersion sample
(``sample.mass_multiplier``, ...); a slabbed one its per-lane metrics
(``metrics.<name>``) and, when it streamed, its tail reservoirs
(``tail.<metric>.hi|lo|nk``). Both keep ``valid_mask``, ``reasons`` and a
JSON ``__meta__`` with the counts and stats blocks.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..engine.rail import RailInfo
from ..engine.simulate import FlightSummary
from .tail import TailReservoir

__all__ = ["save_summaries", "load_summaries"]

_META_KEY = "__meta__"


def _leaves(obj, path: str):
    """``(name, array)`` per leaf, named as ``jax.tree_util.keystr`` names
    the JAX package's fields (``.rail.rail_exit_time``)."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    else:
        yield path, np.asarray(obj)


def save_summaries(path: str, analysis: dict, seed: int | None = None) -> None:
    """Write the per-lane results of ``run_monte_carlo`` to one ``.npz``."""
    arrays = {}
    summary = analysis["summary"]
    slabbed = summary is None
    if slabbed:
        for name, arr in analysis["metrics"].items():
            arrays["metrics." + name] = np.asarray(arr)
        for name, r in (analysis.get("tail_reservoirs") or {}).items():
            r.to_arrays(arrays, f"tail.{name}.")
    else:
        arrays.update(_leaves(summary, "summary"))
        arrays.update(_leaves(analysis["sample"], "sample"))
    arrays["valid_mask"] = np.asarray(analysis["valid_mask"])
    arrays["reasons"] = np.asarray(analysis["reasons"])
    if analysis.get("wind_members") is not None:
        arrays["wind_members"] = np.asarray(analysis["wind_members"])
    meta = {
        # a streaming run keeps a capped prefix; n_total is the run's size
        "n_samples": int(analysis.get("n_total", analysis["valid_mask"].shape[0])),
        "n_valid": int(analysis["n_samples"]),
        "n_outliers": int(analysis["n_outliers"]),
        "metrics_is_sample": bool(analysis.get("metrics_is_sample", False)),
        "seed": seed,
        "slabbed": slabbed,
        "stats": {k: analysis[k] for k in ("apogee_altitude", "range", "flight_time")},
        "landing_footprint": analysis.get("landing_footprint"),
        "ensemble": analysis.get("ensemble"),
    }
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_summaries(path: str) -> dict:
    """Load a file of ``save_summaries`` (of either package): ``summary`` (a
    ``FlightSummary`` of NumPy arrays, or None with ``metrics`` for a
    slabbed run), ``sample`` (field name -> array), the masks and ``meta``."""
    with np.load(path) as data:
        return _from_npz(data)


def _from_npz(data) -> dict:
    meta = json.loads(bytes(data[_META_KEY]).decode())
    if meta.get("slabbed"):
        tails = [k[len("tail."):-len(".nk")]
                 for k in data.files if k.startswith("tail.") and k.endswith(".nk")]
        out = {
            "summary": None,
            "metrics": {k[len("metrics."):]: data[k]
                        for k in data.files if k.startswith("metrics.")},
            "tail_reservoirs": {name: TailReservoir.from_arrays(data, f"tail.{name}.")
                                for name in tails} or None,
            "valid_mask": data["valid_mask"],
            "reasons": data["reasons"],
            "metrics_is_sample": bool(meta.get("metrics_is_sample", False)),
            "meta": meta,
        }
    else:
        def build(cls, prefix):
            return cls(**{f.name: (build(RailInfo, f"{prefix}.rail") if f.name == "rail"
                                   else data[f"{prefix}.{f.name}"])
                          for f in dataclasses.fields(cls)})

        out = {
            "summary": build(FlightSummary, "summary"),
            "valid_mask": data["valid_mask"],
            "reasons": data["reasons"],
            "meta": meta,
            "sample": {k[len("sample."):]: data[k] for k in data.files
                       if k.startswith("sample")},
        }
    if meta.get("ensemble") is not None:
        out["ensemble"] = meta["ensemble"]
    if "wind_members" in data.files:
        out["wind_members"] = data["wind_members"]
    return out
