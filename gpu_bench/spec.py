"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration, traffic mix, entry point, limits and metric readers. Adding a
configuration, a mix, an entry or a metric is adding files."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

__all__ = ["ROOT", "Cell", "load_cell", "NAME"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list   # the e2e metric entries that this cell reports
    per_layer: list    # the per-layer metric entries that this cell reports
    root: str

    def entry(self):
        return _module(self.root, "entries", self.mix["entry"])

    def reader(self, metric: str):
        return _module(self.root, "metrics", metric)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _module(root: str, kind: str, name: str):
    """``<bench>/<kind>/<name>.py``, imported by path as
    ``<bench>.<kind>.<name>`` (a metric name may hold dots)."""
    path = os.path.join(root, HERE, kind, _checked(name) + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    mod_name = f"{HERE}.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, HERE, kind, _checked(name) + ".json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                mix=_json(root, "mixes", w["traffic"]), limits=_json(root, "limits", name),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)], root=root)
