"""Run one cell of the benchmark once and print its result line.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (imports, the card, the kernels'
libraries, the cell's scene and ``WARM_ANALYSES`` warm analyses) is timed
as ``setup_s``; then one analyst runs the cell's analyses back to back for ``--seconds``
(analysis ``i`` under a seed derived from ``--seed`` and ``i``); with
``--trace 1`` the window runs under ``torch.profiler``. Once the window has
closed and the program's state is freed, one analysis of the window, drawn
from the seed, is checked against the plain reference (``reference/``), each
compared number printed beside its limit. The last line of standard output
is the JSON result; it is printed only where a card is present, the cell's
chips are there, and no module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

__all__ = ["main", "prepare", "Bench", "Run", "analysis_seed", "FORBIDDEN"]

# top-level module names the run may not hold, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "erpl_monte_carlo_sim_tpu")
# analyses of the cell's shape run in set-up: the first two or three of a
# process run slower than the rest (host allocations and caches warming)
WARM_ANALYSES = 3
# the build and kernel caches, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}


@dataclasses.dataclass
class Bench:
    """What an entry point is handed: the cell's configuration and mix, the
    device and dtype."""
    cell: str
    config: dict
    mix: dict
    device: object
    dtype: object


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: object
    setup_s: float
    walls: list
    flights: int
    window_s: float
    trace: object = None
    work: dict = None
    peak_bytes: int = 0


def analysis_seed(seed: int, i: int) -> int:
    """The seed of analysis ``i`` of a run under ``seed`` (``i < 0``: the
    warm analyses of set-up), below 2**63."""
    h = hashlib.sha256(f"{int(seed)}:{int(i)}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def loaded_forbidden() -> list:
    """The forbidden top-level modules ``sys.modules`` holds."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def _window(entry, state, seed: int, seconds: float, trace: bool, keep, work_of):
    """Analyses back to back until ``seconds`` have passed; returns the
    walls, the flights, the window's length, the profile and the summed
    kernel work. ``keep(i, seed_i, result)`` sees every analysis."""
    import torch

    walls, flights, work = [], 0, None
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    from gpu_bench.trace import SPAN

    start = time.perf_counter()
    i = 0
    while True:
        s_i = analysis_seed(seed, i)
        t0 = time.perf_counter()
        if trace:
            with torch.profiler.record_function(SPAN):
                n, result = entry.run(state, s_i)
        else:
            n, result = entry.run(state, s_i)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        flights += n
        if trace:
            w = work_of(result)
            if w is not None:
                work = w if work is None else {k: work[k] + w[k] for k in work}
        keep(i, s_i, result)
        i += 1
        if t1 - start >= seconds:
            break
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.__exit__(None, None, None)
    return walls, flights, window_s, prof, work


def prepare(workload: str, root=None, device=None) -> tuple:
    """``(cell, bench)`` of the cell ``workload`` under the checkout ``root``,
    its caches pointed inside the checkout; ``bench`` is None where no card
    (or too few) is there. ``device`` (tests) skips the look for a card."""
    from gpu_bench import spec

    root = root or spec.ROOT
    cell = spec.load_cell(workload, root)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, ".gpu_bench_cache", sub)

    import torch

    if device is None:
        if not torch.cuda.is_available():
            _say("no CUDA device: torch.cuda.is_available() is false")
            return cell, None
        if torch.cuda.device_count() < cell.chips:
            _say(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} are visible")
            return cell, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    return cell, Bench(cell.name, cell.config, cell.mix, device,
                       getattr(torch, cell.config["dtype"]))


def main(argv=None, *, root=None, device=None) -> int:
    """Run the cell; 0 and the result line, or another code and no result.
    ``device`` (tests) skips the look for a card and runs there."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, bench = prepare(args.workload, root, device)
    if bench is None:
        return 3

    import numpy as np
    import torch

    device = bench.device
    entry = cell.entry()
    cuda = device.type == "cuda"

    state = entry.setup(bench)
    for i in range(WARM_ANALYSES):
        entry.run(state, analysis_seed(args.seed, -1 - i))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    pick = random.Random(args.seed)
    kept = {}

    def keep(i, s_i, result):
        # one analysis of the window, drawn from the seed (a reservoir of one)
        if pick.random() * (i + 1) < 1.0:
            kept.update(i=i, seed=s_i, result=result)

    walls, flights, window_s, prof, work = _window(
        entry, state, args.seed, args.seconds, bool(args.trace), keep,
        lambda r: entry.work(state, r))
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = loaded_forbidden()
    if found:
        _say(f"modules of JAX or the JAX package were loaded: {found}")
        return 4

    trace = None
    if prof is not None:
        from gpu_bench.trace import read_profile

        trace = read_profile(prof)
        del prof
    run = Run(cell=cell, setup_s=setup_s, walls=walls, flights=flights, window_s=window_s,
              trace=trace, work=work, peak_bytes=peak)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_block = {"platform": "gpu" if cuda else device.type,
                    "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                    "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace is not None:
        device_block["busy_s"] = trace.busy_s
        device_block["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    if cuda:
        _say(f"card: {_power()}")
    _say("walls_s: " + " ".join(f"{w:.4f}" for w in walls))

    # the check, after the window, with the program's state freed
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng([abs(int(args.seed)), kept["i"]])
    t_check = time.perf_counter()
    values = entry.check(bench, kept["result"], kept["seed"], rng)
    _say(f"the check took {time.perf_counter() - t_check:.1f} s")
    checks, correct = {}, True
    for name, v in values.items():
        limit = cell.limits.get(name)
        ok = limit is not None and v <= limit
        correct &= ok
        checks[name] = {"value": _finite(float(v)), "limit": limit}
    for name in cell.limits:
        if name not in values:
            correct = False
            checks[name] = {"value": "not computed", "limit": cell.limits[name]}
    found = loaded_forbidden()
    if found:
        _say(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    out = {"correct": bool(correct), "attempted": len(walls), "failed": 0, "metrics": metrics,
           "device": device_block}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    _say(f"checked analysis {kept['i']} of {len(walls)} (seed {kept['seed']})")
    for name, c in checks.items():
        _say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
