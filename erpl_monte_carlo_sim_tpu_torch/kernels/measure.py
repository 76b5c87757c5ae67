"""Measure the whole-flight kernel on one NVIDIA GPU.

    python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.measure [--reps 3] [--out FILE]

The helpers here are also ``chip_smoke.py``'s: the card line, the dispersed
sample batch, CUDA-event timing, the output digest, the compiler's register
report and the kernel's occupancy. Run alone, this times the kernel by
itself and prints one JSON line with:

  * the card's name and power limit (``nvidia-smi``);
  * registers and spill bytes of each precision's build (``-Xptxas -v``);
  * at the main path's shape (B=262,144, float32, ``SimConfig(max_time=6.0)``)
    and at B=65,536 in float64: the kernel's mean ms by CUDA events over
    ``--reps`` calls of the wrapper after one warm-up call, blocks and warps
    per SM, waves, the output digest, the bound of that work
    (``flight_summary.bound_ms``) and the share of it the kernel reaches.

The walls of the main path are chip_smoke's phases 4 and 5.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

MAIN_LANES = 262_144
F64_LANES = 65_536
WINDOW = 6.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sample_batch(n, dtype, seed=0, nan_lane=None):
    """Dispersed lanes of the liquid motor on the card, ``(scene_b, ic_b)``;
    lane ``nan_lane``, if given, gets a wind table that is NaN above 2 km."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scene_b, ic_b = sample_dispersions(gen, nominal_scene(liquid_motor(dev, dtype)),
                                       InitialConditions.vertical_launch(dev, dtype),
                                       n=n)[:2]
    if nan_lane is not None:
        wind = scene_b.wind.wind.clone()
        wind[nan_lane, scene_b.wind.altitudes > 2000.0] = float("nan")
        scene_b = dataclasses.replace(
            scene_b, wind=dataclasses.replace(scene_b.wind, wind=wind))
    return scene_b, ic_b


def cuda_ms(fn, reps=1):
    """Mean ms per call of ``fn`` by CUDA events, and its last result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def digest(out: dict) -> str:
    """SHA-256 (first 16 hex digits) of a ``flight_summary`` result: its
    float rows in ``SUMMARY_KEYS`` order, then its integer rows, as bytes,
    with every NaN replaced by one canonical NaN first (the payload of a NaN
    is not part of the result)."""
    from erpl_monte_carlo_sim_tpu_torch.engine.component import INT_KEYS, SUMMARY_KEYS

    h = hashlib.sha256()
    for k in SUMMARY_KEYS:
        a = out[k].detach().cpu().numpy().copy()
        if k not in INT_KEYS:
            a[np.isnan(a)] = np.nan
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def ptxas_usage(log: str) -> dict:
    """``{"f32": {"regs", "spill_stores", "spill_loads"}, "f64": ...}`` from
    the ``-Xptxas -v`` log of ``flight_summary.build``."""
    usage = {}
    for sec in re.split(r"^\[(f32|f64)\]$", log, flags=re.M)[1:]:
        if sec in ("f32", "f64"):
            name = sec
            continue
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", sec)]
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", sec)
        usage[name] = {"regs": max(regs) if regs else None,
                       "spill_stores": max((int(s) for s, _ in spills), default=0),
                       "spill_loads": max((int(l) for _, l in spills), default=0)}
    return usage


def occupancy(fs, dtype_key, scene_nw, grid):
    """``(threads, blocks per SM)`` of the loaded build for these tables,
    asked of the CUDA runtime through the library's
    ``flight_summary_occupancy_{f32,f64}``."""
    sizes = [scene_nw.rocket.cd_mach.numel(), scene_nw.rocket.cp_shift_mach.numel(),
             scene_nw.motor.curve_time.numel(), grid.numel()]
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    rc = getattr(fs._load(), f"flight_summary_occupancy_{dtype_key}")(
        (ctypes.c_int * 4)(*sizes), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (CUDA error {rc})")
    return threads.value, blocks.value


def measure(reps) -> dict:
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    _, log = fs.build(verbose=True)
    rec = {"card": card_line(), "ptxas": ptxas_usage(log)}
    window = SimConfig(max_time=WINDOW)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, n, dtype in (("f32", MAIN_LANES, torch.float32),
                           ("f64", F64_LANES, torch.float64)):
        args = prepare_batch(*sample_batch(n, dtype))
        fs.flight_summary(*args, window)  # warm-up
        ms, out = cuda_ms(lambda: fs.flight_summary(*args, window), reps)
        threads, blocks = occupancy(fs, name, args[0], args[1])
        b = fs.bound_ms(out, window, dtype, fs.input_bytes(*args))
        rec[name] = {"lanes": n, "ms": ms, "threads": threads, "blocks_per_sm": blocks,
                     "warps_per_sm": blocks * threads // 32,
                     "waves": n / (blocks * sms * threads), "digest": digest(out),
                     "bound_ms": b.ms, "bound_by": b.by, "lane_steps": b.lane_steps,
                     "share_of_bound": b.ms / ms}
        del args, out
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", help="also append the line to this file")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    line = json.dumps(measure(a.reps))
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
