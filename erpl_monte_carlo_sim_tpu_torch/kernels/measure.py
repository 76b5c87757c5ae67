"""Measure the whole-flight kernel on one NVIDIA GPU.

    python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.measure [--reps 3] [--out FILE]

The helpers here are also ``chip_smoke.py``'s: the card line, the dispersed
sample batch, the catalogue of flag sets (``FLAG_SETS``), CUDA-event timing,
the output digest, the compiler's register report and the kernel's
occupancy. Run alone, this times the kernel by itself and prints one JSON
line with:

  * the card's name and power limit (``nvidia-smi``);
  * registers and spill bytes of each precision's build (``-Xptxas -v``), for
    the parity build and each build of ``FLAG_SETS``;
  * at the main path's shape (B=262,144, float32, ``SimConfig(max_time=6.0)``)
    and at B=65,536 in float64: the parity kernel's mean ms by CUDA events
    over ``--reps`` calls of the wrapper after one warm-up call, blocks and
    warps per SM, waves, the output digest, the bound of that work
    (``flight_summary.bound_ms``) and the share of it the kernel reaches;
    under ``flag_sets``, the same for each build of ``FLAG_SETS``.

The walls of the main path are chip_smoke's phases 4, 5 and 7.
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

# scripts/full_flights.py's configuration: stabilized aero, tiered timestep
FULL_FLIGHTS = dict(energy_consistent_aero=True, descent_dt_scale=16,
                    ascent_q_threshold=8000.0)
# The catalogue of flag sets, name: (SimConfig fields,
# RocketParams.stall_limited_moments). First each opt-in alone (``OPT_INS``);
# ascent_q_threshold acts only in the tiered loop, so alone it runs the
# parity build. The speed guard of 60 m/s is passed about 0.5 s after rail
# exit.
OPT_INS = {
    "rk2": (dict(integrator="rk2"), False),
    "wind_eval_per_step": (dict(wind_eval_per_step=True), False),
    "wind_table_bf16": (dict(wind_table_bf16=True), False),
    "energy_consistent_aero": (dict(energy_consistent_aero=True), False),
    "stall_limited_moments": ({}, True),
    "speed_guard": (dict(speed_guard=60.0), False),
    "terminate_nonfinite": (dict(terminate_nonfinite=False), False),
    "descent_dt_scale": (dict(descent_dt_scale=16), False),
    "ascent_q_threshold": (dict(ascent_q_threshold=8000.0), False),
}
# then the full-flight set and that set with rk2
FLAG_SETS = {
    **OPT_INS,
    "full_flights": (FULL_FLIGHTS, False),
    "full_flights+rk2": (dict(FULL_FLIGHTS, integrator="rk2"), False),
}
# the catalogue's sets combined, for runs that pay for each build (the
# kernel's tests build every one with g++ or nvcc): id: catalogue names
COMBINED = {
    "rk2+wind_per_step+bf16": ("rk2", "wind_eval_per_step", "wind_table_bf16"),
    "energy+stall+no_terminate": ("energy_consistent_aero", "stall_limited_moments",
                                  "terminate_nonfinite"),
    "speed_guard": ("speed_guard",),
    "full_flights": ("full_flights",),
    "full_flights+rk2": ("full_flights+rk2",),
}
# propellant masses of tests/test_descent.py's low-apogee scenes, kg
LOW_APOGEE_PROPELLANT = (5.0, 7.0)


def combined(names) -> tuple:
    """``(SimConfig fields, stall_limited_moments)`` of catalogue sets
    flown together."""
    fields = {}
    for name in names:
        fields.update(FLAG_SETS[name][0])
    return fields, any(FLAG_SETS[name][1] for name in names)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flag_set(name: str, **cfg_fields):
    """``(SimConfig, stall_limited_moments, build)`` of a ``FLAG_SETS``
    entry, with ``cfg_fields`` (a window's ``max_time``) on top."""
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    fields, stall = FLAG_SETS[name]
    cfg = SimConfig(**{**fields, **cfg_fields})
    return cfg, stall, fs.kernel_flags(cfg, stall)


def with_stall(scene_b, stall: bool = True):
    """The scene with ``RocketParams.stall_limited_moments`` set."""
    return dataclasses.replace(
        scene_b, rocket=dataclasses.replace(scene_b.rocket, stall_limited_moments=stall))


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


def low_apogee_batch(device, dtype):
    """The low-apogee scenes of tests/test_descent.py (liquid motor and
    rocket with ``LOW_APOGEE_PROPELLANT``, 5 and 7 kg: apogee about 476 and
    880 m, below the 1 km apogee gate, the chute latched at once) as the two
    lanes of one batch, vertical launch, no wind: ``(scene_b, ic_b)``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.models import (RocketParams, WindField,
                                                       liquid_motor, nominal_scene)

    motors = [liquid_motor(device, dtype, propellant_mass=pm) for pm in LOW_APOGEE_PROPELLANT]
    rockets = [RocketParams.create(device, dtype, propellant_mass=pm)
               for pm in LOW_APOGEE_PROPELLANT]

    def merge(x, y):  # a leaf the two scenes share stays shared
        fields = {}
        for f in dataclasses.fields(x):
            a, b = getattr(x, f.name), getattr(y, f.name)
            if isinstance(a, torch.Tensor):
                fields[f.name] = a if torch.equal(a, b) else torch.stack([a, b])
        return dataclasses.replace(x, **fields)

    scene = dataclasses.replace(nominal_scene(motors[0], WindField.zero(device, dtype)),
                                rocket=merge(*rockets), motor=merge(*motors))
    ic = InitialConditions.vertical_launch(device, dtype)
    return scene, InitialConditions(*(v.expand(2, 3).contiguous() for v in (
        ic.position, ic.velocity, ic.attitude, ic.angular_velocity)))


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


def occupancy(fs, dtype_key, scene_nw, grid, flags=None):
    """``(threads, blocks per SM)`` of a build (parity by default) for these
    tables, asked of the CUDA runtime through the library's
    ``flight_summary_occupancy_{f32,f64}``."""
    sizes = [scene_nw.rocket.cd_mach.numel(), scene_nw.rocket.cp_shift_mach.numel(),
             scene_nw.motor.curve_time.numel(), grid.numel()]
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    rc = getattr(fs._load(flags or fs.PARITY), f"flight_summary_occupancy_{dtype_key}")(
        (ctypes.c_int * 4)(*sizes), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (CUDA error {rc})")
    return threads.value, blocks.value


def time_kernel(fs, args, cfg, dtype, reps, flags=None) -> dict:
    """One build on prepared inputs ``args``: a warm-up call, then the mean
    ms of ``reps`` calls by CUDA events, with the occupancy, the output
    digest, the bound of that work and the share of it reached."""
    fs.flight_summary(*args, cfg)  # warm-up
    ms, out = cuda_ms(lambda: fs.flight_summary(*args, cfg), reps)
    key = "f32" if dtype == torch.float32 else "f64"
    threads, blocks = occupancy(fs, key, args[0], args[1], flags)
    b = fs.bound_ms(out, cfg, dtype, fs.input_bytes(*args, cfg))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = args[3][0].shape[0]
    return {"lanes": n, "ms": ms, "threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32,
            "waves": n / (blocks * sms * threads), "digest": digest(out),
            "bound_ms": b.ms, "bound_by": b.by, "lane_steps": b.lane_steps,
            "share_of_bound": b.ms / ms}


def measure(reps) -> dict:
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    names = list(FLAG_SETS)
    builds = [fs.PARITY] + [flag_set(name)[2] for name in names]
    logs = fs.build_many(builds, verbose=True)
    usage = [ptxas_usage(log) for _, log in logs]
    rec = {"card": card_line(), "ptxas": usage[0], "flag_sets": {}}
    window = SimConfig(max_time=WINDOW)
    for name, n, dtype in (("f32", MAIN_LANES, torch.float32),
                           ("f64", F64_LANES, torch.float64)):
        scene_b, ic_b = sample_batch(n, dtype)
        args = prepare_batch(scene_b, ic_b)
        rec[name] = time_kernel(fs, args, window, dtype, reps)
        for set_name, use in zip(names, usage[1:]):
            cfg, stall, flags = flag_set(set_name, max_time=WINDOW)
            set_args = prepare_batch(with_stall(scene_b, stall), ic_b)
            entry = rec["flag_sets"].setdefault(set_name, {"build": fs.flags_name(flags),
                                                           "ptxas": use})
            entry[name] = time_kernel(fs, set_args, cfg, dtype, reps, flags)
        del args, scene_b, ic_b
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
