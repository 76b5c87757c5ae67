"""Measure the whole-flight kernel on one NVIDIA GPU.

    python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.measure [--reps 3] [--out FILE]
    python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.measure --draw [--sass FILE] [--out FILE]
    python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.measure --record [--out FILE]

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

With ``--draw`` it profiles the main path's draw instead: the analyzer's
seam ``_draw_single`` at 262,144 lanes (seed 0, ``SimConfig(max_time=6.0)``),
its wall (median of 5 warm calls, the card synchronized around each), the
kernels one draw runs (``device_launches``), its peak of device memory above
what was allocated before it, and one ``torch.profiler`` pass over 3 warm
calls: the ops by host time and by device time, with the device's busy
time and its share of the wall. Where the threefry kernels exist it also
counts the opcodes of each of their instantiations in ``cuobjdump -sass``
(``--sass`` keeps the listing), and where the AR(1) kernel exists it times
it alone (``ar1_timing``: the fused chain, the recursion on a given driver,
beside their bounds and the given driver's one library call). The draw is
imported from ``sys.path``: run this file by its path with ``PYTHONPATH``
at another checkout to profile that checkout's draw.

With ``--record`` it times the recording build (``flight_record``'s
kernels) alone, by CUDA events over ``--reps`` launches after two warm ones
(``warm_ms``), on preallocated frames (the wrapper's gather of the frames
left out): phase 4's window in float32 at ``RECORD_WINDOW_LANES`` lanes of
the sample batch, and chip_smoke phase 10's inputs (``phase10_inputs``: 256
lanes of phase 4's run in float32 and float64, 256 of phase 7's stabilized
full flights in float32 and 64 of them in float64). Each case: ms (and
the derived pass alone where the build has one), registers and spills of
each kernel of the build, threads per block and warps per SM, the bound
(``flight_summary.bound_ms``) and the latency floor (``latency_floor``)
with the shares of each, and the digest of the records
(``records_digest``; phase 10's are chip_smoke's ``RECORD_DIGESTS``). Like
``--draw``, it flies the package on ``sys.path``: run it by its path with
``PYTHONPATH`` at another checkout to time that checkout's build in the
same call (a build without a derived pass, as before it had one, is timed
whole).
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
from collections import deque

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
# --record: the window's lanes in float32 (a single flight, the per-sim
# exports, re-simulation, the envelope's frame chunks); chip_smoke phase
# 10's lanes re-simulated and, of them, those flown to landing in float64
RECORD_WINDOW_LANES = (1, 50, 256, 1024, 4096)
RESIM_LANES = 256
RESIM_F64_LANES = 64


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
    """Dispersed lanes of the liquid motor on the card under
    ``PRNGKey(seed)``, ``(scene_b, ic_b)``; lane ``nan_lane``, if given, gets
    a wind table that is NaN above 2 km."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu_torch import random

    dev = torch.device("cuda")
    scene_b, ic_b = sample_dispersions(random.prng_key(seed), nominal_scene(liquid_motor(dev, dtype)),
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


def map_tensors(fn, x):
    """``fn`` applied to every tensor of prepared inputs or an output dict."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: map_tensors(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    return fn(x) if isinstance(x, torch.Tensor) else x


def head(x, lanes: int, n: int):
    """The first ``n`` of ``lanes`` lanes of prepared inputs or of an output
    dict: every tensor whose first dimension is ``lanes`` is cut; shared
    leaves (tables, the grid, shared scalars) stay."""
    return map_tensors(
        lambda t: t[:n].contiguous() if t.ndim >= 1 and t.shape[0] == lanes else t, x)


def widened(args):
    """Prepared inputs in float64, every float widened exactly."""
    return map_tensors(lambda t: t.double() if t.is_floating_point() else t, args)


def spread(n_run: int, n: int) -> np.ndarray:
    """``n`` lane ids spread evenly over a run of ``n_run`` lanes."""
    return np.linspace(0, n_run - 1, n).round().astype(np.int64)


def cuda_ms(fn, reps=1):
    """Mean ms per call of ``fn`` by CUDA events, and its last result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def warm_ms(fn, reps=5):
    """``cuda_ms`` of ``fn`` after two warm calls whose outputs are alive at
    once, as the timed loop keeps its last output alive while it makes the
    next: the allocator then holds both blocks, and no timed call waits on
    ``cudaMalloc``."""
    first = fn()
    second = fn()
    del first, second
    return cuda_ms(fn, reps)


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


def kernel_ptxas(log: str, kinds: dict) -> dict:
    """The largest registers and spills of each group of a ``-Xptxas -v``
    log's entry functions: ``kinds`` maps a group's name to a substring of
    its functions' (mangled) names, e.g. ``{"draw": "threefry_kernel",
    "ar1": "ar1_kernel"}``."""
    sections = re.split(r"Compiling entry function '(\S+)'", log)[1:]
    groups = {name: "" for name in kinds}
    for fn, sec in zip(sections[::2], sections[1::2]):
        for name, part in kinds.items():
            if part in fn:
                groups[name] += sec
    return {name: ptxas_usage("[f32]\n" + sec)["f32"] for name, sec in groups.items()}


def device_launches(fn) -> tuple[int, object]:
    """The kernels ``fn()`` runs on the card, counted by one
    ``torch.profiler`` pass (the device's kernel events; copies and fills
    not counted), and its result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), out


def occupancy(fs, dtype_key, scene_nw, grid, flags=None, kernel="flight_summary"):
    """``(threads, blocks per SM)`` of a build's flight kernel (parity by
    default; a recording build's derived pass with ``kernel=
    "flight_record_derived"``) for these tables, asked of the CUDA runtime
    through the library's ``{kernel}_occupancy_{f32,f64}``."""
    sizes = [scene_nw.rocket.cd_mach.numel(), scene_nw.rocket.cp_shift_mach.numel(),
             scene_nw.motor.curve_time.numel(), grid.numel()]
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    rc = getattr(fs._load(flags or fs.PARITY), f"{kernel}_occupancy_{dtype_key}")(
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


# a SASS instruction: its address comment, an optional predicate, the opcode
# with its modifiers
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(listing: str) -> dict:
    """Each function of a ``cuobjdump -sass`` listing, by name: its opcode
    counts (``IADD3``, ``LOP3``, ``SHF``, ...; modifiers dropped) under
    ``all``, and under ``after_barrier`` those of the instructions after its
    last ``BAR.SYNC`` (modifiers kept: ``IMAD.IADD``, ``SHF.L.W.U32.HI``),
    where the threefry kernel's threads hash their own words."""
    funcs, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _SASS_OP.search(line)
        if name and m:
            funcs[name].append(m.group(1))
    out = {}
    for name, ops in funcs.items():
        bar = max((i for i, op in enumerate(ops) if op.startswith("BAR.SYNC")), default=-1)
        out[name] = {"all": _histogram(op.split(".")[0] for op in ops),
                     "after_barrier": _histogram(ops[bar + 1:])}
    return out


def _histogram(ops) -> dict:
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def ar1_timing(lanes: int, n_knots: int = 100, reps: int = 5) -> dict:
    """The AR(1) kernel at the main path's shape (float32, the synthesized
    wind's chain ``sub=1`` under seed 0's turbulence key): the fused chain's
    mean ms by CUDA events over ``reps`` calls after a warm-up, its bound
    (``threefry.ar1_bound_ms``), share and occupancy; the same for the
    recursion on a given driver (``torch.randn``'s), beside the one library
    call that computes that recursion, ``torch.einsum`` of the driver with
    ``ar1_transfer_matrix`` (float32; timed and compared only, since it
    rounds otherwise than the loop the kernel must equal); and the two launches
    the chain replaced (the draw kernel writing the normals, then the
    recursion on them). The outputs are returned under ``out``."""
    from erpl_monte_carlo_sim_tpu_torch import random
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
    from erpl_monte_carlo_sim_tpu_torch.models import WindModelParams
    from erpl_monte_carlo_sim_tpu_torch.models.wind import _ar1_constants, ar1_transfer_matrix

    dev, f32 = torch.device("cuda"), torch.float32
    key = random.split(random.prng_key(0, dev), 12)[11]
    grid = torch.linspace(0.0, 25_000.0, n_knots, dtype=f32, device=dev)
    params = WindModelParams.create(dev, f32)
    consts = _ar1_constants(params, grid, f32)
    chain = dict(key=key, lanes=lanes, sub=1)
    ms, turb = warm_ms(lambda: tf.ar1(*consts, **chain), reps)
    bound, by = tf.ar1_bound_ms(lanes, n_knots)
    threads, blocks = tf.occupancy("ar1")
    noise = torch.randn(lanes, n_knots, 3, device=dev)
    given_ms, given = warm_ms(lambda: tf.ar1(*consts, noise=noise), reps)
    given_bound, given_by = tf.ar1_bound_ms(lanes, n_knots, given=True)
    g_threads, g_blocks = tf.occupancy("ar1_noise")
    a = torch.tensor(ar1_transfer_matrix(params, grid.cpu().numpy()), dtype=f32, device=dev)
    vert = torch.tensor([1.0, 1.0, 0.3], dtype=f32, device=dev)

    def library():
        return torch.einsum("ij,njc,c->nic", a, noise, vert)

    library_ms, lib_out = warm_ms(library, reps)
    library_err = float((lib_out - given).abs().max())
    del noise, given, lib_out
    def draw():
        return tf.draw(key, "normal", (n_knots, 3), dtype=f32, lanes=lanes, sub=1)

    draw_ms, _ = warm_ms(draw, reps)
    two_ms, _ = warm_ms(lambda: tf.ar1(*consts, noise=draw()), reps)
    return {"lanes": lanes, "knots": n_knots, "ms": ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32,
            "given_ms": given_ms, "given_bound_ms": given_bound, "given_bound_by": given_by,
            "given_share_of_bound": given_bound / given_ms,
            "given_warps_per_sm": g_blocks * g_threads // 32,
            "given_library_ms": library_ms, "given_library_err": library_err,
            "draw_kernel_chain_ms": draw_ms, "draw_then_recursion_ms": two_ms, "out": turb}


def draw_profile(lanes: int, sass_out=None) -> dict:
    """The ``--draw`` measurement (module docstring)."""
    import importlib.util
    import time

    from torch.profiler import ProfilerActivity, profile

    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    dev = torch.device("cuda")
    rec = {"card": card_line(), "package": os.path.dirname(analyzer_mod.__file__),
           "lanes": lanes}
    tf = None
    if importlib.util.find_spec("erpl_monte_carlo_sim_tpu_torch.kernels.threefry"):
        from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf

        lib, _ = tf.build()
        listing = subprocess.run(
            [os.path.join(os.path.dirname(tf._nvcc()), "cuobjdump"), "-sass", lib], capture_output=True, text=True, check=True, timeout=300).stdout
        if sass_out:
            with open(sass_out, "w") as f:
                f.write(listing)
        rec["sass"] = sass_counts(listing)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW))
    ic = InitialConditions.vertical_launch(dev)
    wind = mc._base_wind()

    def draw():
        return analyzer_mod._draw_single(mc, ic, lanes, 0, wind)

    for _ in range(2):
        draw()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    rec["wall_ms"] = walls
    rec["wall_ms_median"] = float(np.median(walls))
    rec["draw_kernels"], _ = device_launches(draw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = draw()
    torch.cuda.synchronize()
    rec["draw_peak_mb"] = (torch.cuda.max_memory_allocated() - before) / 2**20
    del out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            draw()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = [{"op": e.key, "calls": e.count, "host_self_ms": e.self_cpu_time_total / 3e3,
             "device_self_ms": device_us(e) / 3e3} for e in events]
    # the card's own work: kernels and copies (no host time), not the ops
    # that launched them, which carry the same device time
    rec["device_busy_ms"] = sum(r["device_self_ms"] for r in rows if r["host_self_ms"] == 0)
    rec["host_self_ms"] = sum(r["host_self_ms"] for r in rows)
    rec["by_host"] = sorted(rows, key=lambda r: -r["host_self_ms"])[:25]
    rec["by_device"] = sorted(rows, key=lambda r: -r["device_self_ms"])[:25]
    if hasattr(tf, "ar1"):  # the AR(1) kernel, alone
        rec["ar1"] = {k: v for k, v in ar1_timing(lanes).items() if k != "out"}
    return rec


def records_digest(recs: dict) -> str:
    """SHA-256 (first 16 hex digits) of ``flight_record``'s records up to
    the last lane's stop frame (the frames after it are copies): each lane's
    stop frame (int64), then the time and state channels in ``FRAME_KEYS``
    order and the derived channels in theirs, as bytes, every NaN made
    canonical."""
    from erpl_monte_carlo_sim_tpu_torch.engine.component import FRAME_KEYS

    stop = recs["valid"].sum(0).to(torch.int64) - 1
    n = int(stop.max()) + 1
    h = hashlib.sha256(stop.cpu().numpy().tobytes())
    for t in [recs[k] for k in FRAME_KEYS] + list(recs["derived"].values()):
        a = t[:n].cpu().numpy().copy()
        a[np.isnan(a)] = np.nan
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def phase10_inputs(dev) -> dict:
    """chip_smoke phase 10's recorded inputs, ``name: (prepared inputs,
    SimConfig)``: ``10a f32``, 256 lanes spread over phase 4's run (262,144
    lanes, seed 0, the 6 s window), and ``10a f64`` the same widened;
    ``10b f32``, the same lanes of phase 7's run of stabilized full flights,
    and ``10b f64`` the first 64 of them widened."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    ic = InitialConditions.vertical_launch(dev)
    ids = spread(MAIN_LANES, RESIM_LANES)
    out = {}
    for tag, cfg in (("10a", SimConfig(max_time=WINDOW)), ("10b", flag_set("full_flights")[0])):
        mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg)
        mc.run_monte_carlo(ic, n_samples=MAIN_LANES, seed=0)
        args = prepare_batch(*mc._select_lanes(ids))
        n64 = RESIM_LANES if tag == "10a" else RESIM_F64_LANES
        out[f"{tag} f32"] = (args, cfg)
        out[f"{tag} f64"] = (widened(head(args, RESIM_LANES, n64)), cfg)
        del mc
    return out


def record_ptxas(log: str) -> dict:
    """``{"f32": {"flight": usage, "derived": usage}, "f64": ...}`` from the
    ``-Xptxas -v`` log of a recording build: the flight kernel's and the
    derived pass's registers and spills (``ptxas_usage``; the derived pass's
    ``regs`` are None in a build without one)."""
    out = {}
    for sec in re.split(r"^(?=\[f(?:32|64)\]$)", log, flags=re.M):
        m = re.match(r"\[(f32|f64)\]", sec)
        if m:
            out[m.group(1)] = kernel_ptxas(sec, {"flight": "flight_summary_kernel",
                                                 "derived": "record_derived_kernel"})
    return out


# a cuobjdump -sass instruction: its address, guard predicate, opcode and
# operands
_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _sccs(succ: list) -> list:
    """The strongly connected components of a graph (``succ[i]``: node i's
    successors), each a list of nodes; iterative Tarjan."""
    index, low, on, stack, comps, n = {}, {}, set(), [], [], 0
    for root in range(len(succ)):
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            v, i = work.pop()
            if i == 0:
                index[v] = low[v] = n
                n += 1
                stack.append(v)
                on.add(v)
            if i < len(succ[v]):
                work.append((v, i + 1))
                w = succ[v][i]
                if w not in index:
                    work.append((w, 0))
                elif w in on:
                    low[v] = min(low[v], index[w])
                continue
            for w in succ[v]:
                if w in on:
                    low[v] = min(low[v], low[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                comps.append(comp)
    return comps


def _distances(adj: list, src: int, allowed: set) -> dict:
    """Edges from ``src`` to each node it reaches through ``allowed`` nodes
    of the graph ``adj`` (breadth first)."""
    d, todo = {src: 0}, deque([src])
    while todo:
        v = todo.popleft()
        for w in adj[v]:
            if w in allowed and w not in d:
                d[w] = d[v] + 1
                todo.append(w)
    return d


def _loop_instructions(insns: list, stages: int) -> int:
    """``step_instructions`` of one function's ``(address, guard, opcode,
    operands)`` list."""
    at = {addr: i for i, (addr, *_) in enumerate(insns)}
    succ = []
    for i, (_, guard, op, operands) in enumerate(insns):
        always = guard in (None, "@PT")
        out = []
        if op.startswith("BRA"):
            target = re.findall(r"0x[0-9a-f]+", operands)
            if target and int(target[-1], 16) in at:
                out.append(at[int(target[-1], 16)])
            if not (always and not re.search(r"\bU?P[0-7T]\b", operands)):
                out.append(i + 1)
        elif not ((op.startswith(("EXIT", "RET", "BRX", "JMX")) and always)):
            out.append(i + 1)  # a CALL returns to the next instruction
        succ.append([j for j in out if j < len(insns)])
    pred = [[] for _ in insns]
    for i, out in enumerate(succ):
        for j in out:
            pred[j].append(i)

    def entered(nodes):  # the nodes of a loop entered from outside it
        return {j for j in nodes if any(i not in nodes for i in pred[j])}

    # the main loop: the largest cycle; the stage loop: the largest cycle in
    # it once the edges back to its head are cut
    main = set(max(_sccs(succ), key=len))
    heads = entered(main)
    inner = [[j for j in succ[i] if j in main and j not in heads] if i in main else []
             for i in range(len(insns))]
    stage = set(max((c for c in _sccs(inner) if len(c) > 1 or c[0] in inner[c[0]]), key=len))
    best = None
    for head in entered(stage):
        around = _distances(succ, head, stage)  # inside the stage loop
        back = _distances(pred, head, main)  # to the stage loop's head, backwards
        cycle = min(around[i] + 1 for i in pred[head] if i in around)
        step = min(around[i] + 1 + back[j] for i in around for j in succ[i]
                   if j in back and j not in stage)
        n = step + (stages - 1) * cycle
        best = n if best is None else min(best, n)
    return best


def step_instructions(listing: str, stages: int = 4) -> dict:
    """The fewest SASS instructions a main-loop step of each precision's
    flight kernel can issue, from a ``cuobjdump -sass`` listing: ``{"f32":
    n, "f64": n}``. On the kernel's control-flow graph (an instruction's
    successors: the next one, unless it is an unconditional branch, exit or
    return, and a branch's target; a call returns to the next one), the main
    loop is the largest strongly connected component and the RK4 stage loop
    the largest one inside it once the edges back to the main loop's head
    are cut. A step is the shortest walk from the stage loop's head that
    leaves the stage loop and comes back to the head, plus the stage loop's
    shortest cycle ``stages - 1`` times more: every branch takes its cheaper
    side, an inner loop (a table's knot window) runs once, and a subroutine
    called from the loop (the slow paths of a division or a square root)
    not at all. It is a lower bound: no lane's step issues fewer."""
    funcs, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _SASS_INSN.search(line)
        if name and m:
            guard = m.group(2).strip() if m.group(2) else None
            funcs[name].append((int(m.group(1), 16), guard, m.group(3), m.group(4)))
    out = {}
    for name, insns in funcs.items():
        if "flight_summary_kernel" not in name or not insns:
            continue
        key = "f32" if "CfgEPf" in name else ("f64" if "CfgEPd" in name else None)
        if key:
            out[key] = _loop_instructions(insns, stages)
    return out


def sm_clock_mhz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def latency_floor(max_steps: int, instructions: int, clock_mhz: float) -> float:
    """The least ms one lane's serial chain could take: its ``max_steps``
    main-loop steps of at least ``instructions`` SASS instructions each
    (``step_instructions``), issued at one a clock for its warp at
    ``clock_mhz``. The rail steps and the set-up are left out."""
    return max_steps * instructions / (clock_mhz * 1e3)


def sass_listing(lib: str) -> str:
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    cuobjdump = os.path.join(os.path.dirname(fs._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=600).stdout


def record_case(fs, args, cfg, reps, usage, instructions, clock) -> dict:
    """One recording-build case on prepared inputs ``args`` (module
    docstring, ``--record``): the build's C entries launched on arguments
    laid out once (``entry_args``, ``derived_args``), so that the host's
    preparation of a call is not timed, and the frames allocated once; each
    launch writes them anew. The launches are not counted."""
    lay = fs.record_layout(cfg)
    dtype, n = args[3][0].dtype, args[3][0].shape[0]
    key = "f32" if dtype == torch.float32 else "f64"
    frames = torch.empty((lay.n_frames, lay.n_channels, n), dtype=dtype, device="cuda")
    stop = torch.empty(n, dtype=torch.int32, device="cuda")
    out_f = torch.empty((len(fs._FLOAT_KEYS), n), dtype=dtype, device="cuda")
    out_i = torch.empty((len(fs.INT_KEYS), n), dtype=torch.int32, device="cuda")
    table, kcfg = fs.expanded(args[2], cfg)
    a = fs._kernel_args(args[0], args[1], table, args[3], kcfg, record=True)
    lib, stream = fs._load(a.build), torch.cuda.current_stream().cuda_stream
    launches = [(getattr(lib, fs.entry_name(a.build, key)),
                 fs.entry_args(a, kcfg, out_f, out_i, stream, (frames, stop, lay)))]
    if lay.mask and hasattr(lib, f"flight_record_derived_{key}"):  # the derived pass
        launches.append((getattr(lib, f"flight_record_derived_{key}"),
                         fs.derived_args(a, frames, stop, lay, stream)))

    def launch(which):
        for fn, fn_args in which:
            if fn(*fn_args) != 0:
                raise RuntimeError("recording build launch failed")

    ms, _ = warm_ms(lambda: launch(launches), reps)
    res = fs._outputs(out_f, out_i)
    recs = fs.unpack_frames(frames, stop, lay)
    threads, blocks = occupancy(fs, key, args[0], args[1], a.build)
    b = fs.bound_ms(res, cfg, dtype, fs.input_bytes(*args, cfg), recs)
    steps = int(res["n_steps"].max())
    use = usage[key]
    row = {"lanes": n, "frames": lay.n_frames, "valid_frames": int(recs["valid"].sum()),
           "channels": lay.n_channels, "ms": ms, "regs": use["flight"]["regs"],
           "spill_bytes": use["flight"]["spill_stores"] + use["flight"]["spill_loads"],
           "threads_per_block": threads, "blocks_per_sm": blocks,
           "warps_per_sm": blocks * threads // 32, "max_steps": steps,
           "bound_ms": b.ms, "bound_by": b.by, "share_of_bound": b.ms / ms,
           "digest": records_digest(recs)}
    if instructions.get(key):
        floor = latency_floor(steps, instructions[key], clock)
        row.update(step_instructions=instructions[key], latency_floor_ms=floor,
                   share_of_floor=floor / ms)
    if len(launches) > 1:
        dms, _ = warm_ms(lambda: launch(launches[1:]), reps)
        db = fs.derived_bound_ms(recs, dtype)
        dthreads, dblocks = occupancy(fs, key, args[0], args[1], a.build,
                                      kernel="flight_record_derived")
        row["derived"] = {"ms": dms, "bound_ms": db.ms, "bound_by": db.by,
                          "share_of_bound": db.ms / dms, "frames": db.lane_steps,
                          "regs": use["derived"]["regs"],
                          "spill_bytes": use["derived"]["spill_stores"]
                          + use["derived"]["spill_loads"],
                          "threads_per_block": dthreads, "warps_per_sm": dblocks * dthreads // 32}
        # the records once more, after the derived pass timed alone
        if records_digest(fs.unpack_frames(frames, stop, lay)) != row["digest"]:
            raise AssertionError("the derived pass timed alone moved the records")
    del frames, stop, recs, res, out_f, out_i
    torch.cuda.empty_cache()
    return row


def record_cases(dev) -> dict:
    """``name: (prepared inputs, SimConfig)`` of ``--record``: the window in
    float32 at ``RECORD_WINDOW_LANES`` lanes, then ``phase10_inputs``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch

    window = SimConfig(max_time=WINDOW)
    cases = {f"window f32 {n}": (prepare_batch(*sample_batch(n, torch.float32)), window)
             for n in RECORD_WINDOW_LANES}
    cases.update(phase10_inputs(dev))
    return cases


def record_profile(reps: int) -> dict:
    """The ``--record`` measurement (module docstring)."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    record_builds = {"parity": fs.PARITY._replace(record=True),
                     "full_flights": flag_set("full_flights")[2]._replace(record=True)}
    clock = sm_clock_mhz()
    logs = fs.build_many(list(record_builds.values()), verbose=True)
    usage = {name: record_ptxas(log) for name, (_, log) in zip(record_builds, logs)}
    sass = {name: step_instructions(sass_listing(lib))
            for name, (lib, _) in zip(record_builds, logs)}
    rows = {}
    for name, (args, cfg) in record_cases(torch.device("cuda")).items():
        build = "full_flights" if name.startswith("10b") else "parity"
        rows[name] = record_case(fs, args, cfg, reps, usage[build], sass[build], clock)
    return {"card": card_line(), "package": os.path.dirname(os.path.dirname(fs.__file__)),
            "clocks_max_sm_mhz": clock, "ptxas": usage, "step_instructions": sass,
            "cases": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", help="also append the line to this file")
    p.add_argument("--draw", action="store_true", help="profile the main path's draw")
    p.add_argument("--sass", help="with --draw: write the threefry kernel's SASS here")
    p.add_argument("--record", action="store_true", help="time the recording build alone")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    if a.record:
        line = json.dumps(record_profile(a.reps))
    elif a.draw:
        line = json.dumps(draw_profile(MAIN_LANES, a.sass))
    else:
        line = json.dumps(measure(a.reps))
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
