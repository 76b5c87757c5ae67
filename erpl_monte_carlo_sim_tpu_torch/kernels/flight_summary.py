"""Wrapper of the whole-flight CUDA kernel ``csrc/flight_summary.cu``.

The kernel replaces the JAX package's two Pallas TPU kernels,
``experimental/pallas_component.py::simulate_summary_component`` and
``experimental/pallas_kernel.py::simulate_summary_pallas``: one thread runs
one Monte Carlo lane's whole flight and writes every output of
``engine.component.flight_components``.

``flight_summary`` dispatches on where its tensors lie: CPU tensors run the
plain PyTorch version (``flight_summary_reference``, the eager
``flight_components``); CUDA tensors launch the kernel, or raise. There is
no fallback from one to the other.

The ``SimConfig`` opt-ins that change the loop's structure, and
``RocketParams.stall_limited_moments``, are compile-time constants of the
kernel, as they are static in the JAX package: ``kernel_flags`` reads them,
and each flag set is its own build. A build is made at first use with
``nvcc`` for ``sm_90a`` into ``erpl_monte_carlo_sim_tpu_torch/_build/`` (a
content hash of the source, the flags and the defines names the library, so
an edited source rebuilds) and bound with ``ctypes``; ``build_many`` starts
the compilers of several flag sets at once. The parity flag set
(``PARITY``) compiles to the same code as before the flags existed.
``launches`` counts flight kernel launches, of every flag set and build;
``record_launches`` counts those of the recording build alone,
``derived_launches`` those of its derived pass, ``chunk_launches`` those of
the carry build and ``fold_launches`` those of any build with the stacked
engine's speed (``KernelFlags.stacked_speed``).

The recording build (``KernelFlags.record``, ``-DFS_RECORD=1``) is the same
flight with an epilogue that writes the time and state of a frame of
``engine.component.flight_components_trajectory`` every ``record_stride``
steps, in its own launch shape (few lanes: one lane's serial chain sets
its time); a second kernel of the build, the derived pass, then computes
the frames' derived channels in parallel over (frame, lane).
``flight_record`` launches both on CUDA tensors (its summary is the summary
build's, bit for bit), and runs that recorder on CPU tensors.

The carry build (``KernelFlags.carry``, ``-DFS_CARRY=1``) flies the summary
build's flight in chunks of at most ``chunk_steps`` main-loop steps, one
launch each, the loop's variables carried in global memory between them:
``flight_summary_chunked``, the JAX package's ``simulate_batch_chunked`` on
the card, equal to the one-shot run of the same flags bit for bit. Its plain
version is the stacked engine's chunk loop (``engine.simulate``).

Besides the inputs, the wrapper hands the kernel a lane-minor ``[N, 3, B]``
copy of a per-lane wind table (a warp's loads of one knot are then
contiguous; bfloat16 under ``wind_table_bf16``) and the table flags of
``_table_flags``, which say where the kernel's shortcuts return the full
expressions' bits. ``bound_ms`` is the least time an H100 could take for
the flights of a result, from the operation count ``ops_per_step``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

from ..engine.component import (DERIVED_KEYS, FRAME_KEYS, INT_KEYS, SUMMARY_KEYS,
                                flight_components, flight_components_trajectory,
                                modes_wind_fn, n_frames, record_names, table_wind_fn)
from ..engine.config import SimConfig
from ..models.wind import WindModes, expand_modes

__all__ = ["flight_summary", "flight_summary_reference", "flight_summary_chunked",
           "flight_summary_chunked_reference", "flight_record",
           "flight_record_reference", "record_layout", "build", "build_many",
           "launches", "record_launches", "derived_launches", "chunk_launches",
           "fold_launches", "SOURCE", "KernelFlags",
           "PARITY", "kernel_flags", "flags_name", "stored_wind", "wind_fn_of", "expanded",
           "cfg_values", "ops_per_step", "bound_ms", "derived_bound_ms", "input_bytes",
           "summary_out", "run_chunks", "max_chunks", "check_chunk_steps", "carry_runs",
           "N_CARRY_F", "N_CARRY_I"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flight_summary.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

# flight kernel launches so far (the count a run reads to show the kernel
# ran), of them the recording build's, the recording build's derived pass
# launches, the carry build's flight launches (one a chunk), and the
# launches of builds with the stacked engine's speed
launches = 0
record_launches = 0
derived_launches = 0
chunk_launches = 0
fold_launches = 0

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no a*b+c contraction, so the kernel rounds as the eager
# PyTorch ops and the JAX package do, operation by operation
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]
_PRECISIONS = {torch.float32: ("1", "f32"), torch.float64: ("0", "f64")}


class KernelFlags(NamedTuple):
    """A build of the kernel: the compile-time constants, in the order of
    their ``-D`` defines (``_DEFINES``). The defaults are the parity flags."""
    rk2: bool = False                  # integrator="rk2"
    wind_per_step: bool = False        # wind_eval_per_step
    energy_aero: bool = False          # energy_consistent_aero
    stall_moments: bool = False        # RocketParams.stall_limited_moments
    tiered: bool = False               # descent_dt_scale > 1
    ascent_gate: bool = False          # tiered and ascent_q_threshold > 0
    terminate_nonfinite: bool = True   # terminate_nonfinite
    speed_guard: bool = False          # terminate_nonfinite and speed_guard != inf
    wind_bf16: bool = False            # wind_table_bf16
    record: bool = False               # the recording build (flight_record)
    stacked_speed: bool = False        # the stacked engine's speed (engine.simulate)
    carry: bool = False                # the carry build (flight_summary_chunked)


PARITY = KernelFlags()
_DEFINES = ("FS_RK2", "FS_WIND_PER_STEP", "FS_ENERGY_AERO", "FS_STALL_MOMENTS",
            "FS_TIERED", "FS_ASCENT_GATE", "FS_TERMINATE_NONFINITE", "FS_SPEED_GUARD",
            "FS_WIND_BF16", "FS_RECORD", "FS_SAFE_NORM_SPEED", "FS_CARRY")
# the defines a build names only where they are set, so that the builds
# without them keep their libraries' names
_OPT_IN_DEFINES = ("FS_SAFE_NORM_SPEED", "FS_CARRY")


def kernel_flags(cfg: SimConfig, stall_limited_moments: bool = False,
                 record: bool = False, stacked_speed: bool = False,
                 carry: bool = False) -> KernelFlags:
    """The build that runs ``cfg`` (and a rocket's ``stall_limited_moments``),
    its recording build with ``record``, with the stacked engine's speed
    with ``stacked_speed``, its carry build with ``carry``. A flag that
    changes nothing is off:
    the ascent gate acts only in the tiered loop, an infinite speed guard
    never trips where the non-finite stop does not, and neither guard acts
    without ``terminate_nonfinite``."""
    tiered = cfg.descent_dt_scale > 1
    return KernelFlags(
        rk2=cfg.integrator == "rk2", wind_per_step=cfg.wind_eval_per_step,
        energy_aero=cfg.energy_consistent_aero,
        stall_moments=bool(stall_limited_moments), tiered=tiered,
        ascent_gate=tiered and cfg.ascent_q_threshold > 0.0,
        terminate_nonfinite=cfg.terminate_nonfinite,
        speed_guard=cfg.terminate_nonfinite and cfg.speed_guard != math.inf,
        wind_bf16=cfg.wind_table_bf16, record=bool(record),
        stacked_speed=bool(stacked_speed), carry=bool(carry))


def flags_name(flags: KernelFlags) -> str:
    """A short name of a flag set: the fields away from parity."""
    diff = [f for f in KernelFlags._fields if getattr(flags, f) != getattr(PARITY, f)]
    return "+".join(f if getattr(flags, f) else f"no_{f}" for f in diff) or "parity"


# scalar leaves in the kernel's Leaf order: (scene part, field)
_SCENE_LEAVES = (
    ("rocket", "diameter"), ("rocket", "fin_span"), ("rocket", "fin_root_chord"),
    ("rocket", "fin_tip_chord"), ("rocket", "fin_sweep_angle"), ("rocket", "dry_mass"),
    ("rocket", "propellant_mass"), ("rocket", "center_of_mass_dry"),
    ("rocket", "Ixx_dry"), ("rocket", "Iyy_dry"), ("rocket", "reference_area"),
    ("rocket", "reference_diameter"), ("rocket", "cp_location"),
    ("rocket", "parachute_area"), ("rocket", "parachute_cd"),
    ("rocket", "parachute_deployment_altitude"), ("rocket", "power_off_drag_factor"),
    ("motor", "nozzle_exit_area"), ("motor", "burn_time"), ("motor", "mass_flow_rate"),
    ("motor", "thrust_scale"),
    ("atmosphere", "sea_level_pressure"), ("atmosphere", "sea_level_temperature"),
    ("atmosphere", "temperature_lapse_rate"), ("atmosphere", "gas_constant"),
    ("atmosphere", "gravity"), ("atmosphere", "gamma"),
    ("atmosphere", "troposphere_height"), ("atmosphere", "stratosphere_height"),
    ("atmosphere", "stratosphere_temp"), ("atmosphere", "density_scale"),
)
# shared [K] tables, always one copy for the whole batch, in kernel order
_TABLES = (
    ("rocket", "cd_mach"), ("rocket", "cd0_table"), ("rocket", "cda_table"),
    ("rocket", "cp_shift_mach"), ("rocket", "cp_shift_table"),
    ("motor", "curve_time"), ("motor", "curve_thrust_sl"),
)
_N_LEAVES = len(_SCENE_LEAVES) + 12
_FLOAT_KEYS = tuple(k for k in SUMMARY_KEYS if k not in INT_KEYS)

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the flight_summary kernel")
    return path


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _library(flags: KernelFlags, src: bytes) -> tuple[str, list]:
    defines = [f"-D{d}={int(v)}" for d, v in zip(_DEFINES, flags)
               if v or d not in _OPT_IN_DEFINES]
    key = hashlib.sha256(src + " ".join(_ARCH + _FLAGS + defines).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"flight_summary_{key}.so"), defines


def build_many(flag_sets, verbose: bool = False) -> list:
    """Compile the kernel for each flag set that has no hashed library yet:
    every object (float and double of every set) by its own ``nvcc``, all
    started at once, then one shared library per set. Returns ``(library
    path, compiler log)`` per set; ``verbose`` adds ``-Xptxas -v``
    (registers, spills) and rebuilds. The float objects are built with
    ``-Xptxas -warn-double-usage``, and any such warning fails the build."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    extra = ["-Xptxas", "-v"] if verbose else []
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for flags in flag_sets:
        if flags.record and flags.carry:
            raise ValueError("the carry build chunks summaries only: carry excludes record")
        lib, defines = _library(flags, src)
        if lib in jobs or (os.path.exists(lib) and not verbose):
            continue
        procs = []
        for f32, suffix in _PRECISIONS.values():
            obj = f"{lib[:-3]}_{suffix}.o"
            warn = ["-Xptxas", "-warn-double-usage"] if suffix == "f32" else []
            procs.append((suffix, obj, _run([_nvcc(), *_ARCH, *_FLAGS, *warn, *extra,
                                             f"-DFS_F32={f32}", *defines, "-c", SOURCE,
                                             "-o", obj])))
        jobs[lib] = (flags, procs)
    logs = {}
    for lib, (flags, procs) in jobs.items():
        log = []
        for suffix, _, p in procs:
            out, _ = p.communicate()
            log.append(f"[{suffix}]\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({flags_name(flags)}, {suffix}):\n{out}")
            if suffix == "f32" and "double precision" in out:
                raise RuntimeError(f"float build uses double precision "
                                   f"({flags_name(flags)}):\n{out[:4000]}")
        tmp = f"{lib}.{os.getpid()}.tmp"
        p = _run([_nvcc(), *_ARCH, "-shared", "-o", tmp, *(o for _, o, _ in procs)])
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({flags_name(flags)}):\n{out}")
        os.replace(tmp, lib)
        logs[lib] = "\n".join(log)
    return [(lib, logs.get(lib, "")) for lib, _ in (_library(f, src) for f in flag_sets)]


def build(flags: KernelFlags = PARITY, verbose: bool = False) -> tuple[str, str]:
    """``build_many`` of one flag set."""
    return build_many([flags], verbose)[0]


# the C entry's arguments (csrc/flight_summary.cu), and the recording
# build's five more
_ENTRY_ARGS = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
    ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_int), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]
_RECORD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
# and the carry build's five more
_CHUNK_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
# the derived pass's entry (flight_record_derived_*)
_DERIVED_ARGS = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_uint,
]
_OCC_ARGS = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int)]


def entry_name(flags: KernelFlags, suffix: str) -> str:
    """The C entry of a build: ``flight_record_*`` for a recording build,
    ``flight_chunk_*`` for a carry build, ``flight_summary_*`` otherwise."""
    kind = "record" if flags.record else ("chunk" if flags.carry else "summary")
    return f"flight_{kind}_{suffix}"


def _load(flags: KernelFlags = PARITY):
    lib = _libs.get(flags)
    if lib is None:
        path, _ = build(flags)
        lib = ctypes.CDLL(path)
        for _, suffix in _PRECISIONS.values():
            extra = _RECORD_ARGS if flags.record else (_CHUNK_ARGS if flags.carry else [])
            entries = [(entry_name(flags, suffix), _ENTRY_ARGS + extra),
                       (f"flight_summary_occupancy_{suffix}", _OCC_ARGS)]
            if flags.record:
                entries += [(f"flight_record_derived_{suffix}", _DERIVED_ARGS),
                            (f"flight_record_derived_occupancy_{suffix}", _OCC_ARGS)]
            for name, argtypes in entries:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[flags] = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def _supports(x: torch.Tensor):
    """Each knot's tent support as the kernel rounds it: ``(gaps, lo, hi)``
    with ``lo_j = x_j - left_j``, ``hi_j = x_j + right_j``, ``left_j`` and
    ``right_j`` the gaps to the neighbours floored at 1e-30 (1 past either
    end)."""
    d = x[1:] - x[:-1]
    gap = torch.clamp_min(d, 1e-30)
    one = torch.ones_like(x[:1])
    return d, x - torch.cat([one, gap]), x + torch.cat([gap, one])


def _window_exact(x: torch.Tensor, *ys: torch.Tensor) -> torch.Tensor:
    """Whether the kernel may sum a table on knots ``x [K]`` over the four
    knots ``i-1..i+2`` around the segment ``[x_i, x_i+1]`` that holds the
    clamped query, and get the full tent sum bit for bit (a 0-d bool tensor,
    computed on the tables' device without a sync).

    Knot ``j``'s weight is ``clip(min(up, down), 0, 1)`` with
    ``up = (xc - lo_j) / left_j`` and ``down = (hi_j - xc) / right_j``
    (``_supports``). It is +0, never -0, unless ``lo_j < xc < hi_j``. If
    every ``lo_j >= x_{j-2}`` and ``hi_j <= x_{j+2}``, no knot outside the
    window has that, and a sum that starts at +0 (and so is never -0) is
    unchanged by the +0 terms (``+0 * y`` is a signed zero for finite ``y``).
    The table and the supports must also be finite and the knots strictly
    increasing, so that the largest ``i <= K-2`` with ``x_i <= xc`` is the
    segment. In exact arithmetic ``lo_j = x_{j-1}``; the check only fails for
    knots a few ulps apart, or for gaps that overflow. Finite supports with
    ``left_j, right_j > 0`` are also what the kernel's one-division weight
    (``window_weight``) needs."""
    finite = torch.isfinite(x).all()
    for y in ys:
        finite = finite & torch.isfinite(y).all()
    d, lo, hi = _supports(x)
    return (finite & torch.isfinite(lo).all() & torch.isfinite(hi).all() & (d > 0).all()
            & (lo[2:] >= x[:-2]).all() & (hi[:-2] <= x[2:]).all())


def _table_flags(tables, grid: torch.Tensor) -> torch.Tensor:
    """The kernel's table flags, int32 ``[5]`` in its ``Flag`` order: the
    Mach (cd0, cda), CP and thrust tables window-exact; the wind grid
    non-decreasing with finite supports (its segment search may start from a
    direct index, and its window's weights skip the divisions they do not
    need); the wind grid finite."""
    cd_mach, cd0, cda, cp_mach, cp_shift, curve_t, curve_f = tables
    d, lo, hi = _supports(grid)
    return torch.stack([
        _window_exact(cd_mach, cd0, cda), _window_exact(cp_mach, cp_shift),
        _window_exact(curve_t, curve_f),
        (d >= 0).all() & torch.isfinite(lo).all() & torch.isfinite(hi).all(),
        torch.isfinite(grid).all(),
    ]).to(torch.int32)


class KernelArgs(NamedTuple):
    """The kernel's inputs as its C entry takes them."""
    n: int                 # lanes
    ptrs: list             # scalar leaves (``_SCENE_LEAVES``, then the 12 ICs)
    strides: list          # their lane strides: 0 shared, 1 per lane
    table_ptrs: list       # ``_TABLES``, the grid, the wind table, the flags
    sizes: list            # knots of the Mach, CP, thrust tables and the grid
    wind: torch.Tensor     # the wind table as the kernel reads it
    wind_lane_stride: int
    flags: torch.Tensor    # ``_table_flags``
    cfg_vals: list         # SimConfig numbers in the kernel's Cfg order
    build: KernelFlags     # the build that runs them


def stored_wind(wind: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The wind table as the flight reads it: rounded to bfloat16 under
    ``wind_table_bf16`` (the JAX package's ``engine/batch.py`` stores it so,
    and upcasts at each lookup), else as given."""
    return wind.to(torch.bfloat16) if cfg.wind_table_bf16 else wind


def wind_fn_of(grid: torch.Tensor, wind, cfg: SimConfig):
    """The plain version's wind lookup: the tent-basis lookup of a table's
    ``stored_wind``, or for ``WindModes`` the JAX package's modes query
    (``engine.component.modes_wind_fn``) with the scores rounded to
    bfloat16 under ``wind_table_bf16`` and the basis kept, as the JAX
    package stores them."""
    if isinstance(wind, WindModes):
        scores = wind.scores.to(torch.bfloat16) if cfg.wind_table_bf16 else wind.scores
        return modes_wind_fn(grid, wind.basis, scores)
    return table_wind_fn(grid, stored_wind(wind, cfg))


def expanded(wind, cfg: SimConfig):
    """``(table, cfg)`` as the kernel flies them: a table passes; a
    ``WindModes`` becomes each lane's ``[B, N, 3]`` table in the scores'
    dtype (``models.wind.expand_modes``), the same function as the modes
    query by linearity, up to the order of rounding. Under
    ``wind_table_bf16`` the scores are rounded to bfloat16 before the
    expansion, as the JAX package rounds them, and the flag is cleared, so
    that the table is not rounded a second time."""
    if not isinstance(wind, WindModes):
        return wind, cfg
    scores = wind.scores
    if cfg.wind_table_bf16:
        scores = scores.to(torch.bfloat16)
        cfg = dataclasses.replace(cfg, wind_table_bf16=False)
    return expand_modes(wind.basis, scores, wind.scores.dtype), cfg


def cfg_values(cfg: SimConfig) -> list:
    """The ``SimConfig`` numbers in the kernel's ``Cfg`` order, in float64;
    the kernel rounds each once to its precision. The fine and coarse steps'
    halves and sixths are formed here, in float64, as the JAX package forms
    them from its Python (or weakly typed float64) step."""
    dt_big = cfg.dt * cfg.descent_dt_scale
    return [cfg.dt, 0.5 * cfg.dt, cfg.dt / 6.0, cfg.rail_dt, cfg.max_time,
            cfg.rail_length, cfg.pitch_damping, cfg.yaw_damping,
            cfg.ground_altitude, cfg.excessive_altitude, cfg.apogee_min_altitude,
            cfg.coast_alt_hi, cfg.coast_alt_mid, cfg.coast_time_hi,
            cfg.coast_time_mid, cfg.coast_time_lo, cfg.speed_guard, dt_big,
            0.5 * dt_big, dt_big / 6.0, cfg.descent_settle_time,
            cfg.ascent_q_threshold]


def _kernel_args(scene_nw, grid, wind, ics, cfg: SimConfig, record: bool = False,
                 stacked_speed: bool = False, carry: bool = False) -> KernelArgs:
    """Check the inputs against what the kernel takes and lay them out as its
    C entry wants them. A scalar leaf's stride is 0 when it is shared and 1
    when it is per lane; the tables are the fixed ``_TABLES`` list, always
    shared, whatever their length. ``wind`` is the table as given; under
    ``wind_table_bf16`` the kernel reads its ``stored_wind``."""
    dtype, device = ics[0].dtype, ics[0].device
    if dtype not in _PRECISIONS:
        raise ValueError(f"flight_summary takes float32 or float64, got {dtype}")
    if ics[0].ndim != 1:
        raise ValueError("initial conditions must be [B] per component")
    n = ics[0].shape[0]

    ptrs, strides = [], []
    leaves = [(f"{part}.{field}", getattr(getattr(scene_nw, part), field))
              for part, field in _SCENE_LEAVES]
    leaves += [(f"ics[{i}]", t) for i, t in enumerate(ics)]
    for name, t in leaves:
        _check(t, name, dtype, device)
        if t.ndim == 0:
            strides.append(0)
        elif t.ndim == 1 and t.shape[0] == n:
            strides.append(1)
        else:
            raise ValueError(f"{name}: expected a scalar or [{n}], got {tuple(t.shape)}")
        ptrs.append(t.data_ptr())

    tables = []
    for part, field in _TABLES:
        t = _check(getattr(getattr(scene_nw, part), field), f"{part}.{field}", dtype,
                   device)
        if t.ndim != 1:
            raise ValueError(f"{part}.{field}: tables are shared [K]; got "
                             f"{tuple(t.shape)} (per-lane tables are not supported)")
        tables.append(t)
    sizes = [tables[0].numel(), tables[3].numel(), tables[5].numel()]
    if (tables[1].numel(), tables[2].numel(), tables[4].numel(), tables[6].numel()) != (
            sizes[0], sizes[0], sizes[1], sizes[2]):
        raise ValueError("table lengths do not match their knot vectors")
    _check(grid, "wind grid", dtype, device)
    _check(wind, "wind table", dtype, device)
    wind = stored_wind(wind, cfg)
    n_wind = grid.numel()
    if grid.ndim != 1 or wind.shape[-2:] != (n_wind, 3):
        raise ValueError(f"wind table must be [N,3] or [B,N,3] on the [N] grid, got "
                         f"{tuple(wind.shape)} on {tuple(grid.shape)}")
    if wind.ndim == 2:
        wind_stride = 0
    elif wind.ndim == 3 and wind.shape[0] == n:
        # lane-minor [N, 3, B]: a warp's lanes read neighbouring addresses
        wind, wind_stride = wind.permute(1, 2, 0).contiguous(), 1
    else:
        raise ValueError(f"wind table must be shared or per lane, got {tuple(wind.shape)}")
    flags = _table_flags(tables, grid)
    table_ptrs = [t.data_ptr() for t in tables] + [grid.data_ptr(), wind.data_ptr(),
                                                   flags.data_ptr()]
    sizes.append(n_wind)

    return KernelArgs(n, ptrs, strides, table_ptrs, sizes, wind, wind_stride, flags,
                      cfg_values(cfg),
                      kernel_flags(cfg, scene_nw.rocket.stall_limited_moments, record,
                                   stacked_speed, carry))


def entry_args(a: KernelArgs, cfg: SimConfig, out_f, out_i, stream, rec=None,
               chunk=None) -> list:
    """The C entry's arguments for ``a``, the outputs and the stream (host
    pointers where the emulated tests run it), and a recording build's
    ``rec = (frames, stop, RecordLayout)`` or a carry build's ``chunk =
    (carry_f, carry_i, active, first, steps)``: the carry tensors, the flag
    the chunk's lanes set (a one-element view), whether it is the first
    chunk, its steps at most."""
    args = [(ctypes.c_void_p * _N_LEAVES)(*a.ptrs), (ctypes.c_int * _N_LEAVES)(*a.strides),
            _N_LEAVES, (ctypes.c_void_p * len(a.table_ptrs))(*a.table_ptrs),
            (ctypes.c_int * len(a.sizes))(*a.sizes), ctypes.c_int64(a.wind_lane_stride),
            (ctypes.c_double * len(a.cfg_vals))(*a.cfg_vals), len(a.cfg_vals),
            cfg.max_steps, cfg.max_rail_steps, ctypes.c_void_p(out_f.data_ptr()),
            ctypes.c_void_p(out_i.data_ptr()), a.n, stream]
    if rec is not None:
        frames, stop, lay = rec
        args += [ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(stop.data_ptr()),
                 lay.stride, lay.n_channels, ctypes.c_uint(lay.mask)]
    if chunk is not None:
        carry_f, carry_i, active, first, steps = chunk
        args += [ctypes.c_void_p(carry_f.data_ptr()), ctypes.c_void_p(carry_i.data_ptr()),
                 ctypes.c_void_p(active.data_ptr()), int(first), int(steps)]
    return args


def derived_args(a: KernelArgs, frames, stop, lay, stream) -> list:
    """The derived pass's C entry arguments for ``a``, the ``frames`` and
    ``stop`` a recording wrote under ``lay``, and the stream."""
    return [(ctypes.c_void_p * _N_LEAVES)(*a.ptrs), (ctypes.c_int * _N_LEAVES)(*a.strides),
            _N_LEAVES, (ctypes.c_void_p * len(a.table_ptrs))(*a.table_ptrs),
            (ctypes.c_int * len(a.sizes))(*a.sizes), ctypes.c_int64(a.wind_lane_stride), a.n,
            stream, ctypes.c_void_p(frames.data_ptr()), ctypes.c_void_p(stop.data_ptr()),
            lay.n_frames, lay.n_channels, ctypes.c_uint(lay.mask)]


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _launch_derived(a: KernelArgs, frames, stop, lay: RecordLayout) -> None:
    """Launch the recording build's derived pass on the frames and stop
    frames of a recording of ``a`` under ``lay`` (``lay.mask`` not 0)."""
    suffix = _PRECISIONS[frames.dtype][1]
    rc = getattr(_load(a.build), f"flight_record_derived_{suffix}")(
        *derived_args(a, frames, stop, lay, _stream(frames.device)))
    if rc != 0:
        raise RuntimeError(f"flight_summary derived pass launch failed ({flags_name(a.build)}, "
                           f"CUDA error {rc})")
    global derived_launches
    derived_launches += 1


def _launch(scene_nw, grid, wind, ics, cfg: SimConfig, rec=None,
            stacked_speed: bool = False) -> dict:
    """Launch the build of ``cfg`` on CUDA tensors: the summary build, or
    with ``rec = (frames, stop, RecordLayout)`` the recording build's flight
    and, where the layout records derived channels, its derived pass."""
    a = _kernel_args(scene_nw, grid, wind, ics, cfg, record=rec is not None,
                     stacked_speed=stacked_speed)
    dtype, device = ics[0].dtype, ics[0].device
    out_f = torch.empty((len(_FLOAT_KEYS), a.n), dtype=dtype, device=device)
    out_i = torch.empty((len(INT_KEYS), a.n), dtype=torch.int32, device=device)

    fn = getattr(_load(a.build), entry_name(a.build, _PRECISIONS[dtype][1]))
    rc = fn(*entry_args(a, cfg, out_f, out_i, _stream(device), rec))
    if rc != 0:
        raise RuntimeError(f"flight_summary kernel launch failed ({flags_name(a.build)}, "
                           f"CUDA error {rc})")
    global launches, record_launches, fold_launches
    launches += 1
    fold_launches += a.build.stacked_speed
    if rec is not None:
        record_launches += 1
        if rec[2].mask:
            _launch_derived(a, *rec)
    return _outputs(out_f, out_i)


def _outputs(out_f, out_i) -> dict:
    res = {k: out_f[i] for i, k in enumerate(_FLOAT_KEYS)}
    res.update({k: out_i[i] for i, k in enumerate(INT_KEYS)})
    return res


def flight_summary_reference(scene_nw, grid: torch.Tensor, wind: torch.Tensor, ics,
                             cfg: SimConfig, stacked_speed: bool = False) -> dict:
    """The kernel's plain version: ``flight_components`` over
    ``wind_fn_of``'s lookup, on any device."""
    return flight_components(scene_nw, cfg, wind_fn_of(grid, wind, cfg), ics,
                             stacked_speed=stacked_speed)


def flight_summary(scene_nw, grid: torch.Tensor, wind: torch.Tensor, ics,
                   cfg: SimConfig, stacked_speed: bool = False) -> dict:
    """Whole flights of a batch: ``scene_nw`` without its wind, the wind
    ``grid [N]`` and table (``[B, N, 3]`` or shared ``[N, 3]``, or a
    ``WindModes``), 12 ``[B]`` initial-condition tensors. Returns
    ``flight_components``' dict. ``stacked_speed``: every speed of the main
    loop is the stacked engine's (a NaN speed counts 0, as ``safe_norm``
    makes it), the build ``KernelFlags.stacked_speed``.

    CPU tensors run the plain version; CUDA tensors launch the kernel build
    of ``kernel_flags``, on the ``expanded`` table of a ``WindModes``."""
    device = ics[0].device
    if device.type == "cpu":
        return flight_summary_reference(scene_nw, grid, wind, ics, cfg, stacked_speed)
    if device.type != "cuda":
        raise ValueError(f"flight_summary runs on cpu or cuda, not {device}")
    table, cfg = expanded(wind, cfg)
    return _launch(scene_nw, grid, table, ics, cfg, stacked_speed=stacked_speed)


# the carry build's carry a lane: the 14 state values and 9 more of the
# lane's dtype, 5 int32 (csrc/flight_summary.cu CarryF, CarryI)
N_CARRY_F = 23
N_CARRY_I = 5


def max_chunks(cfg: SimConfig, chunk_steps: int) -> int:
    """The most chunks a chunked run launches, as the JAX package bounds
    them: ``ceil(max_steps / chunk_steps) + 1``."""
    return -(-cfg.max_steps // chunk_steps) + 1


def check_chunk_steps(chunk_steps) -> int:
    """``chunk_steps`` as an int, or ValueError unless it is a positive
    integer."""
    if int(chunk_steps) != chunk_steps or chunk_steps < 1:
        raise ValueError(f"chunk_steps must be a positive integer, got {chunk_steps!r}")
    return int(chunk_steps)


def summary_out(s, ic) -> dict:
    """A stacked-engine ``FlightSummary`` of ``[B]`` lanes as
    ``flight_components``' dict: its leaves split by component, the launch
    quaternion that of ``engine.state.initial_state(ic)``."""
    from ..engine.state import initial_state

    out = {k: getattr(s, k) for k in ("apogee_altitude", "apogee_time", "range",
                                       "flight_time", "max_speed", "n_steps")}
    out.update({k: getattr(s.rail, k) for k in ("rail_exit_time", "rail_exit_speed",
                                                  "rail_exit_angle_of_attack",
                                                  "rail_exit_sideslip")})
    for prefix, v in (("final_p", s.landing_position), ("final_v", s.final_velocity),
                      ("rail_p", s.rail.rail_exit_position),
                      ("rail_v", s.rail.rail_exit_velocity)):
        out.update({prefix + c: v[..., i] for i, c in enumerate("xyz")})
    out.update({"rail_w" + c: s.rail.wind_at_exit[..., i] for i, c in enumerate("uvw")})
    q = initial_state(ic).quaternion
    out.update({k: q[..., i] for i, k in enumerate(("quat_w", "quat_x", "quat_y", "quat_z"))})
    out.update(parachute_deployed=s.parachute_deployed.to(torch.int32),
               diverged=s.diverged.to(torch.int32))
    return {k: out[k] for k in SUMMARY_KEYS}


def run_chunks(launch, active: torch.Tensor, progress=None) -> int:
    """The host's loop of a chunked run: ``launch(k)`` for chunk ``k`` = 0,
    1, ..., ``progress(k + 1, n)`` after it, until the chunk leaves
    ``active[k]`` 0 (no lane takes another step; one read of the device a
    chunk) or ``n = active.numel()`` chunks ran. Returns the chunks run."""
    n = active.numel()
    for k in range(n):
        launch(k)
        if progress is not None:
            progress(k + 1, n)
        if not bool(active[k]):
            return k + 1
    return n


def flight_summary_chunked_reference(scene_nw, grid: torch.Tensor, wind, ics,
                                     cfg: SimConfig, chunk_steps: int, progress=None) -> dict:
    """The carry build's plain version, on any device: the stacked engine's
    chunk loop (``engine.simulate.simulate_batch_chunked_reference``) on the
    same lanes, as ``flight_components``' dict. It flies the stacked
    engine's physics, so it takes only the flags that engine reads (RK4,
    the table as given, the fine timestep), with the stacked engine's
    speed."""
    from ..engine.simulate import simulate_batch_chunked_reference
    from ..engine.state import InitialConditions
    from ..models.wind import WindField

    if isinstance(wind, WindModes):
        raise ValueError("the stacked engine flies wind tables, not WindModes")
    scene = dataclasses.replace(scene_nw, wind=WindField(altitudes=grid, wind=wind))
    ic = InitialConditions(*(torch.stack(ics[i:i + 3], dim=-1) for i in range(0, 12, 3)))
    return summary_out(simulate_batch_chunked_reference(scene, ic, cfg, chunk_steps, progress),
                       ic)


def flight_summary_chunked(scene_nw, grid: torch.Tensor, wind, ics, cfg: SimConfig,
                           chunk_steps: int, progress=None,
                           stacked_speed: bool = True) -> dict:
    """``flight_summary``'s flights in chunks of at most ``chunk_steps``
    main-loop steps: ``flight_components``' dict, equal to
    ``flight_summary(..., stacked_speed)`` of the same inputs bit for bit.
    After each chunk ``progress(k, max_chunks(cfg, chunk_steps))`` is
    called (k from 1), and the run stops once no lane takes another step,
    as the JAX package's ``simulate_batch_chunked`` does.

    CUDA tensors launch the carry build of ``kernel_flags``, one launch a
    chunk, with the inputs laid out (the wind transposed lane-minor) and the
    carry allocated once a run, and one read of the device's "a lane is
    still active" flag between two chunks. CPU tensors run the plain
    version, the stacked engine's chunk loop, which takes ``stacked_speed``
    True only (the default: the chunked route is the stacked engine's)."""
    chunk_steps = check_chunk_steps(chunk_steps)
    device = ics[0].device
    if device.type == "cpu":
        if not stacked_speed:
            raise ValueError("the chunked plain version is the stacked engine's, whose speed "
                             "is safe_norm's: stacked_speed must be True on the CPU")
        return flight_summary_chunked_reference(scene_nw, grid, wind, ics, cfg, chunk_steps,
                                                progress)
    if device.type != "cuda":
        raise ValueError(f"flight_summary_chunked runs on cpu or cuda, not {device}")
    table, cfg = expanded(wind, cfg)
    a = _kernel_args(scene_nw, grid, table, ics, cfg, stacked_speed=stacked_speed, carry=True)
    dtype = ics[0].dtype
    out_f = torch.empty((len(_FLOAT_KEYS), a.n), dtype=dtype, device=device)
    out_i = torch.empty((len(INT_KEYS), a.n), dtype=torch.int32, device=device)
    carry_f = torch.empty((N_CARRY_F, a.n), dtype=dtype, device=device)
    carry_i = torch.empty((N_CARRY_I, a.n), dtype=torch.int32, device=device)
    n_chunks = max_chunks(cfg, chunk_steps)
    active = torch.zeros(n_chunks, dtype=torch.int32, device=device)
    fn = getattr(_load(a.build), entry_name(a.build, _PRECISIONS[dtype][1]))
    stream = _stream(device)
    steps = max(1, min(chunk_steps, cfg.max_steps))

    def launch(k):
        rc = fn(*entry_args(a, cfg, out_f, out_i, stream,
                            chunk=(carry_f, carry_i, active[k:k + 1], k == 0, steps)))
        if rc != 0:
            raise RuntimeError(f"flight_summary carry build launch failed "
                               f"({flags_name(a.build)}, chunk {k}, CUDA error {rc})")
        global launches, chunk_launches, fold_launches
        launches += 1
        chunk_launches += 1
        fold_launches += a.build.stacked_speed

    run_chunks(launch, active, progress)
    return _outputs(out_f, out_i)


class RecordLayout(NamedTuple):
    """A recording's frames as the recording build writes them."""
    names: tuple      # the derived channels (``record_names``)
    mask: int         # bit j set for ``DERIVED_KEYS[j]`` in ``names``
    stride: int       # record_stride
    n_frames: int     # T
    n_channels: int   # the time, the 14 state values, the derived channels


def record_layout(cfg: SimConfig) -> RecordLayout:
    names = record_names(cfg)
    return RecordLayout(names, sum(1 << DERIVED_KEYS.index(k) for k in names),
                        max(1, cfg.record_stride), n_frames(cfg),
                        len(FRAME_KEYS) + len(names))


def _check_room(lay: RecordLayout, n: int, dtype, device) -> None:
    """Raise, with the numbers, unless the card has room for a recording of
    ``n`` lanes: its frames, their filled copy and the fill's index."""
    frames = lay.n_frames * lay.n_channels * n * torch.finfo(dtype).bits // 8
    need = 2 * frames + lay.n_frames * n * 8
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > free:
        raise RuntimeError(
            f"recording {n} lanes x {lay.n_frames} frames x {lay.n_channels} channels "
            f"needs {need / 2**30:.2f} GiB on {device}, {free / 2**30:.2f} GiB are free: "
            "record fewer lanes, fewer channels (record_channels) or fewer frames "
            "(record_stride, max_time)")


def unpack_frames(frames: torch.Tensor, stop: torch.Tensor, lay: RecordLayout) -> dict:
    """The recording build's ``frames [T, C, B]`` and ``stop [B]`` as the
    recorder's records (``flight_components_trajectory``): each lane's
    frames after its stop frame are that frame (one gather), and ``valid``
    is frame <= stop."""
    t = torch.arange(lay.n_frames, device=frames.device)[:, None]
    upto = torch.minimum(t, stop.to(torch.int64)[None, :])
    full = frames.gather(0, upto[:, None, :].expand_as(frames))
    recs = {k: full[:, c] for c, k in enumerate(FRAME_KEYS)}
    recs["valid"] = t <= stop[None, :]
    recs["derived"] = {k: full[:, len(FRAME_KEYS) + j] for j, k in enumerate(lay.names)}
    return recs


def flight_record_reference(scene_nw, grid: torch.Tensor, wind: torch.Tensor, ics,
                            cfg: SimConfig, stacked_speed: bool = False):
    """The recording build's plain version: ``flight_components_trajectory``
    over ``wind_fn_of``'s lookup, on any device."""
    return flight_components_trajectory(scene_nw, cfg, wind_fn_of(grid, wind, cfg), ics,
                                        stacked_speed=stacked_speed)


def flight_record(scene_nw, grid: torch.Tensor, wind: torch.Tensor, ics, cfg: SimConfig,
                  stacked_speed: bool = False):
    """``flight_summary``'s flights with their trajectories recorded under
    ``cfg`` (``record_stride``, ``record_derived``, ``record_channels``):
    ``(summary dict, records)`` as ``flight_components_trajectory`` returns
    them, ``[T, B]`` time-major records.

    CPU tensors run that recorder; CUDA tensors launch the recording build
    of ``kernel_flags(cfg, ..., record=True)``, whose summary is the summary
    build's bit for bit, and then its derived pass where ``cfg`` records
    derived channels, after checking that the card holds the frames (it
    raises with the numbers, never truncates). ``stacked_speed``:
    ``flight_summary``'s."""
    device = ics[0].device
    if device.type == "cpu":
        return flight_record_reference(scene_nw, grid, wind, ics, cfg, stacked_speed)
    if device.type != "cuda":
        raise ValueError(f"flight_record runs on cpu or cuda, not {device}")
    lay = record_layout(cfg)
    n, dtype = ics[0].shape[0], ics[0].dtype
    _check_room(lay, n, dtype, device)
    frames = torch.empty((lay.n_frames, lay.n_channels, n), dtype=dtype, device=device)
    stop = torch.empty(n, dtype=torch.int32, device=device)
    table, cfg = expanded(wind, cfg)
    res = _launch(scene_nw, grid, table, ics, cfg, rec=(frames, stop, lay),
                  stacked_speed=stacked_speed)
    return res, unpack_frames(frames, stop, lay)


# ------------------------------------------------------------------ the bound
# The least arithmetic the flight needs, per lane-step, counted as the
# kernel evaluates it (tables read through the knot window, lane constants
# hoisted). One operation per +, -, *, /, sqrt, min, max and transcendental
# (exp, pow, atan2, sin, cos); negations, comparisons and selects are free.
# Left out, so that the bound stays a least time: the thrust lookup and
# propellant ramp (burning lanes only), the parachute, stall and
# upper-atmosphere branches, and each lane's one-time set-up and epilogue.
# A table lookup counts as window_weight evaluates it: the clamp (2), then
# for each knot of the window its two numerators (2 -), and for the two
# knots of the query's segment, the only ones with a nonzero weight, one
# division and the clip (3); the zero-weight knots stop at the numerators.
# The window holds three knots in a table's first and last segments and
# four elsewhere; the count takes three, so a lookup costs 2 + 3 x 2 + 2 x 3
# = 14 before its products, and 2 x (*, +) fewer per value array than an
# interior one.
DYNAMICS_OPS = {  # one evaluation of csrc/flight_summary.cu dynamics
    "propellant fraction: max(frac, 0)": 1,
    "normalize the quaternion: 4 squares, 3 adds, sqrt, 1/n, 4 scales": 13,
    "rotation matrix: a second normalize (13), 3 diagonal x 5, 6 others x 4": 52,
    "mass, cg, Ixx, Iyy (lane-constant parts hoisted)": 12,
    "troposphere: temperature 2, pressure (max, /, pow, *) 4, density 3, sound 2": 11,
    "wind: window 14, segment guess 2, 3 components x 3 knots x (*, +) 18": 34,
    "air-relative velocity 3, body frame 15, |v|^2 5, Mach (sqrt, /) 2": 25,
    "angle of attack and sideslip: 2 abs, 2 atan2, 3 + sqrt": 8,
    "dynamic pressure": 2,
    "aero: Mach window 14, cd0 and cda sums 12, cd 3, |alpha| 1, stall factor 4, "
    "sqrt|1-M^2| 4, k 2, denominator 4, cl_alpha 2, cl 1, CP window and sum "
    "20 + 1, margin 1, pitch 3, side 1, yaw 3": 76,
    "drag, lift, side force": 6,
    "sin and cos of alpha and beta": 4,
    "aero force in the body frame": 17,
    "pitch and yaw moments with damping": 8,
    "body force to the inertial frame": 15,
    "gravity at altitude": 4,
    "linear accelerations: 1/m, 3 scales, weight 2": 6,
    "angular accelerations (Izz := Iyy): 3 x 5": 15,
    "quaternion derivative 24, norm error 8, correction 12": 44,
}
RK4_OPS = {  # the rest of one main-loop step
    "stage times": 2,
    "three stage inputs: 14 x (*, +) each": 84,
    "combine: 14 x (2*k2, 2*k3, 3 adds, *dt/6, +s)": 98,
    "renormalize the quaternion": 13,
    "events: step time (fused, 2), speed 6, max speed 1, coast time 1": 10,
}
RAIL_OPS = {  # one forward-Euler rail step
    "time": 1,
    "mass properties": 12,
    "troposphere": 11,
    "wind": 34,
    "air-relative velocity 6, axial speed 5, Mach 7": 18,
    "Mach window and cd0, cda sums 26, cd 3, drag 5": 34,
    "thrust on a 2-knot curve (clamp 2, 2 knots x (2 -, /, clip 2, *, +)), "
    "nozzle correction 2, scale 2": 20,
    "gravity 4, acceleration 4, speed 2, position 9, distance 2, fraction 5": 26,
}
# the flag sets' changes to one step
RK2_OPS = {  # the rest of one main-loop step of the midpoint method
    "stage time": 1,
    "one stage input: 14 x (*, +)": 28,
    "combine: 14 x (*dt, +s)": 28,
    "renormalize the quaternion": 13,
    "events: step time (fused, 2), speed 6, max speed 1, coast time 1": 10,
}
# energy_consistent_aero, in place of "aero force in the body frame" (17)
ENERGY_AERO_OPS = {
    "1 / max(|v|, 1e-12) 2, unit air velocity 3, lift and side force 9, "
    "their component along it 5, force 3 x 4": 31,
}
TIERED_OPS = {  # descent_dt_scale > 1, beside the events
    "fall speed 1, clearance 3, t + dt 1 in place of the fused step time 2": 3,
}


# one recorded frame's derived channels (csrc/flight_summary.cu
# derived_channels, the derived pass), counted as DYNAMICS_OPS; the thrust
# lookup is left out, as there, and the stores are free
DERIVED_OPS = {
    "mass, cg, Ixx, Iyy": 12,
    "troposphere": 11,
    "wind": 34,
    "rotation matrix with its normalize": 52,
    "air-relative velocity 3, body frame 15, |v|^2 5, Mach 2": 25,
    "angle of attack and sideslip": 8,
    "dynamic CP: window and sum 20, + 1": 21,
    "aero (as in dynamics)": 76,
    "dynamic pressure": 2,
    "Euler angles: sin(pitch) 4, clip 2, asin 1; roll and yaw 12 each": 31,
    "drag 2, stability margin 2, speed 6": 10,
}
OPS_PER_FRAME = sum(DERIVED_OPS.values())


def ops_per_step(flags: KernelFlags = None) -> int:
    """Operations of one main-loop step of a build: two or four dynamics
    evaluations and the rest of the step. Under ``wind_per_step`` the wind
    lookup leaves the dynamics and runs once a step. Left out, as the stall
    branch is, because a step runs them only on some lanes: the
    stall-limited moments, the tiered gate's time since apogee or since the
    chute latched, and the ascent gate's atmosphere lookup and dynamic
    pressure (``coarse_step``: quiet coasting steps only)."""
    flags = flags or PARITY
    wind = DYNAMICS_OPS["wind: window 14, segment guess 2, 3 components x 3 knots x (*, +) 18"]
    dyn = sum(DYNAMICS_OPS.values())
    if flags.energy_aero:
        dyn += sum(ENERGY_AERO_OPS.values()) - DYNAMICS_OPS["aero force in the body frame"]
    ops = wind if flags.wind_per_step else 0
    if flags.wind_per_step:
        dyn -= wind
    ops += 2 * dyn + sum(RK2_OPS.values()) if flags.rk2 else 4 * dyn + sum(RK4_OPS.values())
    if flags.tiered:
        ops += sum(TIERED_OPS.values())
    return ops


OPS_PER_STEP = ops_per_step(PARITY)
OPS_PER_RAIL_STEP = sum(RAIL_OPS.values())

# NVIDIA H100 SXM data sheet, 700 W: HBM3 bytes/s; FP32 and FP64 FLOP/s
# outside the tensor cores. Those peaks count a fused multiply-add as two
# operations. The kernel is built with -fmad=false, so its adds and
# multiplies take one instruction each and its own ceiling is half these
# rates: against that ceiling the bound doubles. The published peak is kept,
# so that the bound is the least time any code could take for this work.
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


class Bound(NamedTuple):
    ms: float          # the larger of the two times below
    by: str            # "operations" or "bytes"
    lane_steps: int    # RK4 steps plus rail steps, summed over lanes
    ops: float
    bytes: int


def input_bytes(scene_nw, grid, wind, ics, cfg: SimConfig = SimConfig()) -> int:
    """Bytes of every input of one call, each counted once: the scalar
    leaves, the tables, the wind grid and table (two bytes a value under
    ``wind_table_bf16``) and the initial conditions."""
    leaves = [getattr(getattr(scene_nw, part), field)
              for part, field in _SCENE_LEAVES + _TABLES]
    wind_bytes = wind.numel() * (2 if cfg.wind_table_bf16 else wind.element_size())
    return wind_bytes + sum(t.numel() * t.element_size() for t in (*leaves, grid, *ics))


def carry_runs(n_steps: torch.Tensor, chunk_steps: int) -> torch.Tensor:
    """The chunks of a chunked run each lane runs: its first, then one for
    every ``chunk_steps`` of its ``n_steps`` main-loop steps after the first
    chunk's (a lane that stopped is skipped)."""
    return torch.clamp_min(-(-n_steps.to(torch.int64) // chunk_steps), 1)


def bound_ms(out: dict, cfg: SimConfig, dtype, in_bytes: int, recs: dict = None,
             chunk_steps: int = None) -> Bound:
    """The least time an H100 SXM at 700 W could take for the flights in
    ``out`` (a ``flight_summary`` result of ``cfg``): the larger of their
    operations (``n_steps`` main-loop steps at ``ops_per_step`` of the build
    of ``cfg``, a tiered step counting one step whatever its length, plus
    ``round(rail_exit_time / rail_dt)`` rail steps at ``OPS_PER_RAIL_STEP``)
    over the FP32 or FP64 peak, and of ``in_bytes`` read once plus the
    outputs written once over the memory rate. With ``recs``, the records of
    ``flight_record``: each lane's frames up to its stop, each at
    ``OPS_PER_FRAME`` where derived channels are recorded, and every frame
    of the records written once. With ``chunk_steps``, a chunked run of the
    carry build: the same operations, and each lane's carry (``N_CARRY_F``
    values and ``N_CARRY_I`` int32) written at the end of each chunk it
    runs (``carry_runs``) and read at the start of each but its first."""
    steps = int(out["n_steps"].to(torch.int64).sum())
    rail = int(torch.round(out["rail_exit_time"].double() / cfg.rail_dt).sum())
    ops = float(steps * ops_per_step(kernel_flags(cfg)) + rail * OPS_PER_RAIL_STEP)
    nbytes = in_bytes + sum(t.numel() * t.element_size() for t in out.values())
    if chunk_steps is not None:
        lane_bytes = N_CARRY_F * (torch.finfo(dtype).bits // 8) + N_CARRY_I * 4
        nbytes += int((2 * carry_runs(out["n_steps"], chunk_steps) - 1).sum()) * lane_bytes
    if recs is not None:
        frames = int(recs["valid"].sum())
        ops += float(frames * OPS_PER_FRAME) if recs["derived"] else 0.0
        nbytes += sum(t.numel() * t.element_size() for k, t in recs.items()
                      if k != "derived")
        nbytes += sum(t.numel() * t.element_size() for t in recs["derived"].values())
    t_ops = ops / H100_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return Bound(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                 steps + rail, ops, nbytes)


def derived_bound_ms(recs: dict, dtype) -> Bound:
    """The least time an H100 SXM at 700 W could take for the derived pass
    of the records ``recs`` (``flight_record``'s, with derived channels):
    the larger of its operations (``OPS_PER_FRAME`` for each lane's frames
    up to its stop) over the FP32 or FP64 peak, and of its bytes over the
    memory rate: each of those frames' time and 14 state values read once
    and its derived channels written once (the leaves and tables, some
    hundred bytes, left out). ``lane_steps`` holds the frames."""
    frames = int(recs["valid"].sum())
    size = torch.finfo(dtype).bits // 8
    ops = float(frames * OPS_PER_FRAME)
    nbytes = frames * (len(FRAME_KEYS) + len(recs["derived"])) * size
    t_ops = ops / H100_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return Bound(max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                 frames, ops, nbytes)
