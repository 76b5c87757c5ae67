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

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``erpl_monte_carlo_sim_tpu_torch/_build/`` (a content hash of the source and
flags names the library, so an edited source rebuilds) and bound with
``ctypes``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from ..engine.component import INT_KEYS, SUMMARY_KEYS, table_wind_fn
from ..engine.component import flight_components as flight_summary_reference
from ..engine.config import SimConfig, require_parity_flags

__all__ = ["flight_summary", "flight_summary_reference", "build", "launches",
           "SOURCE"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flight_summary.cu")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel launches so far (the count a run reads to show the kernel ran)
launches = 0

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no a*b+c contraction, so the kernel rounds as the eager
# PyTorch ops and the JAX package do, operation by operation
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]
_PRECISIONS = {torch.float32: ("1", "f32"), torch.float64: ("0", "f64")}

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

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the flight_summary kernel")
    return path


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build(verbose: bool = False) -> tuple[str, str]:
    """Compile the kernel (float and double objects in parallel, then one
    shared library) unless the hashed library exists. Returns
    ``(library path, compiler log)``; ``verbose`` adds ``-Xptxas -v``
    (registers, spills). The float object is built with
    ``-Xptxas -warn-double-usage``, and any such warning fails the build."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    extra = ["-Xptxas", "-v"] if verbose else []
    key = hashlib.sha256(src + " ".join(_ARCH + _FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"flight_summary_{key}.so")
    if os.path.exists(lib) and not verbose:
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for f32, suffix in _PRECISIONS.values():
        obj = os.path.join(BUILD_DIR, f"flight_summary_{key}_{suffix}.o")
        warn = ["-Xptxas", "-warn-double-usage"] if suffix == "f32" else []
        cmd = [nvcc, *_ARCH, *_FLAGS, *warn, *extra, f"-DFS_F32={f32}", "-c", SOURCE,
               "-o", obj]
        objs.append(obj)
        procs.append((suffix, _run(cmd)))
    log = []
    for suffix, p in procs:
        out, _ = p.communicate()
        log.append(f"[{suffix}]\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({suffix}):\n{out}")
        if suffix == "f32" and "double precision" in out:
            raise RuntimeError(f"float build uses double precision:\n{out[:4000]}")
    tmp = f"{lib}.{os.getpid()}.tmp"
    p = _run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs])
    out, _ = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{out}")
    os.replace(tmp, lib)
    return lib, "\n".join(log)


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for _, suffix in _PRECISIONS.values():
            fn = getattr(lib, f"flight_summary_{suffix}")
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device) -> torch.Tensor:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def _kernel_args(scene_nw, grid, wind, ics, cfg: SimConfig) -> tuple:
    """Check the inputs against what the kernel takes and lay them out as its
    C entry wants them: ``(lanes, leaf pointers, leaf strides, table
    pointers, table sizes, wind lane stride, SimConfig numbers)``. A scalar
    leaf's stride is 0 when it is shared and 1 when it is per lane; the
    tables are the fixed ``_TABLES`` list, always shared, whatever their
    length."""
    require_parity_flags(cfg)
    if scene_nw.rocket.stall_limited_moments:
        raise NotImplementedError("stall_limited_moments is not ported yet (ROADMAP P7)")
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
    n_wind = grid.numel()
    if grid.ndim != 1 or wind.shape[-2:] != (n_wind, 3):
        raise ValueError(f"wind table must be [N,3] or [B,N,3] on the [N] grid, got "
                         f"{tuple(wind.shape)} on {tuple(grid.shape)}")
    if wind.ndim == 2:
        wind_stride = 0
    elif wind.ndim == 3 and wind.shape[0] == n:
        wind_stride = n_wind * 3
    else:
        raise ValueError(f"wind table must be shared or per lane, got {tuple(wind.shape)}")
    table_ptrs = [t.data_ptr() for t in tables] + [grid.data_ptr(), wind.data_ptr()]
    sizes.append(n_wind)

    cfg_vals = [cfg.dt, 0.5 * cfg.dt, cfg.dt / 6.0, cfg.rail_dt, cfg.max_time,
                cfg.rail_length, cfg.pitch_damping, cfg.yaw_damping,
                cfg.ground_altitude, cfg.excessive_altitude, cfg.apogee_min_altitude,
                cfg.coast_alt_hi, cfg.coast_alt_mid, cfg.coast_time_hi,
                cfg.coast_time_mid, cfg.coast_time_lo]
    return n, ptrs, strides, table_ptrs, sizes, wind_stride, cfg_vals


def _launch(scene_nw, grid, wind, ics, cfg: SimConfig) -> dict:
    n, ptrs, strides, table_ptrs, sizes, wind_stride, cfg_vals = _kernel_args(
        scene_nw, grid, wind, ics, cfg)
    dtype, device = ics[0].dtype, ics[0].device
    out_f = torch.empty((len(_FLOAT_KEYS), n), dtype=dtype, device=device)
    out_i = torch.empty((len(INT_KEYS), n), dtype=torch.int32, device=device)

    fn = getattr(_load(), f"flight_summary_{_PRECISIONS[dtype][1]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn((ctypes.c_void_p * _N_LEAVES)(*ptrs), (ctypes.c_int * _N_LEAVES)(*strides),
                _N_LEAVES, (ctypes.c_void_p * 9)(*table_ptrs), (ctypes.c_int * 4)(*sizes),
                wind_stride, (ctypes.c_double * len(cfg_vals))(*cfg_vals),
                cfg.max_steps, cfg.max_rail_steps, out_f.data_ptr(), out_i.data_ptr(),
                n, stream)
    if rc != 0:
        raise RuntimeError(f"flight_summary kernel launch failed (CUDA error {rc})")
    global launches
    launches += 1
    res = {k: out_f[i] for i, k in enumerate(_FLOAT_KEYS)}
    res.update({k: out_i[i] for i, k in enumerate(INT_KEYS)})
    return res


def flight_summary(scene_nw, grid: torch.Tensor, wind: torch.Tensor, ics,
                   cfg: SimConfig) -> dict:
    """Whole flights of a batch: ``scene_nw`` without its wind, the wind
    ``grid [N]`` and table (``[B, N, 3]`` or shared ``[N, 3]``), 12 ``[B]``
    initial-condition tensors. Returns ``flight_components``' dict.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    device = ics[0].device
    if device.type == "cpu":
        return flight_summary_reference(scene_nw, cfg, table_wind_fn(grid, wind), ics)
    if device.type != "cuda":
        raise ValueError(f"flight_summary runs on cpu or cuda, not {device}")
    return _launch(scene_nw, grid, wind, ics, cfg)
