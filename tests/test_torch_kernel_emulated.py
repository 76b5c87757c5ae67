"""PyTorch port: the CUDA kernel's own source, built and run on the CPU.

``csrc/flight_summary.cu`` is C++ apart from CUDA's launch syntax, thread
indices, shared memory and one barrier. The shim below maps those onto the
host: each CUDA thread a ``std::thread``, one block at a time,
``__syncthreads`` a barrier, shared memory static storage. g++
builds the unchanged source against it (the launch rewritten as a call,
``-ffp-contract=off`` for the kernel's ``-fmad=false``), and the tests hold
what it computes to the plain PyTorch version with chip_smoke's bars, on the
kernel's paths: window and full-knot table sums, a ragged last block whose
idle threads must still reach the barrier, a shared wind table, the solid
motor's 10-knot thrust curve, float32 and float64; and every flag set's
build (``kernel_flags``) on a window of dispersed lanes (the tiered ones
also fly the low-apogee scenes of tests/test_descent.py to landing, in
tests/test_torch_landing_f64.py and _f32.py). The recording build
(``flight_record``: its flight, then its derived pass) against the plain
recorder, its summary against the summary build's: parity windows in both
precisions at 1, 33 and 64 lanes under three channel masks (every derived
channel, a subset, none), and a low-apogee scene to landing under the
tiered set with a subset of the derived channels; a frame written past a
lane's stop frame fails.
The CPU's math library stands in for CUDA's, so this checks the kernel's
logic and order of operations, not its last bits on the card (chip_smoke.py
does that). It skips without g++. This file imports no JAX.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

from chip_smoke import compare, compare_records
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
from erpl_monte_carlo_sim_tpu_torch.engine.component import INT_KEYS
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import (COMBINED, FULL_FLIGHTS,
                                                            LOW_APOGEE_PROPELLANT, combined,
                                                            low_apogee_batch)
from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
from erpl_monte_carlo_sim_tpu_torch.models import (RocketParams, WindField, liquid_motor,
                                                   nominal_scene, solid_motor)
from erpl_monte_carlo_sim_tpu_torch.ops import prng

torch.set_num_threads(1)

# a short window: the rail phase and about 230 RK4 steps per lane
WINDOW = SimConfig(max_time=2.0)

SHIM = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
// a block barrier that aborts, rather than hangs, when a thread of the
// block never arrives (a thread that returns before __syncthreads)
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0, phase = 0, any = 0, result = 0;
  explicit EmuBarrier(int threads) : n(threads) {}
  // the barrier, returning whether any thread passed a nonzero v
  int wait(int v = 0) {
    std::unique_lock<std::mutex> lk(m);
    const int ph = phase;
    any |= v != 0;
    if (++count == n) {
      count = 0;
      result = any;
      any = 0;
      ++phase;
      cv.notify_all();
      return result;
    }
    if (!cv.wait_for(lk, std::chrono::seconds(60), [&] { return phase != ph; })) {
      fprintf(stderr, "__syncthreads: a thread of the block never arrived\n");
      abort();
    }
    return result;
  }
};
inline EmuBarrier* emu_bar = nullptr;
alignas(16) inline char emu_dyn_smem[256 * 1024];
inline void __syncthreads() { emu_bar->wait(); }
inline int __syncthreads_or(int v) { return emu_bar->wait(v); }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetLastError() { return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, F, int, size_t) {
  *b = 1;
  return 0;
}
struct EmuCfg { long long blocks; int threads; long long smem; void* stream; };
#define EMU_CFG(...) EmuCfg{__VA_ARGS__}
template <class F, class... A> void emu_launch(EmuCfg c, F f, A... a) {
  blockDim.x = c.threads;
  gridDim.x = static_cast<unsigned>(c.blocks);
  for (long long b = 0; b < c.blocks; ++b) {
    EmuBarrier bar(c.threads);
    emu_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < c.threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = static_cast<unsigned>(b);
        f(a...);
      });
    for (auto& th : ts) th.join();
  }
}
"""

# cuda_bf16.h for the bfloat16 wind table: the bits, widened exactly
BF16_SHIM = r"""
#pragma once
#include <stdint.h>
#include <string.h>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = static_cast<uint32_t>(b.x) << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
"""

def flags_of(name):
    """The build of a ``COMBINED`` flag set: the catalogue's opt-ins
    combined, to keep the g++ builds few."""
    fields, stall = combined(COMBINED[name])
    return fields, stall, fs.kernel_flags(SimConfig(**fields), stall)


def build_emulated(tmp_path_factory, builds) -> dict:
    """``libs[flags][dtype]``: the kernel's C entries of ``builds``, built
    from its source for the CPU, all compilers started at once; a recording
    build's derived pass under ``libs[flags][dtype, "derived"]``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("emulated_kernel")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cuda_bf16.h").write_text(BF16_SHIM)
    with open(fs.SOURCE) as f:
        src = f.read()
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(EMU_CFG(\2), \1, ", src, flags=re.S)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", src)
    src = src.replace("__shared__", "static")
    (d / "kernel.cpp").write_text(src)
    jobs = []
    for i, flags in enumerate(sorted(builds)):
        defines = [f"-D{m}={int(v)}" for m, v in zip(fs._DEFINES, flags)]
        for dtype, (f32, suffix) in fs._PRECISIONS.items():
            lib = d / f"kernel_{i}_{suffix}.so"
            cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", f"-I{d}",
                   f"-DFS_F32={f32}", *defines, str(d / "kernel.cpp"), "-o", str(lib),
                   "-lpthread"]
            jobs.append((flags, dtype, suffix, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for flags, dtype, suffix, lib, p in jobs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"g++ failed for {flags}:\n{out}"
        cdll = ctypes.CDLL(str(lib))
        fn = getattr(cdll, fs.entry_name(flags, suffix))
        fn.restype = ctypes.c_int
        libs.setdefault(flags, {})[dtype] = fn
        if flags.record:
            derived = getattr(cdll, f"flight_record_derived_{suffix}")
            derived.restype = ctypes.c_int
            libs[flags][dtype, "derived"] = derived
    return libs


# the recording builds: parity, and the tiered set to landing
RECORD_WINDOW = SimConfig(max_time=2.0, record_stride=3)
RECORD_LANDING = SimConfig(**FULL_FLIGHTS, record_stride=4,
                           record_channels=("mach", "euler_angles", "thrust", "drag"))


# the carry builds' cases: id: (COMBINED name or "parity", stacked_speed)
CARRY_CASES = {
    "parity": ("parity", False),
    "parity+stacked_speed": ("parity", True),
    "full_flights": ("full_flights", False),
}


def carry_flags(case: str) -> tuple:
    """``(SimConfig fields, one-shot build)`` of a ``CARRY_CASES`` case."""
    name, stacked = CARRY_CASES[case]
    fields, _, flags = flags_of(name) if name != "parity" else ({}, False, fs.PARITY)
    return fields, flags._replace(stacked_speed=stacked)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The parity build and each ``COMBINED`` flag set's, the recording
    builds, and the carry cases' one-shot and carry builds, emulated."""
    one_shot = {carry_flags(case)[1] for case in CARRY_CASES}
    return build_emulated(tmp_path_factory,
                          {fs.PARITY} | {flags_of(name)[2] for name in COMBINED}
                          | {fs.kernel_flags(c, record=True)
                             for c in (RECORD_WINDOW, RECORD_LANDING)}
                          | one_shot | {f._replace(carry=True) for f in one_shot})


def run_emulated(libs, scene_nw, grid, wind, ics, cfg) -> dict:
    """``flight_summary`` through the emulated build of ``cfg``'s flags: the
    wrapper's own argument layout, host pointers for device ones."""
    a = fs._kernel_args(scene_nw, grid, wind, ics, cfg)
    fn = libs[a.build][ics[0].dtype]
    out_f = torch.empty((len(fs._FLOAT_KEYS), a.n), dtype=ics[0].dtype)
    out_i = torch.empty((len(INT_KEYS), a.n), dtype=torch.int32)
    assert fn(*fs.entry_args(a, cfg, out_f, out_i, None)) == 0
    return fs._outputs(out_f, out_i)


def chunked_emulated(libs, args, cfg, chunk_steps, stacked_speed):
    """``flight_summary_chunked`` through the emulated carry build of
    ``cfg``'s flags: the wrapper's layout and chunk loop (``run_chunks``),
    host pointers for device ones. The outputs and the carry start as NaN
    and -1, so that a value a chunk leaves unwritten shows. Returns
    ``(summary dict, progress calls)``."""
    a = fs._kernel_args(*args, cfg, stacked_speed=stacked_speed, carry=True)
    dtype = args[3][0].dtype
    out_f = torch.full((len(fs._FLOAT_KEYS), a.n), float("nan"), dtype=dtype)
    out_i = torch.full((len(INT_KEYS), a.n), -1, dtype=torch.int32)
    carry_f = torch.full((fs.N_CARRY_F, a.n), float("nan"), dtype=dtype)
    carry_i = torch.full((fs.N_CARRY_I, a.n), -1, dtype=torch.int32)
    active = torch.zeros(fs.max_chunks(cfg, chunk_steps), dtype=torch.int32)
    calls = []

    def launch(k):
        chunk = (carry_f, carry_i, active[k:k + 1], k == 0, min(chunk_steps, cfg.max_steps))
        assert libs[a.build][dtype](*fs.entry_args(a, cfg, out_f, out_i, None,
                                                   chunk=chunk)) == 0

    fs.run_chunks(launch, active, lambda k, n: calls.append((k, n)))
    return fs._outputs(out_f, out_i), calls


def record_emulated(libs, scene_nw, grid, wind, ics, cfg):
    """``flight_record`` through the emulated recording build of ``cfg``'s
    flags, its flight and then, where ``cfg`` records derived channels, its
    derived pass: ``(summary dict, records)``, the frames filled as the
    wrapper fills them (``unpack_frames``). Every frame past a lane's stop
    frame is left as it was: a pass that writes one fails here."""
    a = fs._kernel_args(scene_nw, grid, wind, ics, cfg, record=True)
    lay = fs.record_layout(cfg)
    dtype = ics[0].dtype
    out_f = torch.empty((len(fs._FLOAT_KEYS), a.n), dtype=dtype)
    out_i = torch.empty((len(INT_KEYS), a.n), dtype=torch.int32)
    # NaN where no frame is written, so that a frame left out shows
    frames = torch.full((lay.n_frames, lay.n_channels, a.n), float("nan"), dtype=dtype)
    stop = torch.full((a.n,), -1, dtype=torch.int32)
    assert libs[a.build][dtype](*fs.entry_args(a, cfg, out_f, out_i, None,
                                               (frames, stop, lay))) == 0
    if lay.mask:
        assert libs[a.build][dtype, "derived"](*fs.derived_args(a, frames, stop, lay, None)) == 0
    past = torch.arange(lay.n_frames)[:, None] > stop.long()[None, :]
    assert bool(frames.isnan().all(1)[past].all()), "a frame past its lane's stop was written"
    return fs._outputs(out_f, out_i), fs.unpack_frames(frames, stop, lay)


def batch(n, dtype, motor=liquid_motor, seed=0):
    scene_b, ic_b, _ = sample_dispersions(
        prng.prng_key(seed), nominal_scene(motor("cpu", dtype)),
        InitialConditions.vertical_launch("cpu", dtype), n=n)
    return scene_b, ic_b


CASES = {
    # name: (lanes, dtype, motor)
    "f64-nan-wind-lane": (64, torch.float64, liquid_motor),
    "f32": (256, torch.float32, liquid_motor),
    "f32-ragged-845": (845, torch.float32, liquid_motor),
    "f32-nan-mach": (64, torch.float32, liquid_motor),
    "f32-unsorted-mach": (64, torch.float32, liquid_motor),
    "f32-shared-wind": (64, torch.float32, liquid_motor),
    "f64-solid": (64, torch.float64, solid_motor),
    "f32-solid": (64, torch.float32, solid_motor),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_matches_plain_version(emulated, case):
    n, dtype, motor = CASES[case]
    scene_b, ic_b = batch(n, dtype, motor, seed=len(case))
    rocket, wind = scene_b.rocket, scene_b.wind
    if case == "f64-nan-wind-lane":
        table = wind.wind.clone()
        table[7, wind.altitudes > 2000.0] = float("nan")
        scene_b = dataclasses.replace(scene_b, wind=dataclasses.replace(wind, wind=table))
    elif case == "f32-nan-mach":
        cd0 = rocket.cd0_table.clone()
        cd0[3] = float("nan")
        scene_b = dataclasses.replace(scene_b, rocket=dataclasses.replace(rocket, cd0_table=cd0))
    elif case == "f32-unsorted-mach":
        mach = rocket.cd_mach.clone()
        mach[[2, 3]] = mach[[3, 2]]
        scene_b = dataclasses.replace(scene_b, rocket=dataclasses.replace(rocket, cd_mach=mach))
    elif case == "f32-shared-wind":
        scene_b = dataclasses.replace(
            scene_b, wind=dataclasses.replace(wind, wind=wind.wind[0].contiguous()))
    scene_nw, grid, table, ics = prepare_batch(scene_b, ic_b)
    got = run_emulated(emulated, scene_nw, grid, table, ics, WINDOW)
    ref = fs.flight_summary_reference(scene_nw, grid, table, ics, WINDOW)
    compare(ref, got, dtype)
    if case == "f64-nan-wind-lane":
        assert bool(got["diverged"][7]) and int(got["n_steps"][7]) == 1
    elif case == "f32-nan-mach":
        assert bool(got["diverged"].all())
    else:
        assert not bool(got["diverged"].any()) and bool((got["n_steps"] > 200).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(COMBINED))
def test_emulated_flag_set_window(emulated, name, dtype):
    """Each flag set's build against the plain version on 64 dispersed
    lanes for 2 s. With the stall-limited moments the wind is scaled 4x, so
    that lanes leave the rail stalled, and lane 5's wind is NaN above 2 km
    (it runs on, not diverged, without the non-finite stop); the 60 m/s
    speed guard stops every lane as diverged within the window."""
    fields, stall, _ = flags_of(name)
    cfg = SimConfig(max_time=2.0, **fields)
    scene_b, ic_b = batch(64, dtype, seed=len(name))
    if stall:
        table = scene_b.wind.wind * 4.0
        table[5, scene_b.wind.altitudes > 2000.0] = float("nan")
        scene_b = dataclasses.replace(
            scene_b, wind=dataclasses.replace(scene_b.wind, wind=table),
            rocket=dataclasses.replace(scene_b.rocket, stall_limited_moments=True))
    scene_nw, grid, table, ics = prepare_batch(scene_b, ic_b)
    got = run_emulated(emulated, scene_nw, grid, table, ics, cfg)
    ref = fs.flight_summary_reference(scene_nw, grid, table, ics, cfg)
    compare(ref, got, dtype)
    if name == "speed_guard":
        assert bool(got["diverged"].all())
    elif stall:
        assert not bool(got["diverged"].any()) and bool(got["apogee_altitude"][5].isnan())
        assert bool((got["rail_exit_angle_of_attack"].abs() > 0.2618).any())
    else:
        assert not bool(got["diverged"].any()) and bool((got["n_steps"] > 200).all())


def check_record_build(libs, args, cfg, dtype):
    """The emulated recording build against the plain recorder on prepared
    inputs ``args``; its summary the summary build's, bit for bit, and the
    plain version's within the bars. Returns ``(summary, records)``."""
    got, recs = record_emulated(libs, *args, cfg)
    ref, ref_recs = fs.flight_record_reference(*args, cfg)
    compare(ref, got, dtype)
    if fs.kernel_flags(cfg) in libs:
        summary = run_emulated(libs, *args, cfg)
        for k in got:
            assert torch.equal(got[k].nan_to_num(-1.0), summary[k].nan_to_num(-1.0)), k
    compare_records(ref_recs, recs, dtype)
    assert not any(bool(v.isnan().any()) for k, v in recs.items() if k not in ("valid", "derived"))
    return got, recs


# the window's recording cases: name: (dtype, lanes, the derived channels);
# 1 lane, and 33, past the recording build's block of 32
RECORD_WINDOW_CASES = {
    "f32": (torch.float32, 64, {}),
    "f64": (torch.float64, 64, {}),
    "f32-1-lane-landing-channels": (torch.float32, 1,
                                    {"record_channels": RECORD_LANDING.record_channels}),
    "f64-33-lanes-landing-channels": (torch.float64, 33,
                                      {"record_channels": RECORD_LANDING.record_channels}),
    "f32-33-lanes-no-derived": (torch.float32, 33, {"record_derived": False}),
}


@pytest.mark.parametrize("case", list(RECORD_WINDOW_CASES))
def test_emulated_record_build_window(emulated, case):
    """Dispersed lanes for 2 s, a frame every 3 steps (lanes stop inside a
    block): the flight and the derived pass of the recording build together
    against the plain recorder, with every derived channel, the landing
    run's subset, or none (no derived pass)."""
    dtype, n, channels = RECORD_WINDOW_CASES[case]
    cfg = dataclasses.replace(RECORD_WINDOW, **channels)
    args = prepare_batch(*batch(n, dtype, seed=9))
    got, recs = check_record_build(emulated, args, cfg, dtype)
    steps = got["n_steps"].to(torch.int64)
    if n > 1:
        assert bool((steps % 3 != 0).any())
    assert torch.equal(recs["valid"].sum(0), -(-steps // 3) + 1)
    assert tuple(recs["derived"]) == fs.record_names(cfg)


def test_emulated_record_build_tiered_to_landing(emulated):
    """The 5 kg low-apogee scene of tests/test_descent.py to landing under
    scripts/full_flights.py's set in float64: coarse quiet coast, fine steps
    through the chute latch, coarse canopy descent, the lane's own time; the
    mask records four derived channels (six with the Euler angles)."""
    f64 = torch.float64
    pm = LOW_APOGEE_PROPELLANT[0]
    scene = dataclasses.replace(
        nominal_scene(liquid_motor("cpu", f64, propellant_mass=pm), WindField.zero("cpu", f64)),
        rocket=RocketParams.create("cpu", f64, propellant_mass=pm))
    ic = InitialConditions.vertical_launch("cpu", f64)
    args = prepare_batch(scene, InitialConditions(*(v[None] for v in (
        ic.position, ic.velocity, ic.attitude, ic.angular_velocity))))
    got, recs = check_record_build(emulated, args, RECORD_LANDING, torch.float64)
    assert bool(got["parachute_deployed"].all()) and bool((got["final_pz"] <= 0.5).all())
    assert set(recs["derived"]) == {"euler_roll", "euler_pitch", "euler_yaw", "mach",
                                    "thrust", "drag"}
    t = recs["time"][recs["valid"][:, 0], 0]
    dt = t.diff()
    assert float(dt.max() / dt[dt > 0].min()) > 8  # coarse and fine frames


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CARRY_CASES))
def test_emulated_carry_build_is_the_one_shot_build(emulated, case, dtype):
    """The carry build, chunk by chunk, against the one-shot build of the
    same flags, bit for bit in every output (NaN meeting NaN): 40 dispersed
    lanes of a 2 s window in chunks of 37 steps, two of them with a wind
    table NaN above 500 m and 2 km; under the full-flight set the two
    low-apogee scenes to landing in chunks of 500 steps (the tiered loop's
    own time and chute time carried). With the stacked engine's speed the
    NaN lanes' ``max_speed`` is 0, as the plain version's with that
    option."""
    fields, one_shot = carry_flags(case)
    if case == "full_flights":
        cfg, chunk = SimConfig(**fields), 500
        args = prepare_batch(*low_apogee_batch("cpu", dtype))
    else:
        cfg, chunk = SimConfig(max_time=2.0, **fields), 37
        scene_b, ic_b = batch(40, dtype, seed=3)
        table = scene_b.wind.wind.clone()
        table[5, scene_b.wind.altitudes > 2000.0] = float("nan")
        table[9, scene_b.wind.altitudes > 500.0] = float("nan")
        args = prepare_batch(dataclasses.replace(
            scene_b, wind=dataclasses.replace(scene_b.wind, wind=table)), ic_b)
    a = fs._kernel_args(*args, cfg, stacked_speed=one_shot.stacked_speed)
    assert a.build == one_shot
    out_f = torch.empty((len(fs._FLOAT_KEYS), a.n), dtype=dtype)
    out_i = torch.empty((len(INT_KEYS), a.n), dtype=torch.int32)
    assert emulated[one_shot][dtype](*fs.entry_args(a, cfg, out_f, out_i, None)) == 0
    want = fs._outputs(out_f, out_i)
    got, calls = chunked_emulated(emulated, args, cfg, chunk, one_shot.stacked_speed)
    steps = int(want["n_steps"].max())
    assert calls == [(k, fs.max_chunks(cfg, chunk)) for k in range(1, -(-steps // chunk) + 1)]
    assert len(calls) > 2
    for k in want:
        assert torch.equal(got[k], want[k]) or bool(
            (got[k].isnan() & want[k].isnan() | (got[k] == want[k])).all()), k
    if case == "full_flights":
        assert bool(got["parachute_deployed"].all()) and bool((got["final_pz"] <= 0.5).all())
    else:
        assert bool(got["diverged"][[5, 9]].all()) and not bool(got["diverged"][:5].any())
        nan_speed = got["max_speed"][[5, 9]]
        assert bool((nan_speed == 0).all() if one_shot.stacked_speed else nan_speed.isnan().all())
        compare(fs.flight_summary_reference(*args, cfg, stacked_speed=one_shot.stacked_speed),
                got, dtype)
