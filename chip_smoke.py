#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc``; without them it exits non-zero before printing any
result. Phases, each printing one line of its own numbers; any failure
raises and the run exits non-zero:

  0. environment: card name and power limit, torch / CUDA versions, nvcc;
  1. build ``erpl_monte_carlo_sim_tpu_torch/csrc/flight_summary.cu``;
  2. the kernel against its plain PyTorch version, both on the card, on the
     same dispersed lanes (``SimConfig(max_time=6.0)``): 1024 lanes in
     float32, 256 in float64 with one NaN-wind lane;
  3. the golden flight (nominal liquid motor, no wind, to landing) through
     the kernel against tests/golden/flight_liquid_nowind.json;
  4. the main path at the bench size: ``MonteCarloAnalyzer.run_monte_carlo``
     with 262,144 lanes and ``SimConfig(max_time=6.0)``, launch count from
     that run, then the kernel against its plain version at that shape,
     compared (float32 bars) and timed;
  5. the README quick start: full flights to landing, 16,384 lanes.

The line before the last is the kernel report (JSON), the last line the
device record (JSON).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "erpl_monte_carlo_sim_tpu_torch/csrc/flight_summary.cu"
REPLACES = (
    ("simulate_summary_component",
     "erpl_monte_carlo_sim_tpu/experimental/pallas_component.py:186"),
    ("simulate_summary_pallas",
     "erpl_monte_carlo_sim_tpu/experimental/pallas_kernel.py:217"),
)
WINDOW = 6.0
BENCH_LANES = 262_144
FULL_FLIGHT_LANES = 16_384
RTOL = {torch.float32: 2e-5, torch.float64: 5e-7}
ATOL = 1e-6


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def leaves(obj, path=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    else:
        yield path, obj


QUAT_KEYS = ("quat_w", "quat_x", "quat_y", "quat_z")


def compare(ref_out: dict, got_out: dict, dtype) -> float:
    """Every FlightSummary leaf built from the kernel's outputs ``got_out``
    against the one built from the plain version's ``ref_out`` (both
    ``flight_summary`` dicts): floats within ``RTOL[dtype]``/``ATOL``
    (float32 [B,3] leaves, and the range, against each lane's vector norm),
    integers and flags exact. Returns the largest absolute float difference;
    raises on any mismatch, naming every leaf that has one.

    In float32 the rail-exit Euler angles are held through the kernel output
    they are computed from, the launch quaternion (the host applies the same
    ``quaternion_to_euler`` to both sides). A launch is within a few tenths
    of a degree of vertical, where that extraction is ill-conditioned: pitch
    is asin(s) with |s| near 1 and is clamped at |s| >= 1, so one ulp of
    difference in the quaternion can move the angles far beyond the bar."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import _summary_pytree

    ref, got = _summary_pytree(ref_out), _summary_pytree(got_out)
    rtol = RTOL[dtype]
    landing_norm = torch.linalg.vector_norm(ref.landing_position, dim=-1)
    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(leaves(ref), leaves(got)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                lanes = (a != b).nonzero()[:5].flatten().tolist()
                bad.append(f"{path}: lanes {lanes} differ")
            continue
        if dtype == torch.float32 and path == ".rail.rail_exit_euler":
            path += " (as its launch quaternion)"
            a = torch.stack([ref_out[k] for k in QUAT_KEYS], dim=-1)
            b = torch.stack([got_out[k] for k in QUAT_KEYS], dim=-1)
        scale = a.abs()
        if dtype == torch.float32 and a.ndim == 2:
            scale = torch.linalg.vector_norm(a, dim=-1, keepdim=True).expand_as(a)
        elif dtype == torch.float32 and path == ".range":
            scale = landing_norm
        diff = (a - b).abs()
        same_nan = torch.isnan(a) & torch.isnan(b)
        ok = same_nan | (diff <= ATOL + rtol * scale)
        if not bool(ok.all()):
            i = (~ok).nonzero()[0].tolist()
            bad.append(f"{path}: {int((~ok).sum())} values, first at {i} "
                       f"plain={a[tuple(i)].item()!r} kernel={b[tuple(i)].item()!r}")
        finite = ~same_nan
        if bool(finite.any()):
            worst = max(worst, float(diff[finite].max()))
    if bad:
        raise AssertionError(f"kernel != plain ({dtype}, rtol {rtol}):\n  "
                             + "\n  ".join(bad))
    return worst


def sample_batch(n, dtype, seed=0):
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return sample_dispersions(gen, nominal_scene(liquid_motor(dev, dtype)),
                              InitialConditions.vertical_launch(dev, dtype), n=n)[:2]


def kernel_and_plain(scene_b, ic_b, cfg):
    """Both versions on the same prepared inputs: ``(plain, kernel)``
    output dicts."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.engine.component import table_wind_fn
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(scene_nw, grid, wind, ics, cfg)
    ref = fs.flight_summary_reference(scene_nw, cfg, table_wind_fn(grid, wind), ics)
    torch.cuda.synchronize()
    return ref, got


def cuda_ms(fn, reps=1):
    """Mean ms per call of ``fn`` by CUDA events, and its last result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def main() -> int:
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.component import table_wind_fn
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    phase("0 environment", device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
          python=sys.version.split()[0])
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    t0 = time.time()
    _, log = fs.build(verbose=True)
    build_s = time.time() - t0
    regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
    phase("1 build", seconds=f"{build_s:.2f}", ptxas=json.dumps(regs))

    # ---------------------------------------------------------------- 2
    cfg = SimConfig(max_time=WINDOW)
    for dtype, n in ((torch.float32, 1024), (torch.float64, 256)):
        scene_b, ic_b = sample_batch(n, dtype)
        if dtype == torch.float64:
            # one lane with a non-finite wind table above 2 km: it must
            # diverge at the same step in both versions
            wind = scene_b.wind.wind.clone()
            wind[7, scene_b.wind.altitudes > 2000.0] = float("nan")
            scene_b = dataclasses.replace(
                scene_b, wind=dataclasses.replace(scene_b.wind, wind=wind))
        t0 = time.time()
        ref, got = kernel_and_plain(scene_b, ic_b, cfg)
        secs = time.time() - t0
        err = compare(ref, got, dtype)
        if dtype == torch.float64 and not (bool(got["diverged"][7])
                                           and bool(ref["diverged"][7])):
            raise AssertionError("the NaN-wind lane did not diverge")
        phase(f"2 kernel=plain {str(dtype).split('.')[-1]}", lanes=n,
              max_abs_err=err, rtol=RTOL[dtype], atol=ATOL, both_seconds=f"{secs:.2f}",
              n_steps_max=int(got["n_steps"].max()), diverged=int(got["diverged"].sum()))

    # ---------------------------------------------------------------- 3
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.models import nominal_scene

    with open(os.path.join(ROOT, "tests", "golden", "flight_liquid_nowind.json")) as f:
        golden = json.load(f)
    # the bars of tests/test_flight.py: apogee 1e-5 in float64, 0.1% in float32
    for dtype, apogee_rel in ((torch.float64, 1e-5), (torch.float32, 1e-3)):
        scene = nominal_scene(liquid_motor(dev, dtype))
        ic = InitialConditions.vertical_launch(dev, dtype)
        ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                    ic.angular_velocity)))
        t0 = time.time()
        s = simulate_summary_batch(scene, ic1, SimConfig())
        torch.cuda.synchronize()
        secs = time.time() - t0
        apogee = float(s.apogee_altitude[0])
        checks = {
            "apogee": abs(apogee / golden["apogee_altitude"] - 1) <= apogee_rel,
            "rail_exit_speed": abs(float(s.rail.rail_exit_speed[0])
                                   / golden["rail_exit_speed"] - 1) <= 1e-4,
            "rail_exit_time": abs(float(s.rail.rail_exit_time[0])
                                  - golden["rail_exit_time"]) <= 0.011,
            "not_diverged": not bool(s.diverged[0]),
        }
        if dtype == torch.float64:
            checks["n_steps"] = abs(int(s.n_steps[0]) - (golden["n_steps"] - 1)) <= 20
        if not all(checks.values()):
            raise AssertionError(f"golden flight ({dtype}): {checks}, apogee {apogee}")
        phase(f"3 golden {str(dtype).split('.')[-1]}", apogee_m=apogee,
              golden_m=golden["apogee_altitude"],
              rail_exit_speed=float(s.rail.rail_exit_speed[0]),
              rail_exit_time=float(s.rail.rail_exit_time[0]),
              n_steps=int(s.n_steps[0]), seconds=f"{secs:.3f}")

    # ---------------------------------------------------------------- 4
    ic = InitialConditions.vertical_launch(dev)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW))
    mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)  # warm-up
    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    analysis = mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
    wall = time.time() - t0
    launches = fs.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the flight_summary kernel")
    stats_ok = all(math.isfinite(analysis[k][s]) for k in ("apogee_altitude", "range",
                                                            "flight_time")
                   for s in ("mean", "std", "min", "max"))
    if analysis["n_samples"] <= 0 or not stats_ok:
        raise AssertionError(f"main path result: n_samples={analysis['n_samples']}, "
                             f"finite stats={stats_ok}")
    steps = int(np.max(analysis["summary"].n_steps))
    phase("4 main path", lanes=BENCH_LANES, launches=launches,
          wall_s=f"{wall:.3f}", trajectories_per_s=f"{BENCH_LANES / wall:.1f}",
          n_valid=analysis["n_samples"], n_outliers=analysis["n_outliers"],
          apogee_mean=analysis["apogee_altitude"]["mean"], max_steps=steps)

    # kernel against plain at the main path's shape, timed (not counted above)
    scene_b, ic_b = sample_batch(BENCH_LANES, torch.float32)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch

    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    fs.flight_summary(scene_nw, grid, wind, ics, cfg)
    kernel_ms, got = cuda_ms(lambda: fs.flight_summary(scene_nw, grid, wind, ics, cfg),
                             reps=3)
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(
        scene_nw, cfg, table_wind_fn(grid, wind), ics))
    main_err = compare(ref, got, torch.float32)
    phase("4 kernel vs plain", lanes=BENCH_LANES, max_abs_err=main_err,
          rtol=RTOL[torch.float32], atol=ATOL, kernel_ms=f"{kernel_ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", speedup=f"{plain_ms / kernel_ms:.1f}")

    # ---------------------------------------------------------------- 5
    mc_full = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig())
    torch.cuda.synchronize()
    t0 = time.time()
    full = mc_full.run_monte_carlo(ic, n_samples=FULL_FLIGHT_LANES, seed=0)
    wall_full = time.time() - t0
    if full["n_samples"] <= 0 or not math.isfinite(full["apogee_altitude"]["mean"]):
        raise AssertionError("full-flight run produced no valid lanes")
    phase("5 full flights", lanes=FULL_FLIGHT_LANES, wall_s=f"{wall_full:.3f}",
          n_outliers=full["n_outliers"], apogee_mean=full["apogee_altitude"]["mean"],
          flight_time_mean=full["flight_time"]["mean"],
          max_steps=int(np.max(full["summary"].n_steps)))

    report = {"kernels": [
        {"name": f"flight_summary ({name})", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": where, "launches": launches, "max_abs_err": main_err,
         "ms": kernel_ms, "plain_ms": plain_ms}
        for name, where in REPLACES
    ]}
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
