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
     compared (float32 bars) and timed, beside its bound (the least time an
     H100 could take for those flights, ``flight_summary.bound_ms``), the
     share of it the kernel reaches, its registers, spills and warps per SM;
  5. the README quick start: full flights to landing, 16,384 lanes;
  6. the SimConfig opt-ins: for each flag set of ``kernels/measure.py
     FLAG_SETS`` (each opt-in alone, scripts/full_flights.py's set, that set
     with rk2), the kernel against its plain version, both on the card: in
     float32 at the main path's shape (262,144 lanes, ``max_time=6.0``),
     where the kernel is then timed beside its bound; in float64 on 256
     lanes, the kernel then timed at B=65,536; registers and spills of each
     build. The two tiered sets also fly the low-apogee scenes of
     tests/test_descent.py to landing, in both precisions. A lane that the
     speed guard stops a step apart in the two versions, at a speed within
     the bar of the guard, is a tie of the last bits (``guard_ties``): it
     is counted and left out of the comparison;
  7. stabilized full flights: ``run_monte_carlo`` with 262,144 float32
     lanes to landing under scripts/full_flights.py's set, then under
     ``energy_consistent_aero`` alone; walls, outliers (at most 1% with the
     tiered timestep), median steps (the tiered run's at least 2.5 times
     fewer), launches, the kernel's time on the run's own lanes and its
     bound. Under the tiered set the kernel is also held to its plain
     version on the run's first 1024 lanes, flown to landing: in float32 up
     to the landing ties of ``landing_ties`` (lanes that land a step apart
     after thousands of steps of last-bit drift), and the same flights
     widened to float64 on every lane;
  8. the golden-lane certificates of tests/test_mc_distribution_parity.py,
     float64, through the kernel: the 500 calm lanes lane-matched to the
     executed reference, and the 220 forecast lanes, whose pass count in
     parity physics matches the reference's and which all stay valid with
     ``energy_consistent_aero``;
  9. runs larger than one device call, float32, ``SimConfig(max_time=6.0)``:
     (a) ``run_monte_carlo`` with 1,048,576 lanes, 4 slabs of the default
     262,144, whose metrics, masks and stats blocks must be those of 4
     single calls on the slabs' lanes (``slab_seed``), then the same run
     timed stage by stage (sampling, kernel, and the host's readback and
     accumulators, synchronized at each boundary); (b) 8,388,608 lanes, 32
     slabs, streaming past 4,194,304, every lane kept in the prefix: exact
     moments, the sketch's percentiles within 1e-3 of their mass in rank and
     1e-3 sigma in value (``flight_time``, which takes one or two values in
     the window, within 1e-6 of ``np.percentile``), intervals bracketing the
     exact percentiles, sketch exceedances within 1e-3, and the same run
     timed at 1,048,576 lanes a slab, then both split stage by stage as in
     (a) (sums, median and largest host share); (c) run (a) killed after
     slab 2 with a checkpoint after every slab, then resumed: run (a)'s
     analysis bit for bit, the checkpoint gone; (d) ``run_to_precision`` on the apogee's mean
     stderr, met after 2 or 3 slabs: ``run_monte_carlo(n_samples=n_used)``'s
     analysis bit for bit but for ``performance`` and ``sequential``. Each
     run counts its kernel launches from 0: one a slab;
 10. lanes flown again with their trajectories recorded, through the
     kernel's recording build (``MonteCarloAnalyzer.resimulate_trajectories``,
     launches counted from 0 before each): (a) 256 lanes spread over phase
     4's run, float32, every summary leaf the run's bit for bit, 64 of the
     trajectories held to the plain recorder on the card at the float32
     bars (``compare_records``), and the same 256 lanes in float64 at rtol
     5e-7; (b) the same for 256 stabilized full flights to landing (phase
     7's set), 64 of them held to the plain recorder in float32 (the
     summaries as phase 7 holds them, ``tied_landings``; the frames up to
     each lane's float32 horizon, ``f32_horizon``, past which the float32
     flight no longer follows the float64 one within the bars; the frame
     epilogue recomputed by the plain ``derived_c`` on every frame to
     landing) and in float64 to landing; each recording's last frame is
     its summary's final state bit for bit; (c) one lane
     from each slab of 9a's 4-slab run, equal to its ``metrics``; (d) in
     float64, the frame-path envelope fed by the kernel against the same
     envelope fed by the plain recorder (counts and histograms exact,
     moments at 1e-9), the in-loop envelope against the frame path, and
     the in-loop reduction alone timed on 2,048 lanes. The recording
     builds are timed in both precisions beside their bound.

Phases 2, 4, 5 and 6 also print ``digest`` lines: the SHA-256 of the
kernel's outputs with NaN made canonical (``kernels/measure.py digest``). A
change to the kernel that moves no bit leaves every digest as it was.

The line before the last is the kernel report (JSON), the last line the
device record (JSON).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from erpl_monte_carlo_sim_tpu_torch.kernels.measure import (
    FLAG_SETS, card_line, cuda_ms, digest, flag_set, low_apogee_batch, occupancy, ptxas_usage,
    sample_batch, time_kernel, with_stall)

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
# phase 6: each flag set's window is compared and timed at the main path's
# shape in float32; float64 is compared on 256 lanes and timed at B=65,536.
# The tiered sets also fly the low-apogee scenes to landing (about 3k
# steps) in both precisions.
FLAG_LANES = {torch.float32: BENCH_LANES, torch.float64: 256}
F64_TIMED_LANES = 65_536
TO_LANDING = ("full_flights", "full_flights+rk2")
# phase 9: 4 slabs at the default lane_slab; 32 slabs, past the (default)
# streaming threshold
LARGE_LANES = 4 * BENCH_LANES
STREAM_LANES = 32 * BENCH_LANES
STREAM_THRESHOLD = 4_194_304
# phase 7: lanes of the tiered run held to the plain version to landing
# (about 5-8k steps; the plain version's step costs about the same for
# any lane count up to some thousands)
SLICE_LANES = 1024
RTOL = {torch.float32: 2e-5, torch.float64: 5e-7}
ATOL = 1e-6
# phase 10: lanes re-simulated; of them, lanes held to the plain recorder
# on the card; lanes of the envelope runs and of its kernel-fed against
# plain-fed check
RESIM_LANES = 256
HELD_LANES = 64
ENVELOPE_LANES = 4096
ENVELOPE_HELD = 1024


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


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


# the frame's state channels held, in float32, against one scale per vector
STATE_SCALES = (("px", "py", "pz"), ("vx", "vy", "vz"), ("qw", "qx", "qy", "qz"),
                ("ox", "oy", "oz"), ("frac",), ("time",))
EULER_KEYS = ("euler_roll", "euler_pitch", "euler_yaw")
# float32 rounding of an Euler angle's arguments, in both versions together
EULER_ROUNDING = 16 * torch.finfo(torch.float32).eps


def euler_slack(q_ref: torch.Tensor, q_got: torch.Tensor) -> torch.Tensor:
    """How far each Euler angle (roll, pitch, yaw as ``quaternion_to_euler``
    takes them; ``[..., 3]``) of the quaternion ``q_got`` may lie from the
    same angle of ``q_ref`` (``[..., 4]``), given how far the two
    quaternions lie apart: the extraction's own conditioning. With ``d``
    the largest difference of a component, the two arguments of roll's and
    of yaw's atan2 move by at most 10 d (1 + d) together and pitch's sine by
    4 d (1 + d), plus ``EULER_ROUNDING``. The angle of a vector of length r
    (the cosine of the pitch) turns by at most (pi/2) e / r for a move e
    < r, and by up to pi past it (near vertical, roll and yaw are not
    defined); asin moves by at most e / sqrt(1 - s^2), s the largest sine
    within reach, and never by more than (pi / sqrt 2) sqrt(e)."""
    d = (q_got - q_ref).abs().amax(-1)
    w, x, y, z = q_ref.unbind(-1)
    e_vec = 10.0 * d * (1.0 + d) + EULER_ROUNDING
    e_sin = 4.0 * d * (1.0 + d) + EULER_ROUNDING

    def turn(a, b):
        r = torch.hypot(a, b)
        return torch.where(e_vec < r, (math.pi / 2) * e_vec / r, math.pi)

    hi = torch.clamp((2 * (w * y - z * x)).abs() + e_sin, max=1.0)
    pitch = torch.minimum(e_sin / torch.sqrt(1 - hi * hi),
                          (math.pi / math.sqrt(2)) * torch.sqrt(e_sin))
    return torch.stack([turn(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)), pitch,
                        turn(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))], dim=-1)


def record_checks(ref: dict, got: dict, dtype) -> list:
    """The per-value checks of ``compare_records``: ``(channel, ok, diff,
    plain, kernel)``, ``ok`` and ``diff`` shaped as the channel's values
    (``[T, B]``, or ``[k, T, B]`` for a state vector of k components)."""
    rtol, f32 = RTOL[dtype], dtype == torch.float32
    pairs = []
    for keys in STATE_SCALES:
        a = torch.stack([ref[k] for k in keys])
        scale = torch.linalg.vector_norm(a, dim=0, keepdim=True).expand_as(a) if f32 else a
        pairs.append(("/".join(keys), a, torch.stack([got[k] for k in keys]),
                      ATOL + rtol * scale.abs(), False))
    slack = None
    if f32 and EULER_KEYS[0] in ref["derived"]:
        slack = euler_slack(*(torch.stack([r[c] for c in ("qw", "qx", "qy", "qz")], dim=-1)
                              for r in (ref, got)))
    for k, a in ref["derived"].items():
        scale = a
        if f32:
            scale = torch.where(ref["valid"], a.abs(), 0.0).nan_to_num(0.0).amax(0, keepdim=True)
        tol = ATOL + rtol * scale.abs()
        if slack is not None and k in EULER_KEYS:
            tol = tol + slack[..., EULER_KEYS.index(k)]
        pairs.append((k, a, got["derived"][k], tol, k in ("euler_roll", "euler_yaw")))
    checks = []
    for name, a, b, tol, wraps in pairs:
        diff = b - a
        if wraps:
            diff = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
        diff = diff.abs()
        same_nan = torch.isnan(a) & torch.isnan(b)
        checks.append((name, same_nan | (diff <= tol), torch.where(same_nan, 0.0, diff), a, b))
    return checks


def compare_records(ref: dict, got: dict, dtype, keep=None) -> float:
    """The kernel's recorded frames ``got`` against the plain recorder's
    ``ref`` (``flight_record`` records, ``[T, B]``): ``valid`` exact, the
    rest within ``RTOL[dtype]``/``ATOL``, on the frames where ``keep``
    (``[T, B]``, every frame by default) holds. In float64 every value on
    its own. In float32, as ``compare`` holds vectors: each state vector
    against its norm at the frame, and each derived channel against its
    largest magnitude over the lane's valid frames (a channel that passes
    near zero, as cl or the angle of attack does, carries the absolute
    rounding of its scale); the Euler angles, ill-conditioned near vertical
    (ROADMAP F6), within that bar plus ``euler_slack`` of the two
    quaternions at the frame, roll and yaw modulo 2 pi. Returns the
    largest absolute difference; raises naming every channel that
    differs."""
    if keep is None:
        keep = torch.ones_like(ref["valid"])
    if not torch.equal(ref["valid"][keep], got["valid"][keep]):
        lanes = ((ref["valid"] != got["valid"]) & keep).any(0).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"recorded valid differs on lanes {lanes}")
    worst, bad = 0.0, []
    for name, ok, diff, a, b in record_checks(ref, got, dtype):
        ok = ok | ~keep
        if not bool(ok.all()):
            i = (~ok).nonzero()[0].tolist()
            bad.append(f"{name}: {int((~ok).sum())} values, first at {i} "
                       f"plain={a[tuple(i)].item()!r} kernel={b[tuple(i)].item()!r}")
        held = torch.where(keep, diff, 0.0)
        if held.numel():
            worst = max(worst, float(held.max()))
    if bad:
        raise AssertionError(f"recorded frames: kernel != plain ({dtype}, rtol "
                             f"{RTOL[dtype]}):\n  " + "\n  ".join(bad))
    return worst


def f32_horizon(ref32: dict, ref64: dict) -> torch.Tensor:
    """Each lane's float32 horizon ``[B]``: the first frame at which the
    plain recorder's float32 flight ``ref32`` leaves the float32 bars
    (``compare_records``) of its float64 flight ``ref64`` (the same lanes,
    the inputs widened exactly), or the frame count if it never does.
    Past it the flight in float32 no longer follows the flight within the
    bars, whoever computes it: over a stabilized full flight the attitude
    (and all that depends on it) is ill-conditioned in float32."""
    out = torch.zeros_like(ref64["valid"])
    for _, ok, _, _, _ in record_checks(ref64, ref32, torch.float32):
        out |= ~(ok.all(0) if ok.ndim == 3 else ok)
    out &= ref32["valid"] & ref64["valid"]
    n = out.shape[0]
    return torch.where(out.any(0), out.to(torch.int8).argmax(0), n)


def lanes_off_bars(ref: dict, got: dict, dtype, upto: torch.Tensor) -> int:
    """Lanes on which a recorded value of ``got`` lies outside the bars of
    ``compare_records`` around ``ref`` on some frame before ``upto [B]``."""
    frame = torch.arange(ref["valid"].shape[0], device=upto.device)[:, None]
    off = torch.zeros_like(ref["valid"])
    for _, ok, _, _, _ in record_checks(ref, got, dtype):
        off |= ~(ok.all(0) if ok.ndim == 3 else ok)
    return int((off & (frame < upto[None, :])).any(0).sum())


def derived_of_frames(args, recs: dict, cfg) -> dict:
    """``recs`` with its derived channels recomputed by the plain version
    (``engine.component.derived_c``) from each frame's own state and time:
    the recording build's frame epilogue, evaluated apart from the flight
    that led to the frame. ``args`` are the prepared inputs of ``recs``'
    lanes."""
    from erpl_monte_carlo_sim_tpu_torch.engine.component import derived_c, table_wind_fn
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    wind_fn = table_wind_fn(args[1], fs.stored_wind(args[2], cfg))
    derived = {k: torch.empty_like(v) for k, v in recs["derived"].items()}
    n, chunk = recs["time"].shape[0], 1024
    for i in range(0, n, chunk):
        d = derived_c(args[0], cfg, wind_fn, recs["time"][i:i + chunk],
                      tuple(recs[k][i:i + chunk] for k in fs.FRAME_KEYS[1:]))
        for k, v in derived.items():
            v[i:i + chunk] = d[k]
    return {**recs, "derived": derived}


def terminal_is_summary(recs: dict, res: dict, tag: str) -> None:
    """Each lane's last valid frame is its summary's final state and flight
    time, bit for bit (NaN meets NaN): both come from the same registers."""
    stop = stop_frames(recs).long()[None]
    for k, o in (("time", "flight_time"), ("px", "final_px"), ("py", "final_py"),
                 ("pz", "final_pz"), ("vx", "final_vx"), ("vy", "final_vy"),
                 ("vz", "final_vz")):
        a, b = recs[k].gather(0, stop)[0], res[o]
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            raise AssertionError(f"{tag}: the terminal frame's {k} is not the summary's {o}")


def records_of(traj, n: int) -> dict:
    """The first ``n`` lanes of a ``Trajectory`` as ``flight_record``
    records: ``[T, n]`` tensors, the Euler angles split again."""
    def tm(x):
        return x[:n].movedim(0, 1)

    recs = {"time": tm(traj.time), "frac": tm(traj.propellant_fraction),
            "valid": tm(traj.valid)}
    for keys, leaf in ((("px", "py", "pz"), traj.position), (("vx", "vy", "vz"), traj.velocity),
                       (("qw", "qx", "qy", "qz"), traj.quaternion),
                       (("ox", "oy", "oz"), traj.angular_velocity)):
        recs.update({k: tm(leaf[..., i]) for i, k in enumerate(keys)})
    derived = {k: tm(v) for k, v in traj.derived.items() if k != "euler_angles"}
    if "euler_angles" in traj.derived:
        derived.update({k: tm(traj.derived["euler_angles"][..., i])
                        for i, k in enumerate(EULER_KEYS)})
    recs["derived"] = derived
    return recs


def plain_data(obj):
    """An analysis as nested dicts, lists and NumPy arrays: dataclasses and
    accumulator objects (streams, reservoirs) become dicts of their fields,
    tensors arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: plain_data(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain_data(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_data(v) for v in obj]
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return plain_data(vars(obj))
    return obj


def same_analysis(a: dict, b: dict, skip=("performance",)) -> None:
    """Two analyses equal bit for bit (NaN meets NaN) in every key but
    ``skip``; raises on the first difference."""
    if a.keys() != b.keys():
        raise AssertionError(f"analysis keys differ: {sorted(a.keys() ^ b.keys())}")
    for k in a:
        if k not in skip:
            np.testing.assert_equal(plain_data(a[k]), plain_data(b[k]), err_msg=k)


def golden_lanes(config: str):
    """The executed-reference Monte Carlo golden ``tests/golden/mc_{config}.jsonl``
    as ``(params, grid, wind, metrics)`` of NumPy arrays, the form
    ``inject_reference_lanes`` takes. ``density_mult`` is 1: the reference's
    density perturbation does not act (tests/test_mc_distribution_parity.py)."""
    with open(os.path.join(ROOT, "tests", "golden", f"mc_{config}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if any(r["failed"] for r in recs):
        raise ValueError(f"mc_{config}.jsonl holds failed reference runs")
    params = {k: np.array([r["params"][k] for r in recs])
              for k in ("mass_mult", "motor_thrust_mult", "motor_mdot_mult",
                        "pos_off", "vel_off", "att_off", "omg_off")}
    params["density_mult"] = np.ones(len(recs))
    metrics = {k: np.array([r["metrics"][k] for r in recs]) for k in recs[0]["metrics"]}
    return (params, np.array(recs[0]["wind_grid"]),
            np.array([r["wind_profile"] for r in recs]), metrics)


def kernel_and_plain(scene_b, ic_b, cfg):
    """Both versions on the same prepared inputs: ``(plain, kernel)``
    output dicts."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(scene_nw, grid, wind, ics, cfg)
    ref = fs.flight_summary_reference(scene_nw, grid, wind, ics, cfg)
    torch.cuda.synchronize()
    return ref, got


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


def plain_on_head(args, got, cfg, n=None):
    """The plain version on the first ``n`` lanes (all by default) of the
    prepared inputs ``args``, whose kernel outputs are ``got``: ``(plain
    out, kernel out on those lanes, plain ms)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    lanes = args[3][0].shape[0]
    n = n or lanes
    part = head(args, lanes, n)
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(*part, cfg))
    return ref, head(got, lanes, n), plain_ms


def drive(scene_b, ic_b, cfg):
    """One driven run through ``simulate_summary_batch`` (the user's entry
    point; launches counted from 0 just before it), then the kernel's own
    output dict on the same prepared inputs (the same launch again, not
    counted), which must be the driven run's: ``(args, kernel out,
    launches)``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    fs.launches = 0
    summary = simulate_summary_batch(scene_b, ic_b, cfg)
    launched = fs.launches
    if launched < 1:
        raise AssertionError("simulate_summary_batch did not launch the kernel")
    args = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(*args, cfg)
    if not torch.equal(got["apogee_altitude"].nan_to_num(-1.0),
                       summary.apogee_altitude.nan_to_num(-1.0)):
        raise AssertionError("the driven run and the kernel differ")
    return args, got, launched


# the outputs a flight's landing decides
LANDING_KEYS = ("range", "flight_time", "final_px", "final_py", "final_pz", "final_vx",
                "final_vy", "final_vz", "n_steps")


def landing_ties(ref, got, dtype):
    """Lanes on which the two versions disagree, beyond the bars, about the
    landing: its step (``n_steps``), time, position or velocity. In float32
    over thousands of steps the state drifts by some of its last bits, and
    a lane that touches the ground close to a step boundary lands a step
    earlier in one version than in the other."""
    rtol = RTOL[dtype]
    bad = got["n_steps"] != ref["n_steps"]
    bad |= (got["flight_time"] - ref["flight_time"]).abs() > (
        ATOL + rtol * ref["flight_time"].abs())
    for axes in (("final_px", "final_py", "final_pz"), ("final_vx", "final_vy", "final_vz")):
        norm = torch.linalg.vector_norm(torch.stack([ref[k] for k in axes]), dim=0)
        for k in axes:
            bad |= (got[k] - ref[k]).abs() > ATOL + rtol * norm
    return bad


def tied_landings(ref, got, cfg, what: str):
    """Full flights in float32 (output dicts of the plain version ``ref``
    and the kernel ``got``): every leaf at the bars on every lane but the
    landing ties (``landing_ties``), at most 2% of the lanes, whose landing
    times differ by at most two coarse steps and whose other leaves
    (apogee, maximum speed, rail exit, chute, divergence) stay at the bars.
    Returns ``(largest absolute difference off the ties, ties [B], the
    ties' landing-time differences, their range differences)``."""
    ties = landing_ties(ref, got, torch.float32)
    kept = ~ties
    err = compare({k: v[kept] for k, v in ref.items()}, {k: v[kept] for k, v in got.items()},
                  torch.float32)
    compare({k: (got if k in LANDING_KEYS else ref)[k][ties] for k in ref},
            {k: v[ties] for k, v in got.items()}, torch.float32)
    dt_time = (got["flight_time"] - ref["flight_time"]).abs()[ties]
    d_range = (got["range"] - ref["range"]).abs()[ties]
    coarse = cfg.dt * cfg.descent_dt_scale
    if (int(ties.sum()) > 0.02 * ties.numel()
            or bool((dt_time > 2.0 * coarse * (1 + 1e-6)).any())):
        raise AssertionError(f"{what}: {int(ties.sum())} landing ties, landing times "
                             f"{dt_time.tolist()} apart")
    return err, ties, dt_time, d_range


def full_flights_against_plain(args, got, cfg, lanes, n=SLICE_LANES) -> dict:
    """Phase 7's check: the kernel against its plain version on the first
    ``n`` lanes of the run (prepared inputs ``args``, kernel outputs
    ``got``), flown to landing, in float32 as ``tied_landings`` holds them.
    The same flights in float64 (the inputs widened exactly): every leaf at
    the float64 bars on every lane."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    ref, got_n, plain_ms = plain_on_head(args, got, cfg, n)
    err, ties, dt_time, d_range = tied_landings(ref, got_n, cfg, "full flights")
    part64 = map_tensors(lambda t: t.double() if t.is_floating_point() else t,
                         head(args, lanes, n))
    got64 = fs.flight_summary(*part64, cfg)
    plain64_ms, ref64 = cuda_ms(lambda: fs.flight_summary_reference(*part64, cfg))
    return {"max_abs_err": err, "max_abs_err_lanes": int((~ties).sum()),
            "landing_ties": int(ties.sum()),
            "tie_flight_time_diff_max": float(dt_time.max()) if dt_time.numel() else 0.0,
            "tie_range_diff_max": float(d_range.max()) if d_range.numel() else 0.0,
            "plain_ms": plain_ms, "compared_n_steps_max": int(got_n["n_steps"].max()),
            "f64_max_abs_err": compare(ref64, got64, torch.float64), "f64_plain_ms": plain64_ms}


def guard_ties(ref, got, guard, dtype):
    """Lanes that the speed guard stops one step apart in the two versions,
    with a speed within the bar (``RTOL``) of the guard in either: there
    the last bits of the state, which the bars allow to differ, decide on
    which side of the guard a step's speed falls."""
    near = torch.minimum((got["max_speed"] - guard).abs(),
                         (ref["max_speed"] - guard).abs()) <= RTOL[dtype] * guard
    return ((got["n_steps"] - ref["n_steps"]).abs() == 1) & near


def check_flag_run(name, what, got, nan_lane):
    """What each flag set must show beyond kernel = plain."""
    div = got["diverged"].bool()
    if name == "speed_guard":  # exactly the lanes that reached the guard stopped
        ok = bool(div.any()) and torch.equal(div, got["max_speed"] >= FLAG_SETS[name][0][
            "speed_guard"])
    elif name == "terminate_nonfinite":
        ok = not bool(div.any()) and bool(got["apogee_altitude"][nan_lane].isnan())
    elif name == "stall_limited_moments":
        ok = not bool(div.any()) and bool(
            (got["rail_exit_angle_of_attack"].abs() > math.radians(15.0)).any())
    else:
        ok = not bool(div.any())
    if what == "to landing":
        ok = ok and bool(got["parachute_deployed"].all()) and bool(
            (got["final_pz"] <= 0.5).all())
    if not ok:
        raise AssertionError(f"flag set {name} ({what}): diverged {int(div.sum())}")


def reference_filter(metrics):
    """The reference's physics-outlier bounds (tests/test_mc_distribution_parity.py)."""
    apo, rng, ft = metrics["apogee_altitude"], metrics["range"], metrics["flight_time"]
    return ((apo < 80000.0) & (apo > 100.0) & (rng < 200000.0) & (ft < 600.0)
            & np.isfinite(apo) & np.isfinite(rng) & np.isfinite(ft))


def certificates(dev) -> None:
    """Phase 8: the bars of tests/test_mc_distribution_parity.py's
    test_calm_lane_matched_parity and test_forecast_divergence_rate_parity,
    float64, every flight through the kernel."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_summary_batch)
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import inject_reference_lanes, outlier_mask
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, solid_motor

    f64 = torch.float64
    ic = InitialConditions.vertical_launch(dev, f64)

    def fly(config, motor, cfg):
        params, grid, wind, metrics = golden_lanes(config)
        scene_b, ic_b = inject_reference_lanes(nominal_scene(motor(dev, f64)), ic, params,
                                               grid, wind)
        fs.launches = 0
        s = simulate_summary_batch(scene_b, ic_b, cfg)
        if fs.launches < 1:
            raise AssertionError(f"the {config} certificate did not launch the kernel")
        valid = outlier_mask(s)[0].cpu().numpy()
        return s, valid, metrics, fs.launches

    s, _, ref, launched = fly("calm", solid_motor, SimConfig())
    apo = s.apogee_altitude.cpu().numpy()
    sane = np.isfinite(ref["apogee_altitude"]) & (ref["apogee_altitude"] < 80000.0)
    a, r = apo[sane], ref["apogee_altitude"][sane]
    ft, at = s.flight_time.cpu().numpy(), s.apogee_time.cpu().numpy()
    mft = sane & (ref["flight_time"] < 600.0)
    calm = {
        "sane": int(sane.sum()),
        "lane_rel": float(np.max(np.abs(a - r) / np.abs(r))),
        "mean_rel": abs(a.mean() / r.mean() - 1), "std_rel": abs(a.std() / r.std() - 1),
        "pct_rel": max(abs(np.percentile(a, q) / np.percentile(r, q) - 1)
                       for q in (5, 25, 50, 75, 95)),
        "apogee_time_abs": float(np.abs(at[sane] - ref["apogee_time"][sane]).max()),
        "flight_time_mean_rel": abs(ft[mft].mean() / ref["flight_time"][mft].mean() - 1),
    }
    ok = (calm["sane"] >= 450 and calm["lane_rel"] <= 1e-4 and calm["mean_rel"] < 1e-4
          and calm["std_rel"] < 1e-3 and calm["pct_rel"] < 1e-4
          and calm["apogee_time_abs"] < 0.1 and calm["flight_time_mean_rel"] < 5e-3)
    phase("8 calm certificate", lanes=apo.size, launches=launched, passed=ok, **calm)
    if not ok:
        raise AssertionError(f"calm certificate: {calm}")

    s, mine, ref, launched = fly("forecast", liquid_motor, SimConfig())
    refpass = reference_filter(ref)
    both = mine & refpass
    worst = {}
    for ch, leaf, tol in (("apogee_altitude", s.apogee_altitude, 1e-8),
                          ("apogee_time", s.apogee_time, 1e-9),
                          ("flight_time", s.flight_time, 1e-9),
                          ("range", s.range, 1e-7), ("max_speed", s.max_speed, 1e-6),
                          ("rail_exit_speed", s.rail.rail_exit_speed, 1e-9),
                          ("rail_exit_time", s.rail.rail_exit_time, 1e-9)):
        v, w = leaf.cpu().numpy()[both], ref[ch][both]
        worst[ch] = float(np.max(np.abs(v - w) / np.abs(w))) if both.any() else 0.0
        worst[ch + "_ok"] = bool(np.all(np.abs(v - w) <= tol * np.abs(w)))
    s2, valid2, _, launched2 = fly("forecast", liquid_motor,
                                   SimConfig(energy_consistent_aero=True))
    forecast = {"ref_pass": int(refpass.sum()), "parity_pass": int(mine.sum()),
                "overlap": int(both.sum()), "energy_valid": int(valid2.sum()),
                "energy_diverged": int(s2.diverged.sum())}
    ok = (forecast["ref_pass"] < 0.1 * mine.size
          and abs(forecast["parity_pass"] - forecast["ref_pass"]) <= 6
          and forecast["overlap"] >= forecast["ref_pass"] - 3 and forecast["overlap"] >= 5
          and forecast["energy_valid"] == mine.size and forecast["energy_diverged"] == 0
          and all(v for k, v in worst.items() if k.endswith("_ok")))
    phase("8 forecast certificate", lanes=mine.size, launches=launched + launched2,
          passed=ok, **forecast,
          **{k: v for k, v in worst.items() if not k.endswith("_ok")})
    if not ok:
        raise AssertionError(f"forecast certificate: {forecast} {worst}")


def slab_reference(mc, ic, n, slab, seed):
    """What a slabbed run's per-lane arrays must be: one
    ``simulate_summary_batch`` call per slab on
    ``sample_dispersions(Generator().manual_seed(slab_seed(seed, k)))``, the
    first ``n`` lanes concatenated: ``(metrics, valid, reasons)``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.mc import outlier_mask, sample_dispersions, slab_seed
    from erpl_monte_carlo_sim_tpu_torch.mc.slab_accumulators import PREFIX_METRICS

    metrics, valid, reasons = {k: [] for k in PREFIX_METRICS}, [], []
    for k in range(-(-n // slab)):
        gen = torch.Generator(device=mc.device)
        gen.manual_seed(slab_seed(seed, k))
        scene_b, ic_b, _ = sample_dispersions(gen, mc.scene, ic, mc.uncertainty_params, slab,
                                              wind_grid_points=mc.wind_grid_points,
                                              wind_grid_top=mc.wind_grid_top)
        s = simulate_summary_batch(scene_b, ic_b, mc.sim_config)
        v, r = outlier_mask(s, mc.bounds)
        take = min(slab, n - k * slab)
        for key in metrics:
            metrics[key].append(getattr(s, key)[:take].cpu().numpy())
        valid.append(v[:take].cpu().numpy())
        reasons.append(r[:take].cpu().numpy())
    return ({k: np.concatenate(v) for k, v in metrics.items()}, np.concatenate(valid),
            np.concatenate(reasons))


def staged_run(mc, ic, n, **kw):
    """``run_monte_carlo(n_samples=n, **kw)`` with the card synchronized at each
    stage boundary of every slab: ``(sampling ms, kernel ms, host ms)`` per
    slab, the host's share being the readback and the accumulators from the
    kernel's end to the next slab's draw (the last slab's runs into the
    run's end, so its share includes the final statistics), and the wall."""
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod

    marks = []
    draw, fly = analyzer_mod._draw_slab, analyzer_mod.simulate_summary_batch

    def timed(stage, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            marks.append((stage, t0, time.perf_counter()))
            return out
        return call

    analyzer_mod._draw_slab = timed("sampling", draw)
    analyzer_mod.simulate_summary_batch = timed("kernel", fly)
    try:
        t0 = time.perf_counter()
        mc.run_monte_carlo(ic, n_samples=n, seed=0, **kw)
        end = time.perf_counter()
    finally:
        analyzer_mod._draw_slab, analyzer_mod.simulate_summary_batch = draw, fly
    spans = {stage: [(a, b) for s, a, b in marks if s == stage]
             for stage in ("sampling", "kernel")}
    next_start = [a for a, _ in spans["sampling"][1:]] + [end]
    return ([1e3 * (b - a) for a, b in spans["sampling"]],
            [1e3 * (b - a) for a, b in spans["kernel"]],
            [1e3 * (nxt - b) for (_, b), nxt in zip(spans["kernel"], next_start)], end - t0)


def large_runs(dev, ic) -> dict:
    """Phase 9; returns each run's kernel launches."""
    import tempfile

    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, exceedance_from_analysis
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.mc.analyzer import _host_stats
    from erpl_monte_carlo_sim_tpu_torch.mc.stats import PERCENTILES
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    cfg = SimConfig(max_time=WINDOW)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg)
    launches = {}

    def driven(tag, slabs, fn):
        """One run of the main path with the launches counted from 0, which
        must be one a slab it flies. Returns the analysis and the wall."""
        torch.cuda.synchronize()
        fs.launches = 0
        t0 = time.time()
        out = fn()
        wall = time.time() - t0
        launches[tag] = fs.launches
        if fs.launches != slabs:
            raise AssertionError(f"phase {tag}: {fs.launches} launches for {slabs} slabs")
        return out, wall

    # ---- 9a: 4 slabs, the per-lane arrays of 4 single calls
    a, wall = driven("9a", 4, lambda: mc.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0))
    metrics, valid, reasons = slab_reference(mc, ic, LARGE_LANES, BENCH_LANES, 0)
    for k, v in metrics.items():
        if not np.array_equal(a["metrics"][k], v, equal_nan=True):
            raise AssertionError(f"9a: metrics.{k} differ from the single calls")
    if not (np.array_equal(a["valid_mask"], valid) and np.array_equal(a["reasons"], reasons)):
        raise AssertionError("9a: masks differ from the single calls")
    for k in ("apogee_altitude", "range", "flight_time"):
        np.testing.assert_equal(a[k], _host_stats(metrics[k], valid), err_msg=f"9a {k}")
    phase("9a large run", lanes=LARGE_LANES, slabs=4, launches=launches["9a"],
          wall_s=f"{wall:.3f}", lanes_per_s=f"{LARGE_LANES / wall:.1f}",
          n_valid=a["n_samples"], apogee_mean=a["apogee_altitude"]["mean"],
          single_calls_equal=True)
    sampling, kernel, host, staged_wall = staged_run(mc, ic, LARGE_LANES)
    phase("9a per-slab split", wall_s=f"{staged_wall:.3f}",
          sampling_ms=json.dumps([round(x, 3) for x in sampling]),
          kernel_ms=json.dumps([round(x, 3) for x in kernel]),
          host_ms=json.dumps([round(x, 3) for x in host]))

    # ---- 9b: 32 slabs, streaming; the prefix keeps every lane
    mc_s = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg,
                              stats_stream_threshold=STREAM_THRESHOLD,
                              metrics_sample_cap=STREAM_LANES)
    b, wall_b = driven("9b", 32, lambda: mc_s.run_monte_carlo(ic, n_samples=STREAM_LANES,
                                                              seed=0))
    if not b["metrics_is_sample"] or b["valid_mask"].size != STREAM_LANES:
        raise AssertionError("9b: not a streaming run that kept every lane")
    worst = {"mean_rel": 0.0, "std_rel": 0.0, "rank": 0.0, "value_sigma": 0.0,
             "flight_time_rel": 0.0, "exceed": 0.0}
    for k in ("apogee_altitude", "range", "flight_time"):
        blk, stream = b[k], b["streams"][k]
        vals = b["metrics"][k][b["valid_mask"]].astype(np.float64)
        vals = np.sort(vals[np.isfinite(vals)])
        if stream.is_exact or stream.n != vals.size:
            raise AssertionError(f"9b {k}: the stream kept {stream.n} of {vals.size} lanes "
                                 f"(exact={stream.is_exact})")
        sigma = vals.std()
        worst["mean_rel"] = max(worst["mean_rel"], abs(blk["mean"] / vals.mean() - 1))
        worst["std_rel"] = max(worst["std_rel"], abs(blk["std"] / sigma - 1) if sigma else 0.0)
        if blk["min"] != vals[0] or blk["max"] != vals[-1]:
            raise AssertionError(f"9b {k}: min/max differ")
        exact = np.percentile(vals, PERCENTILES)
        for q, est, ex, (lo, hi) in zip(PERCENTILES, blk["percentiles"], exact,
                                        blk["percentile_ci"]):
            if not lo <= ex <= hi:
                raise AssertionError(f"9b {k} p{q}: interval [{lo}, {hi}] misses {ex}")
            if k == "flight_time":
                worst["flight_time_rel"] = max(worst["flight_time_rel"], abs(est / ex - 1))
                continue
            below = np.searchsorted(vals, est, "left") / vals.size
            upto = np.searchsorted(vals, est, "right") / vals.size
            worst["rank"] = max(worst["rank"], max(below - q / 100, q / 100 - upto, 0.0))
            if sigma > 0:
                worst["value_sigma"] = max(worst["value_sigma"], abs(est - ex) / sigma)
        if k != "flight_time":
            ts = np.percentile(vals, (10, 50, 90))
            for row, t in zip(exceedance_from_analysis(b, k, ts), ts):
                if row["method"] != "sketch":
                    raise AssertionError(f"9b {k}: exceedance by {row['method']}")
                worst["exceed"] = max(worst["exceed"], abs(row["probability"]
                                                           - np.mean(vals > t)))
    ok = (worst["mean_rel"] <= 1e-12 and worst["std_rel"] <= 1e-9 and worst["rank"] <= 1e-3
          and worst["value_sigma"] <= 1e-3 and worst["flight_time_rel"] <= 1e-6
          and worst["exceed"] <= 1e-3)
    big_slab = 4 * BENCH_LANES
    _, wall_big = driven("9b 1M slabs", 8, lambda: mc_s.run_monte_carlo(
        ic, n_samples=STREAM_LANES, seed=0, lane_slab=big_slab))
    phase("9b streaming", lanes=STREAM_LANES, slabs=32, launches=launches["9b"],
          wall_s=f"{wall_b:.3f}", lanes_per_s=f"{STREAM_LANES / wall_b:.1f}",
          wall_s_1m_slabs=f"{wall_big:.3f}", lanes_per_s_1m_slabs=f"{STREAM_LANES / wall_big:.1f}",
          launches_1m_slabs=launches["9b 1M slabs"], passed=ok, **worst)
    if not ok:
        raise AssertionError(f"9b: {worst}")
    del b
    for slab in (BENCH_LANES, big_slab):
        sampling, kernel, host, staged_wall = staged_run(mc_s, ic, STREAM_LANES, lane_slab=slab)
        phase("9b per-slab split", lane_slab=slab, wall_s=f"{staged_wall:.3f}",
              sampling_ms_sum=f"{sum(sampling):.1f}", kernel_ms_sum=f"{sum(kernel):.1f}",
              host_ms_sum=f"{sum(host):.1f}", host_ms_median=f"{np.median(host):.1f}",
              host_ms_max=f"{max(host):.1f}", host_ms_first=f"{host[0]:.1f}",
              host_ms_last=f"{host[-1]:.1f}")

    # ---- 9c: run (a) killed after slab 2, resumed from its checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.ckpt.npz")
        draw, calls = analyzer_mod._draw_slab, []

        def dying(*args, **kw):
            if len(calls) == 2:
                raise RuntimeError("simulated crash")
            calls.append(1)
            return draw(*args, **kw)

        analyzer_mod._draw_slab = dying
        try:
            mc.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0, checkpoint_path=path,
                               checkpoint_every=1)
            raise AssertionError("9c: the run did not stop at its third draw")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        finally:
            analyzer_mod._draw_slab = draw
        kept = os.path.exists(path)
        c, wall_c = driven("9c", 2, lambda: mc.run_monte_carlo(
            ic, n_samples=LARGE_LANES, seed=0, checkpoint_path=path, checkpoint_every=1))
        same_analysis(c, a)
        if not kept or os.path.exists(path):
            raise AssertionError(f"9c: checkpoint written {kept}, left after the run "
                                 f"{os.path.exists(path)}")
    phase("9c resume", lanes=LARGE_LANES, launches=launches["9c"], wall_s=f"{wall_c:.3f}",
          equal_to_9a=True)

    # ---- 9d: run_to_precision, met after 2 or 3 slabs
    hist = [row["apogee_altitude"]["stderr"] for row in a["convergence"]]
    target = hist[2]
    stop = next(i for i, x in enumerate(hist) if x <= target) + 1
    if stop not in (2, 3):
        raise AssertionError(f"9d: the stderr history {hist} stops at slab {stop}")
    d, wall_d = driven("9d", stop, lambda: mc.run_to_precision(
        ic, criteria=[{"metric": "apogee_altitude", "mean_stderr": target}],
        max_samples=2 * LARGE_LANES, seed=0))
    seq = d.pop("sequential")
    if seq["n_used"] != stop * BENCH_LANES or not seq["satisfied"]:
        raise AssertionError(f"9d: {seq}")
    same_analysis(d, mc.run_monte_carlo(ic, n_samples=seq["n_used"], seed=0))
    phase("9d run_to_precision", target_stderr_m=target, n_used=seq["n_used"],
          launches=launches["9d"], wall_s=f"{wall_d:.3f}", equal_to_run_monte_carlo=True)
    return launches


def spread(n_run: int, n: int) -> np.ndarray:
    """``n`` lane ids spread evenly over a run of ``n_run`` lanes."""
    return np.linspace(0, n_run - 1, n).round().astype(np.int64)


def resimulated(mc, ids, tag: str, want_launches: int):
    """The main path of phase 10: ``resimulate_trajectories(ids)``, the
    launches counted from 0 just before it and read just after. Returns
    ``(summary, trajectory, launches, wall s)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    s, traj = mc.resimulate_trajectories(ids)
    torch.cuda.synchronize()
    wall, launched = time.time() - t0, fs.launches
    if launched != want_launches:
        raise AssertionError(f"phase {tag}: {launched} launches of the recording build, "
                             f"{want_launches} expected")
    return s, traj, launched, wall


def same_summary(summary, run: dict, ids, tag: str) -> None:
    """A re-simulated ``FlightSummary`` equals the run's lanes ``ids`` bit
    for bit (NaN meets NaN): every leaf of a single call's ``summary``, or a
    slabbed run's ``metrics``."""
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

    got = to_numpy(summary)
    if run["summary"] is not None:
        for (path, a), (_, b) in zip(leaves(got), leaves(run["summary"])):
            np.testing.assert_array_equal(a, np.asarray(b)[ids], err_msg=f"{tag} {path}")
    else:
        for k, v in run["metrics"].items():
            np.testing.assert_array_equal(getattr(got, k), v[ids], err_msg=f"{tag} {k}")


def recording_row(fs, args, res, recs, cfg, ms, usage, flags) -> dict:
    """A kernels-JSON row of a recording build: its time, bound and share
    on these inputs, registers, spills and warps per SM."""
    dtype = args[3][0].dtype
    key = "f32" if dtype == torch.float32 else "f64"
    b = fs.bound_ms(res, cfg, dtype, fs.input_bytes(*args, cfg), recs)
    use = usage[key]
    threads, blocks = occupancy(fs, key, args[0], args[1], flags)
    return {"lanes": int(args[3][0].shape[0]), "frames": int(recs["time"].shape[0]),
            "channels": len(fs.FRAME_KEYS) + len(recs["derived"]), "ms": ms,
            "bound_ms": b.ms, "bound_by": b.by, "share_of_bound": b.ms / ms,
            "regs": use["regs"], "spill_bytes": use["spill_stores"] + use["spill_loads"],
            "warps_per_sm": blocks * threads // 32}


def widened(args):
    """Prepared inputs in float64, every float widened exactly."""
    return map_tensors(lambda t: t.double() if t.is_floating_point() else t, args)


def stop_frames(recs) -> torch.Tensor:
    """Each lane's last valid frame ``[B]``."""
    return recs["valid"].sum(0) - 1


ROW_KEYS = ("ms", "bound_ms", "share_of_bound", "regs", "spill_bytes", "warps_per_sm",
            "frames", "channels")


def recordings(dev, ic, mc4, run4, record_usage, record_flags) -> dict:
    """Phase 10; returns the kernels-JSON rows of the recording builds."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_flight_batch)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import (prepare_batch,
                                                             simulate_envelope_batch,
                                                             trajectory_of)
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import (EnvelopeAccumulator, EnvelopeConfig,
                                                   MonteCarloAnalyzer)
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    f32, f64 = torch.float32, torch.float64
    rows = {}

    # ---- 10a: 256 lanes of phase 4's run, window
    ids = spread(BENCH_LANES, RESIM_LANES)
    s, traj, launched, wall = resimulated(mc4, ids, "10a", 1)
    same_summary(s, run4, ids, "10a")
    cfg = mc4.sim_config
    args = prepare_batch(*mc4._select_lanes(ids))
    fs.flight_record(*args, cfg)  # warm-up
    ms, (res, recs) = cuda_ms(lambda: fs.flight_record(*args, cfg), reps=3)
    if not torch.equal(recs["pz"], records_of(traj, RESIM_LANES)["pz"]):
        raise AssertionError("10a: the timed recording is not the re-simulated one")
    terminal_is_summary(recs, res, "10a")
    part = head(args, RESIM_LANES, HELD_LANES)
    plain_ms, (ref, ref_recs) = cuda_ms(lambda: fs.flight_record_reference(*part, cfg))
    err = compare(ref, head(res, RESIM_LANES, HELD_LANES), f32)
    frame_err = compare_records(ref_recs, records_of(traj, HELD_LANES), f32)
    args64 = widened(args)
    fs.flight_record(*args64, cfg)  # warm-up
    ms64, (got64, recs64) = cuda_ms(lambda: fs.flight_record(*args64, cfg), reps=3)
    plain64_ms, (ref64, ref_recs64) = cuda_ms(lambda: fs.flight_record_reference(*args64, cfg))
    err64 = max(compare(ref64, got64, f64), compare_records(ref_recs64, recs64, f64))
    row = recording_row(fs, args, res, recs, cfg, ms, record_usage["parity"],
                        record_flags["parity"])
    row.update(launches=launched, plain_ms=plain_ms, max_abs_err=err,
               max_abs_err_lanes=HELD_LANES, frames_max_abs_err=frame_err,
               f64=recording_row(fs, args64, got64, recs64, cfg, ms64,
                                 record_usage["parity"], record_flags["parity"]))
    row["f64"].update(plain_ms=plain64_ms, max_abs_err=err64)
    rows["window"] = row
    phase("10a re-simulated window", lanes=RESIM_LANES, launches=launched,
          wall_s=f"{wall:.3f}", summary_equal_to_run=True, held_lanes=HELD_LANES,
          max_abs_err=err, frames_max_abs_err=frame_err, plain_ms=f"{plain_ms:.1f}",
          f64_lanes=RESIM_LANES, f64_max_abs_err=err64, f64_ms=f"{ms64:.3f}",
          f64_plain_ms=f"{plain64_ms:.1f}", **{k: row[k] for k in ROW_KEYS})
    del args, res, recs, args64, got64, recs64, ref_recs, ref_recs64, traj
    torch.cuda.empty_cache()

    # ---- 10b: 256 stabilized full flights of phase 7's run, to landing
    cfg7 = flag_set("full_flights")[0]
    mc7 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg7)
    run7 = mc7.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
    s, traj, launched, wall = resimulated(mc7, ids, "10b", 1)
    same_summary(s, run7, ids, "10b")
    args = prepare_batch(*mc7._select_lanes(ids))
    ms, (res, recs) = cuda_ms(lambda: fs.flight_record(*args, cfg7))
    steps = res["n_steps"]
    if not (bool(res["parachute_deployed"].all()) and bool((res["final_pz"] <= 0.5).all())):
        raise AssertionError("10b: not every lane landed under its chute")
    if not torch.equal(recs["pz"], records_of(traj, RESIM_LANES)["pz"]):
        raise AssertionError("10b: the timed recording is not the re-simulated one")
    terminal_is_summary(recs, res, "10b")
    # float32 to landing, 64 lanes: the summaries as phase 7 holds them; the
    # frames at the bars up to each lane's float32 horizon (and, on a
    # landing tie, before the earlier of the two stop frames, at most 3
    # apart); the frame epilogue at the bars on every frame to landing; and
    # the same lanes in float64 to landing at rtol 5e-7
    part = head(args, RESIM_LANES, HELD_LANES)
    plain_ms, (ref, ref_recs) = cuda_ms(lambda: fs.flight_record_reference(*part, cfg7))
    part64 = widened(part)
    fs.flight_record(*part64, cfg7)  # warm-up
    ms64, (got64, recs64) = cuda_ms(lambda: fs.flight_record(*part64, cfg7))
    plain64_ms, (ref64, ref_recs64) = cuda_ms(lambda: fs.flight_record_reference(*part64, cfg7))
    err64 = max(compare(ref64, got64, f64), compare_records(ref_recs64, recs64, f64))
    got_recs = records_of(traj, HELD_LANES)
    err, ties, dt_time, _ = tied_landings(ref, head(res, RESIM_LANES, HELD_LANES), cfg7, "10b")
    stop_ref, stop_got = stop_frames(ref_recs), stop_frames(got_recs)
    apart = (stop_ref - stop_got).abs()
    if bool((apart[~ties] != 0).any()) or int(apart.max()) > 3:
        raise AssertionError(f"10b: stop frames {apart.tolist()} apart, landing ties "
                             f"{ties.nonzero().flatten().tolist()}")
    horizon = f32_horizon(ref_recs, ref_recs64)
    landed = torch.minimum(stop_ref, stop_got)
    # what the horizon leaves out: lanes whose float32 flight leaves its
    # float64 flight's bars before landing, lanes on which the two versions
    # part before landing
    leave_f64 = lanes_off_bars(ref_recs64, ref_recs, f32, landed)
    leave_plain = lanes_off_bars(ref_recs, got_recs, f32, landed)
    upto = torch.where(ties, torch.minimum(horizon, landed), horizon)
    frame = torch.arange(ref_recs["valid"].shape[0], device=dev)[:, None]
    keep = frame < upto[None, :]
    frame_err = compare_records(ref_recs, got_recs, f32, keep=keep)
    held_frames = int((keep & got_recs["valid"]).sum())
    n = int(stop_got.max()) + 1
    got_recs = map_tensors(lambda t: t[:n], got_recs)
    epilogue_err = compare_records(derived_of_frames(part, got_recs, cfg7), got_recs, f32)
    del ref_recs, ref_recs64, got_recs, keep
    row = recording_row(fs, args, res, recs, cfg7, ms, record_usage["full_flights"],
                        record_flags["full_flights"])
    row.update(launches=launched, plain_ms=plain_ms, max_abs_err=err,
               max_abs_err_lanes=HELD_LANES - int(ties.sum()), frames_max_abs_err=frame_err,
               frames_held=held_frames, frames_valid=int((stop_got + 1).sum()),
               f32_horizon_median=float(horizon.double().median()),
               f32_lanes_leaving_f64=leave_f64, lanes_leaving_plain=leave_plain,
               epilogue_max_abs_err=epilogue_err, landing_ties=int(ties.sum()),
               tie_flight_time_diff_max=float(dt_time.max()) if dt_time.numel() else 0.0,
               median_n_steps=float(steps.double().median()), max_n_steps=int(steps.max()),
               f64=recording_row(fs, part64, got64, recs64, cfg7, ms64,
                                 record_usage["full_flights"], record_flags["full_flights"]))
    row["f64"].update(plain_ms=plain64_ms, max_abs_err=err64)
    rows["full_flights"] = row
    phase("10b re-simulated full flights", lanes=RESIM_LANES, launches=launched,
          wall_s=f"{wall:.3f}", summary_equal_to_run=True, held_lanes=HELD_LANES,
          landing_ties=row["landing_ties"], max_abs_err=err, frames_max_abs_err=frame_err,
          **{k: row[k] for k in ("frames_held", "frames_valid", "f32_horizon_median",
                                 "f32_lanes_leaving_f64", "lanes_leaving_plain",
                                 "epilogue_max_abs_err")},
          plain_ms=f"{plain_ms:.1f}", f64_held_lanes=HELD_LANES, f64_max_abs_err=err64,
          f64_ms=f"{ms64:.3f}", f64_plain_ms=f"{plain64_ms:.1f}",
          **{k: row[k] for k in ROW_KEYS + ("median_n_steps", "max_n_steps")})
    del args, res, recs, traj, mc7, run7, part64, got64, recs64
    torch.cuda.empty_cache()

    # ---- 10c: one lane of each slab of 9a's run
    mc9 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW))
    run9 = mc9.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0)
    ids9 = np.array([7, BENCH_LANES + 1234, 2 * BENCH_LANES + 99_999, 4 * BENCH_LANES - 1])
    s, _, launched9, wall = resimulated(mc9, ids9, "10c", 4)
    same_summary(s, run9, ids9, "10c")
    phase("10c re-simulated slabbed", lanes=ids9.tolist(), launches=launched9,
          wall_s=f"{wall:.3f}", metrics_equal_to_run=True)
    del mc9, run9

    # ---- 10d: envelopes, float64
    mce = MonteCarloAnalyzer(motor=liquid_motor(dev, f64), sim_config=SimConfig(max_time=WINDOW))
    mce.run_monte_carlo(InitialConditions.vertical_launch(dev, f64), n_samples=ENVELOPE_LANES,
                        seed=0)
    env = EnvelopeConfig()
    half = ENVELOPE_LANES // 2
    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    frm = mce.flight_envelope(n_lanes=ENVELOPE_LANES, chunk=half, env_config=env)
    wall_f, launched_f = time.time() - t0, fs.launches
    t0 = time.time()
    inl = mce.flight_envelope(n_lanes=ENVELOPE_LANES, chunk=half, env_config=env, inline=True)
    wall_i = time.time() - t0
    for ch in env.channels:
        a, b = frm["channels"][ch], inl["channels"][ch]
        if a["n"] != b["n"]:
            raise AssertionError(f"10d {ch}: in-loop counts differ from the frame path's")
        for key, rtol, atol in (("min", 1e-12, 0.0), ("max", 1e-12, 0.0), ("mean", 1e-9, 1e-12),
                                ("std", 1e-6, 1e-9)):
            np.testing.assert_allclose(b[key], a[key], rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"10d in-loop {ch} {key}")
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=f"10d in-loop {ch} p{q}")
    # the kernel's frames against the plain recorder's, through one envelope
    cfge = dataclasses.replace(mce.sim_config, record_stride=env.record_stride,
                               record_channels=tuple(c for c in env.channels
                                                     if c not in ("altitude", "speed")))
    sel = mce._select_lanes(np.arange(ENVELOPE_HELD))
    acc_k, acc_p = EnvelopeAccumulator(cfge, env), EnvelopeAccumulator(cfge, env)
    acc_k.add(simulate_flight_batch(*sel, cfge)[1])
    acc_p._edges = acc_k._edges
    acc_p.add(trajectory_of(fs.flight_record_reference(*prepare_batch(*sel), cfge)[1]))
    worst = 0.0
    for ch in env.channels:
        if not (np.array_equal(acc_k._n[ch], acc_p._n[ch])
                and np.array_equal(acc_k._hist[ch], acc_p._hist[ch])
                and acc_k._clipped[ch] == acc_p._clipped[ch]):
            raise AssertionError(f"10d {ch}: kernel-fed counts or histograms differ")
        for a, b in ((acc_k._mean[ch], acc_p._mean[ch]), (acc_k._m2[ch], acc_p._m2[ch])):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=f"10d {ch}")
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
    # the in-loop reduction alone, on the other half of the lanes, timed
    lo, width = acc_k._edges
    rest = mce._select_lanes(np.arange(half, ENVELOPE_LANES))
    torch.cuda.synchronize()
    t0 = time.time()
    simulate_envelope_batch(*rest, cfge, channels=env.channels, n_bins=acc_k.n_bins,
                            n_buckets=env.n_buckets, bin_dt=env.bin_dt, lo=lo, width=width,
                            hist_every=max(1, env.hist_frame_stride))
    torch.cuda.synchronize()
    in_loop = time.time() - t0
    phase("10d envelopes f64", lanes=ENVELOPE_LANES, chunk=half, frame_launches=launched_f,
          frame_wall_s=f"{wall_f:.3f}", frame_lanes_per_s=f"{ENVELOPE_LANES / wall_f:.1f}",
          inline_wall_s=f"{wall_i:.3f}", in_loop_s=f"{in_loop:.3f}",
          in_loop_lanes_per_s=f"{half / in_loop:.1f}", in_loop_equal_to_frames=True,
          kernel_fed_lanes=ENVELOPE_HELD, plain_fed_moment_rel=worst,
          plain_fed_counts_equal=True)
    rows["window"]["envelope"] = {"frame_lanes_per_s": ENVELOPE_LANES / wall_f,
                                  "in_loop_lanes_per_s": half / in_loop}
    return rows


def main() -> int:
    start = time.time()
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
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
    # every build the phases run, all compilers started at once
    builds = {name: flag_set(name)[2] for name in FLAG_SETS}
    # phase 10's recording builds
    record_builds = {"parity": fs.PARITY._replace(record=True),
                     "full_flights": flag_set("full_flights")[2]._replace(record=True)}
    t0 = time.time()
    logs = fs.build_many([fs.PARITY, *builds.values(), *record_builds.values()], verbose=True)
    build_s = time.time() - t0
    usage = ptxas_usage(logs[0][1])
    set_usage = {name: ptxas_usage(log) for name, (_, log) in zip(builds, logs[1:])}
    record_usage = {name: ptxas_usage(log)
                    for name, (_, log) in zip(record_builds, logs[1 + len(builds):])}
    phase("1 build", seconds=f"{build_s:.2f}", libraries=len({lib for lib, _ in logs}),
          ptxas=json.dumps(usage))
    for name, use in set_usage.items():
        phase(f"1 build {name}", build=fs.flags_name(builds[name]), ptxas=json.dumps(use))
    for (name, use), flags in zip(record_usage.items(), record_builds.values()):
        phase(f"1 build record {name}", build=fs.flags_name(flags), ptxas=json.dumps(use))

    # ---------------------------------------------------------------- 2
    cfg = SimConfig(max_time=WINDOW)
    for dtype, n in ((torch.float32, 1024), (torch.float64, 256)):
        # in float64, one lane with a non-finite wind table above 2 km: it
        # must diverge at the same step in both versions
        scene_b, ic_b = sample_batch(n, dtype,
                                     nan_lane=7 if dtype == torch.float64 else None)
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
        phase(f"2 digest {str(dtype).split('.')[-1]}", lanes=n, sha256=digest(got))

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
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(scene_nw, grid, wind, ics,
                                                                cfg))
    main_err = compare(ref, got, torch.float32)
    bound = fs.bound_ms(got, cfg, torch.float32, fs.input_bytes(scene_nw, grid, wind, ics))
    threads, blocks = occupancy(fs, "f32", scene_nw, grid)
    f32 = usage["f32"]
    costs = {"bound_ms": bound.ms, "bound_by": bound.by, "lane_steps": bound.lane_steps,
             "share_of_bound": bound.ms / kernel_ms, "regs": f32["regs"],
             "spill_bytes": f32["spill_stores"] + f32["spill_loads"],
             "warps_per_sm": blocks * threads // 32}
    phase("4 kernel vs plain", lanes=BENCH_LANES, max_abs_err=main_err,
          rtol=RTOL[torch.float32], atol=ATOL, kernel_ms=f"{kernel_ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", speedup=f"{plain_ms / kernel_ms:.1f}", **costs)
    phase("4 digest f32", lanes=BENCH_LANES, sha256=digest(got))

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
    # the kernel's own outputs for full flights, for the digest
    scene_b, ic_b = sample_batch(FULL_FLIGHT_LANES, torch.float32)
    phase("5 digest f32", lanes=FULL_FLIGHT_LANES,
          sha256=digest(fs.flight_summary(*prepare_batch(scene_b, ic_b), SimConfig())))

    # ---------------------------------------------------------------- 6
    def timed_row(name, dt, t):
        use = set_usage[name][dt]
        row = {k: t[k] for k in ("lanes", "ms", "bound_ms", "bound_by", "share_of_bound",
                                 "warps_per_sm", "digest")}
        row.update(regs=use["regs"], spill_bytes=use["spill_stores"] + use["spill_loads"])
        phase(f"6 timed {name} {dt}", **row)
        return row

    rows = {name: {"build": fs.flags_name(flags)} for name, flags in builds.items()}
    for name in FLAG_SETS:
        row = rows[name]
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).split(".")[-1]
            cfg6, stall, flags = flag_set(name, max_time=WINDOW)
            nan_lane = 7 if name == "terminate_nonfinite" else None
            scene_b, ic_b = sample_batch(FLAG_LANES[dtype], dtype, nan_lane=nan_lane)
            if stall:  # 4x the wind: lanes leave the rail past the stall angle
                scene_b = with_stall(dataclasses.replace(scene_b, wind=dataclasses.replace(
                    scene_b.wind, wind=scene_b.wind.wind * 4.0)))
            cases = [("window", scene_b, ic_b, cfg6)]
            if name in TO_LANDING:
                cases.append(("to landing", *low_apogee_batch(dev, dtype), flag_set(name)[0]))
            for what, sb, ib, c in cases:
                args, got, launched = drive(sb, ib, c)
                check_flag_run(name, what, got, nan_lane)
                ref, got_n, p_ms = plain_on_head(args, got, c)
                ties = torch.zeros_like(got_n["diverged"], dtype=torch.bool)
                if name == "speed_guard":
                    ties = guard_ties(ref, got_n, c.speed_guard, dtype)
                    if int(ties.sum()) > 1e-3 * ties.numel():
                        raise AssertionError(f"speed guard: {int(ties.sum())} lanes stop a "
                                             "step apart")
                kept = ~ties
                err = compare({k: v[kept] for k, v in ref.items()},
                              {k: v[kept] for k, v in got_n.items()}, dtype)
                compared = int(kept.sum())
                del ref
                phase(f"6 kernel=plain {name} {dt} {what}", build=row["build"],
                      lanes=int(got["n_steps"].numel()), compared_lanes=compared,
                      guard_ties=int(ties.sum()), max_time=c.max_time, launches=launched,
                      max_abs_err=err, plain_ms=f"{p_ms:.1f}",
                      n_steps_max=int(got["n_steps"].max()),
                      diverged=int(got["diverged"].sum()))
                phase(f"6 digest {name} {dt} {what}", sha256=digest(got))
                if what == "window" and dtype == torch.float32:
                    # timed on the inputs whose outputs were just compared
                    row.update(launches=launched, max_abs_err=err,
                               max_abs_err_lanes=compared, plain_ms=p_ms,
                               f32=timed_row(name, "f32", time_kernel(
                                   fs, args, c, dtype, reps=2, flags=flags)))
                del args, got, got_n
            del scene_b, ic_b, cases
            torch.cuda.empty_cache()
    # float64 timed at B=65,536
    scene_b, ic_b = sample_batch(F64_TIMED_LANES, torch.float64)
    for name in FLAG_SETS:
        cfg6, stall, flags = flag_set(name, max_time=WINDOW)
        rows[name]["f64"] = timed_row(name, "f64", time_kernel(
            fs, prepare_batch(with_stall(scene_b, stall), ic_b), cfg6, torch.float64, reps=2,
            flags=flags))
    del scene_b, ic_b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions

    medians = {}
    for name in ("full_flights", "energy_consistent_aero"):
        cfg7, _, flags = flag_set(name)
        mc7 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg7)
        mc7.run_monte_carlo(ic, n_samples=1024, seed=0)  # warm-up
        torch.cuda.synchronize()
        fs.launches = 0
        t0 = time.time()
        a7 = mc7.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
        wall7 = time.time() - t0
        launched = fs.launches
        if launched < 1:
            raise AssertionError(f"full flights ({name}) did not launch the kernel")
        medians[name] = float(np.median(a7["summary"].n_steps))
        # the run's own lanes, drawn as run_monte_carlo draws them
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        args = prepare_batch(*sample_dispersions(
            gen, mc7.scene, ic, mc7.uncertainty_params, BENCH_LANES,
            wind_grid_points=mc7.wind_grid_points, wind_grid_top=mc7.wind_grid_top)[:2])
        got = fs.flight_summary(*args, cfg7)
        for k in ("n_steps", "apogee_altitude", "flight_time"):
            if not np.array_equal(got[k].cpu().numpy(), getattr(a7["summary"], k),
                                  equal_nan=True):
                raise AssertionError(f"full flights ({name}): {k} is not the run's")
        t = time_kernel(fs, args, cfg7, torch.float32, reps=1, flags=flags)
        stats = {"lanes": BENCH_LANES, "launches": launched, "wall_s": wall7,
                 "n_outliers": a7["n_outliers"], "apogee_mean": a7["apogee_altitude"]["mean"],
                 "median_n_steps": medians[name], "kernel_ms": t["ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "share_of_bound": t["share_of_bound"]}
        if name == "full_flights":  # the run's first lanes against the plain version
            stats.update(full_flights_against_plain(args, got, cfg7, BENCH_LANES))
        del args, got
        torch.cuda.empty_cache()
        rows[name]["full_flights_f32"] = stats
        phase(f"7 full flights {name}", build=rows[name]["build"], **stats)
    tiered = rows["full_flights"]["full_flights_f32"]
    ratio = medians["energy_consistent_aero"] / medians["full_flights"]
    if tiered["n_outliers"] > 0.01 * BENCH_LANES or not ratio > 2.5:
        raise AssertionError(f"stabilized full flights: {tiered['n_outliers']} outliers "
                             f"(at most 1% allowed), median steps {ratio:.2f}x fewer tiered "
                             "(more than 2.5x required)")
    phase("7 tiered against fine", median_steps_ratio=ratio,
          outlier_share=tiered["n_outliers"] / BENCH_LANES)

    # ---------------------------------------------------------------- 8
    certificates(dev)

    # ---------------------------------------------------------------- 9
    large_launches = large_runs(dev, ic)

    # ---------------------------------------------------------------- 10
    t0 = time.time()
    record_rows = recordings(dev, ic, mc, analysis, record_usage, record_builds)
    phase("10 done", phase_10_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}")

    report = {"kernels": [
        {"name": f"flight_summary ({name})", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": where, "launches": launches, "max_abs_err": main_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
         "large_run_launches": large_launches, **costs}
        for name, where in REPLACES
    ] + [
        {"name": f"flight_summary [{name}]", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[0][1], "launches": row["launches"],
         "max_abs_err": row["max_abs_err"], "ms": row["f32"]["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["f32"]["bound_ms"],
         "bound_by": row["f32"]["bound_by"], "library_ms": None, **row}
        for name, row in rows.items()
    ] + [
        {"name": f"flight_summary [record {name}]", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[0][1], "library_ms": None, **row}
        for name, row in record_rows.items()
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
