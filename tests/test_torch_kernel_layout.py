"""PyTorch port, the whole-flight kernel's layout and table rules, on the CPU.

What the wrapper ``kernels/flight_summary.py`` hands the CUDA kernel
(``csrc/flight_summary.cu``): the lane-minor wind table and the table flags
that choose the kernel's paths. The rules behind the kernel's shortcuts,
checked in NumPy with the expressions of ``ops/interp.py``: where a table is
window-exact, the four knots around the query's segment give the full tent
sum bit for bit, and each knot's weight needs one division where the kernel
takes one. And the bound the kernel's time is held against, and the
recording build's frames: their layout, the wrapper's fill after each
lane's stop frame and its room check. This file imports no JAX.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.ops import prng

torch.set_num_threads(1)

WINDOW = SimConfig(max_time=6.0)


def cpu_batch(n, dtype=torch.float64):
    scene_b, ic_b, _ = sample_dispersions(
        prng.prng_key(0), nominal_scene(liquid_motor("cpu", dtype)),
        InitialConditions.vertical_launch("cpu", dtype), n=n)
    return prepare_batch(scene_b, ic_b)


def replace_leaf(scene_nw, part, **fields):
    return dataclasses.replace(
        scene_nw, **{part: dataclasses.replace(getattr(scene_nw, part), **fields)})


def test_per_lane_wind_is_passed_lane_minor():
    """A per-lane [B, N, 3] table reaches the kernel as a contiguous
    [N, 3, B] copy with lane stride 1, so that neighbouring threads read
    neighbouring addresses; the caller's table is not changed."""
    scene_nw, grid, wind, ics = cpu_batch(5)
    n_wind = grid.numel()
    a = fs._kernel_args(scene_nw, grid, wind, ics, WINDOW)
    assert wind.shape == (5, n_wind, 3)
    assert a.wind.shape == (n_wind, 3, 5) and a.wind.is_contiguous()
    assert a.wind.stride() == (15, 5, 1) and a.wind_lane_stride == 1
    assert torch.equal(a.wind, wind.permute(1, 2, 0))
    assert a.table_ptrs[8] == a.wind.data_ptr() != wind.data_ptr()
    assert a.table_ptrs[9] == a.flags.data_ptr()


def test_shared_wind_is_passed_as_is():
    scene_nw, grid, wind, ics = cpu_batch(5)
    shared = wind[0].contiguous()
    a = fs._kernel_args(scene_nw, grid, shared, ics, WINDOW)
    assert a.wind.shape == (grid.numel(), 3) and a.wind_lane_stride == 0
    assert a.table_ptrs[8] == shared.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_table_flags_nominal(dtype):
    """The nominal Mach, CP and thrust tables and the synthesized wind grid
    take the window and the direct-index wind search."""
    scene_nw, grid, wind, ics = cpu_batch(4, dtype)
    flags = fs._kernel_args(scene_nw, grid, wind, ics, WINDOW).flags
    assert flags.dtype == torch.int32 and flags.tolist() == [1, 1, 1, 1, 1]


@pytest.mark.parametrize("case,expect", [
    ("nan_cd0", [0, 1, 1, 1, 1]),
    ("inf_mach", [0, 1, 1, 1, 1]),
    ("unsorted_mach", [0, 1, 1, 1, 1]),
    ("repeated_cp_knot", [1, 0, 1, 1, 1]),
    ("nan_thrust", [1, 1, 0, 1, 1]),
    ("unsorted_grid", [1, 1, 1, 0, 1]),
    ("nan_grid", [1, 1, 1, 0, 0]),
])
def test_table_flags_refuse_the_window(case, expect):
    """A non-finite table, or knots that do not strictly increase, keep the
    kernel's full-knot sum; a wind grid that decreases somewhere keeps its
    binary search, a non-finite one the full sum for every component."""
    scene_nw, grid, wind, ics = cpu_batch(4)
    r, m = scene_nw.rocket, scene_nw.motor
    if case == "nan_cd0":
        t = r.cd0_table.clone(); t[3] = float("nan")
        scene_nw = replace_leaf(scene_nw, "rocket", cd0_table=t)
    elif case == "inf_mach":
        t = r.cd_mach.clone(); t[-1] = float("inf")
        scene_nw = replace_leaf(scene_nw, "rocket", cd_mach=t)
    elif case == "unsorted_mach":
        t = r.cd_mach.clone(); t[[2, 3]] = t[[3, 2]]
        scene_nw = replace_leaf(scene_nw, "rocket", cd_mach=t)
    elif case == "repeated_cp_knot":
        t = r.cp_shift_mach.clone(); t[2] = t[1]
        scene_nw = replace_leaf(scene_nw, "rocket", cp_shift_mach=t)
    elif case == "nan_thrust":
        t = m.curve_thrust_sl.clone(); t[0] = float("nan")
        scene_nw = replace_leaf(scene_nw, "motor", curve_thrust_sl=t)
    elif case == "unsorted_grid":
        grid = grid.clone(); grid[[10, 11]] = grid[[11, 10]]
    else:
        grid = grid.clone(); grid[50] = float("nan")
    flags = fs._kernel_args(scene_nw, grid, wind, ics, WINDOW).flags
    assert flags.tolist() == expect


def test_grid_flag_refuses_gaps_that_overflow():
    """A finite, increasing grid whose gap overflows has an infinite support:
    the wind keeps its binary search and two-division weights (flag 3), but
    the grid is finite (flag 4)."""
    scene_nw, grid, wind, ics = cpu_batch(2)
    tables = [getattr(getattr(scene_nw, p), f) for p, f in fs._TABLES]
    wide = torch.tensor([-1e308, 1e308], dtype=torch.float64)
    assert fs._table_flags(tables, wide).tolist() == [1, 1, 1, 0, 1]


# ------------------------------------------------ the flag sets
FLAG_CONFIGS = {
    "parity": {},
    "rk2": dict(integrator="rk2"),
    "wind_per_step": dict(wind_eval_per_step=True),
    "bf16": dict(wind_table_bf16=True),
    "energy": dict(energy_consistent_aero=True),
    "speed_guard": dict(speed_guard=60.0),
    "no_terminate": dict(terminate_nonfinite=False, speed_guard=60.0),
    "tiered": dict(descent_dt_scale=16),
    "full_flights": dict(energy_consistent_aero=True, descent_dt_scale=16,
                         ascent_q_threshold=8000.0, descent_settle_time=1.5),
}


@pytest.mark.parametrize("name", list(FLAG_CONFIGS))
def test_cfg_values_per_flag_set(name):
    """The kernel's Cfg numbers in float64: the fine step, its half and
    sixth, then after the event numbers the speed guard, the coarse step
    dt * descent_dt_scale with its half and sixth, the settle time and the
    ascent threshold; the build follows the flags."""
    cfg = dataclasses.replace(WINDOW, **FLAG_CONFIGS[name])
    scene_nw, grid, wind, ics = cpu_batch(3)
    a = fs._kernel_args(scene_nw, grid, wind, ics, cfg)
    big = cfg.dt * cfg.descent_dt_scale
    assert a.cfg_vals[:3] == [cfg.dt, 0.5 * cfg.dt, cfg.dt / 6.0]
    assert a.cfg_vals[16:] == [cfg.speed_guard, big, 0.5 * big, big / 6.0,
                               cfg.descent_settle_time, cfg.ascent_q_threshold]
    assert len(a.cfg_vals) == 22 and a.build == fs.kernel_flags(cfg)
    assert (a.build == fs.PARITY) == (name == "parity")
    if name == "no_terminate":  # the guard acts only through the non-finite stop
        assert not a.build.speed_guard and not a.build.terminate_nonfinite


def test_each_flag_set_is_its_own_build():
    """Every flag set names its own library (the source hash, the flags and
    the defines), and stall_limited_moments, a rocket field, is one more."""
    with open(fs.SOURCE, "rb") as f:
        src = f.read()
    sets = {fs.kernel_flags(dataclasses.replace(WINDOW, **c)) for c in FLAG_CONFIGS.values()}
    sets.add(fs.kernel_flags(WINDOW, stall_limited_moments=True))
    paths = {fs._library(flags, src)[0] for flags in sets}
    assert len(paths) == len(sets) == len(FLAG_CONFIGS) + 1
    parity, defines = fs._library(fs.PARITY, src)
    assert defines == ["-DFS_RK2=0", "-DFS_WIND_PER_STEP=0", "-DFS_ENERGY_AERO=0",
                       "-DFS_STALL_MOMENTS=0", "-DFS_TIERED=0", "-DFS_ASCENT_GATE=0",
                       "-DFS_TERMINATE_NONFINITE=1", "-DFS_SPEED_GUARD=0", "-DFS_WIND_BF16=0",
                       "-DFS_RECORD=0"]
    assert fs._library(fs.PARITY, src + b" ")[0] != parity


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
def test_bf16_table_is_passed_rounded(shared):
    """Under wind_table_bf16 the kernel reads the table rounded to
    bfloat16, lane-minor when per lane; the plain version reads the same
    values, widened."""
    scene_nw, grid, wind, ics = cpu_batch(5, torch.float32)
    if shared:
        wind = wind[0].contiguous()
    cfg = dataclasses.replace(WINDOW, wind_table_bf16=True)
    a = fs._kernel_args(scene_nw, grid, wind, ics, cfg)
    want = wind.to(torch.bfloat16)
    assert a.wind.dtype == torch.bfloat16 and a.build.wind_bf16
    assert torch.equal(a.wind, want if shared else want.permute(1, 2, 0))
    assert a.wind_lane_stride == (0 if shared else 1) and a.wind.is_contiguous()
    assert torch.equal(fs.stored_wind(wind, cfg).to(torch.float32), want.to(torch.float32))
    assert fs.input_bytes(scene_nw, grid, wind, ics, cfg) == (
        fs.input_bytes(scene_nw, grid, wind, ics) - 2 * wind.numel())


def test_ops_per_step_per_flag_set():
    """The bound's operations of one step per build: rk2 evaluates the
    dynamics twice, one wind lookup a step leaves the four evaluations, the
    energy-consistent force costs 31 in place of 17, the tiered step adds
    the gate it evaluates on every lane; the ascent gate, which runs only
    on quiet coasting steps, adds nothing."""
    dyn, wind = 353, 34
    assert fs.ops_per_step(fs.PARITY) == fs.OPS_PER_STEP == 4 * dyn + 207
    assert fs.ops_per_step(fs.KernelFlags(rk2=True)) == 2 * dyn + 80
    assert fs.ops_per_step(fs.KernelFlags(wind_per_step=True)) == 4 * (dyn - wind) + 207 + wind
    assert fs.ops_per_step(fs.KernelFlags(energy_aero=True)) == 4 * (dyn + 14) + 207
    full = fs.KernelFlags(energy_aero=True, tiered=True, ascent_gate=True)
    assert fs.ops_per_step(full) == fs.ops_per_step(full._replace(ascent_gate=False))
    assert fs.ops_per_step(full) == 4 * (dyn + 14) + 207 + 3
    assert fs.ops_per_step(full._replace(rk2=True)) == 2 * (dyn + 14) + 80 + 3


# ------------------------------------------------ the window rule, in NumPy
def nmax(a, b):
    return np.maximum(a, b)  # NaN-propagating, as jnp.maximum


def nmin(a, b):
    return np.minimum(a, b)


def tent_terms(x, y, xc):
    """ops/interp.py's tent weight of every knot at the clamped query,
    times the knot's value, in knot order."""
    k = x.shape[0]
    one, floor = x.dtype.type(1), x.dtype.type(1e-30)
    terms = []
    for j in range(k):
        left = one if j == 0 else nmax(x[j] - x[j - 1], floor)
        right = one if j == k - 1 else nmax(x[j + 1] - x[j], floor)
        up = (xc - (x[j] - left)) / left
        down = ((x[j] + right) - xc) / right
        w = nmin(nmax(nmin(up, down), x.dtype.type(0)), one)
        terms.append(w * y[j])
    return terms


def full_and_window(x, y, q):
    """The full sum, left to right from +0, and the kernel's sum over knots
    i-1..i+2, i the largest index <= K-2 with x_i <= xc."""
    xc = nmin(nmax(q, x[0]), x[-1])
    terms = tent_terms(x, y, xc)
    k = x.shape[0]
    i = sum(1 for j in range(1, k - 1) if x[j] <= xc)
    full = win = x.dtype.type(0)
    for j, t in enumerate(terms):
        full = full + t
        if max(i - 1, 0) <= j <= min(i + 2, k - 1):
            win = win + t
    return full, win


def queries(x):
    """Every knot, its neighbours an ulp away, midpoints, both ends and
    beyond them."""
    dt = x.dtype.type
    qs = list(x)
    qs += [np.nextafter(v, dt(np.inf)) for v in x] + [np.nextafter(v, dt(-np.inf)) for v in x]
    qs += list((x[:-1] + x[1:]) / dt(2))
    qs += [x[0] - dt(1), x[-1] + dt(1), dt(-np.inf), dt(np.inf), dt(0), dt(-0.0)]
    return [dt(q) for q in qs]


def same_bits(a, b):
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_window_sum_is_the_full_sum(dtype, seed):
    """Random strictly increasing tables of 2-12 knots, values of both signs
    and zeros: the flag accepts them, and at every query the window sum has
    the full sum's bits."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        k = int(rng.integers(2, 13))
        gaps = rng.exponential(1.0, k) * 10.0 ** rng.uniform(-3, 3)
        x = np.cumsum(gaps).astype(dtype) + dtype(rng.normal() * 5)
        x = np.unique(x)
        if x.shape[0] < 2:
            continue
        y = rng.normal(size=x.shape[0]).astype(dtype)
        y[rng.random(x.shape[0]) < 0.2] = 0
        y[rng.random(x.shape[0]) < 0.1] = dtype(-0.0)
        assert bool(fs._window_exact(torch.from_numpy(x), torch.from_numpy(y)))
        for q in queries(x):
            full, win = full_and_window(x, y, q)
            assert same_bits(full, win), (x, y, q, full, win)


def one_division_weight(nu, nd, left, right):
    """The kernel's window_weight: the tent weight from its numerators
    ``nu = xc - lo`` and ``nd = hi - xc``, dividing only where needed."""
    zero, one = left.dtype.type(0), left.dtype.type(1)
    if nu <= zero or nd <= zero:
        return zero
    if nu >= left:
        return nmin(nmax(nd / right, zero), one)
    if nd >= right:
        return nmin(nmax(nu / left, zero), one)
    return nmin(nmax(nmin(nu / left, nd / right), zero), one)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_one_division_weight_is_the_tent_weight(dtype):
    """On finite supports with left, right > 0 (repeated knots give the
    1e-30 floor), the kernel's window weight has the tent weight's bits at
    every knot and query, a NaN query included."""
    rng = np.random.default_rng(7)
    dt = dtype
    with np.errstate(all="ignore"):
        for _ in range(40):
            k = int(rng.integers(2, 10))
            x = np.sort(rng.normal(size=k) * 10.0 ** rng.uniform(-2, 4)).astype(dt)
            if rng.random() < 0.3:
                x[int(rng.integers(1, k))] = x[0] if k == 2 else x[1]
                x = np.sort(x)
            floor = dt(1e-30)
            qs = queries(x) + [dt(np.nan)]
            for j in range(k):
                left = dt(1) if j == 0 else nmax(x[j] - x[j - 1], floor)
                right = dt(1) if j == k - 1 else nmax(x[j + 1] - x[j], floor)
                lo, hi = x[j] - left, x[j] + right
                for q in qs:
                    xc = nmin(nmax(q, x[0]), x[-1])
                    up, down = (xc - lo) / left, (hi - xc) / right
                    want = nmin(nmax(nmin(up, down), dt(0)), dt(1))
                    got = one_division_weight(xc - lo, hi - xc, left, right)
                    assert same_bits(dt(want), dt(got)) or (np.isnan(want) and np.isnan(got))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_sum_of_a_nan_query_is_nan(dtype):
    x = np.array([0.0, 0.5, 1.0, 2.0, 5.0, 9.0], dtype)
    y = np.array([1.0, -2.0, 3.0, 0.0, 4.0, 5.0], dtype)
    full, win = full_and_window(x, y, dtype(np.nan))
    assert np.isnan(full) and np.isnan(win)


def test_window_flag_rejects_what_the_window_gets_wrong():
    """Knots whose support, as rounded, reaches past the window: the segment
    [-1, 0.25) sees the far knot at 1e8, whose lo = 1e8 - (1e8 - 1) rounds
    to 0 in float32. The window sum misses that knot's weight, so the flag
    must send this table to the full sum."""
    x = np.array([-2.0, -1.0, 0.25, 1.0, 1e8], np.float32)
    y = np.array([1.0, 2.0, 3.0, 4.0, 1e9], np.float32)
    full, win = full_and_window(x, y, np.float32(0.125))
    assert not same_bits(full, win)
    assert not bool(fs._window_exact(torch.from_numpy(x), torch.from_numpy(y)))


# ------------------------------------------------------------------ the bound
def test_bound_by_hand():
    """Two lanes with 100 and 40 RK4 steps after 80 and 87 rail steps (in
    float32 the rail exit time 0.87 is 0.8700000047683716), the H100 rates
    of 67 and 34 TFLOP/s and 3.35 TB/s."""
    # a table lookup as window_weight evaluates it: clamp 2, three knots'
    # numerators 6, the segment's two knots' division and clip 6
    window = 2 + 3 * 2 + 2 * 3
    assert fs.DYNAMICS_OPS["wind: window 14, segment guess 2, 3 components x 3 knots "
                           "x (*, +) 18"] == window + 2 + 3 * 3 * 2 == 34
    assert sum(fs.DYNAMICS_OPS.values()) == 353
    assert fs.OPS_PER_STEP == 4 * 353 + 207 == 1619
    assert fs.OPS_PER_RAIL_STEP == 156
    for dtype, flops in ((torch.float32, 67e12), (torch.float64, 34e12)):
        out = {"n_steps": torch.tensor([100, 40], dtype=torch.int32),
               "rail_exit_time": torch.tensor([0.80, 0.87], dtype=dtype),
               "apogee_altitude": torch.zeros(2, dtype=dtype)}
        out_bytes = 2 * 4 + 2 * (4 if dtype == torch.float32 else 8) * 2
        b = fs.bound_ms(out, SimConfig(), dtype, in_bytes=1000)
        ops = 140 * 1619 + 167 * 156
        assert b.lane_steps == 140 + 167 and b.ops == ops
        assert b.bytes == 1000 + out_bytes
        assert b.by == "operations"
        assert b.ms == pytest.approx(ops / flops * 1e3, rel=1e-12)
    # with no steps, the bytes bound it
    out = {"n_steps": torch.zeros(1, dtype=torch.int32),
           "rail_exit_time": torch.zeros(1, dtype=torch.float32)}
    b = fs.bound_ms(out, SimConfig(), torch.float32, in_bytes=3350)
    assert b.by == "bytes" and b.ms == pytest.approx(3358 / 3.35e12 * 1e3)


def test_input_bytes_counts_each_input_once():
    scene_nw, grid, wind, ics = cpu_batch(6, torch.float32)
    n_wind = grid.numel()
    leaves = [getattr(getattr(scene_nw, p), f) for p, f in fs._SCENE_LEAVES + fs._TABLES]
    expect = 4 * (sum(t.numel() for t in leaves) + n_wind + 6 * n_wind * 3 + 12 * 6)
    assert fs.input_bytes(scene_nw, grid, wind, ics) == expect


# ------------------------------------------------------- the recording build
def test_record_layout_and_build():
    """A recording's frames: the rail-exit frame and one every
    record_stride steps, the time, the 14 state values and the derived
    channels asked for (their mask bits in DERIVED_KEYS order); the
    recording build of a flag set is that set with ``record``, its own
    library, named by its own C entry."""
    lay = fs.record_layout(SimConfig(max_time=6.0, record_stride=4))
    assert lay.n_frames == 1 + 300 and lay.stride == 4
    assert lay.names == fs.DERIVED_KEYS and lay.n_channels == 15 + 20
    assert lay.mask == (1 << 20) - 1
    sub = fs.record_layout(SimConfig(record_channels=("mach", "euler_angles")))
    assert sub.names == ("euler_roll", "euler_pitch", "euler_yaw", "mach")
    assert sub.mask == 0b111 << 5 | 1 << 19 and sub.n_channels == 19
    assert sub.n_frames == 60_001
    bare = fs.record_layout(SimConfig(record_derived=False, record_stride=7))
    assert bare.mask == 0 and bare.n_channels == 15 and bare.n_frames == 1 + 8572
    full = SimConfig(energy_consistent_aero=True, descent_dt_scale=16)
    rec = fs.kernel_flags(full, record=True)
    assert rec == fs.kernel_flags(full)._replace(record=True)
    assert fs.flags_name(rec) == "energy_aero+tiered+record"
    assert fs.entry_name(rec, "f32") == "flight_record_f32"
    assert fs.entry_name(fs.PARITY, "f64") == "flight_summary_f64"
    with open(fs.SOURCE, "rb") as f:
        src = f.read()
    path, defines = fs._library(fs.PARITY._replace(record=True), src)
    assert defines[-1] == "-DFS_RECORD=1" and path != fs._library(fs.PARITY, src)[0]
    a = fs._kernel_args(*cpu_batch(3), WINDOW, record=True)
    assert a.build == fs.PARITY._replace(record=True)


def test_unpack_frames_fills_after_each_stop():
    """The wrapper's one gather: a lane's frames after its stop frame are
    that frame, ``valid`` is frame <= stop, the channels split into the
    time, the state and the derived channels."""
    lay = fs.record_layout(SimConfig(max_time=0.05, record_channels=("mach",)))
    assert lay.n_frames == 11 and lay.n_channels == 16
    frames = torch.arange(11 * 16 * 3, dtype=torch.float64).reshape(11, 16, 3)
    stop = torch.tensor([0, 4, 10], dtype=torch.int32)
    recs = fs.unpack_frames(frames, stop, lay)
    assert set(recs) == set(fs.FRAME_KEYS) | {"valid", "derived"}
    assert set(recs["derived"]) == {"mach"}
    for lane, s in enumerate(stop.tolist()):
        want = frames[torch.clamp(torch.arange(11), max=s), :, lane]
        got = torch.stack([recs[k][:, lane] for k in fs.FRAME_KEYS]
                          + [recs["derived"]["mach"][:, lane]], dim=1)
        assert torch.equal(got, want)
        assert recs["valid"][:, lane].tolist() == [f <= s for f in range(11)]


def test_record_room_check_raises_with_the_numbers(monkeypatch):
    """The wrapper never truncates a recording: it raises, with the bytes
    needed and free, before it allocates."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (2**30, 2**34))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 2**29)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    lay = fs.record_layout(SimConfig())  # 60,001 frames of 35 channels
    fs._check_room(lay, 64, torch.float32, "cuda")  # 1.0 GiB of 1.5 GiB
    with pytest.raises(RuntimeError, match=r"needs 2\.0\d GiB on cuda, 1\.50 GiB are free"):
        fs._check_room(lay, 128, torch.float32, "cuda")


def test_bound_counts_recorded_frames():
    """A recording adds, per frame up to each lane's stop, the derived
    channels' operations (when any is recorded), and its frames' bytes."""
    assert fs.OPS_PER_FRAME == sum(fs.DERIVED_OPS.values()) == 282
    out = {"n_steps": torch.tensor([100, 40], dtype=torch.int32),
           "rail_exit_time": torch.tensor([0.80, 0.87], dtype=torch.float64)}
    base = fs.bound_ms(out, SimConfig(), torch.float64, in_bytes=1000)
    valid = torch.zeros(60, 2, dtype=torch.bool)
    valid[:51, 0], valid[:21, 1] = True, True
    frames = {k: torch.zeros(60, 2, dtype=torch.float64) for k in fs.FRAME_KEYS}
    recs = {**frames, "valid": valid,
            "derived": {"mach": torch.zeros(60, 2, dtype=torch.float64)}}
    b = fs.bound_ms(out, SimConfig(), torch.float64, 1000, recs)
    assert b.ops == base.ops + 72 * 282
    assert b.bytes == base.bytes + 16 * 60 * 2 * 8 + 60 * 2
    bare = fs.bound_ms(out, SimConfig(), torch.float64, 1000, {**recs, "derived": {}})
    assert bare.ops == base.ops


# ---------------------------------------------- the carry and fold builds
def test_carry_and_fold_builds():
    """The stacked engine's speed (``stacked_speed``) and the carry build
    (``carry``) are builds of their own, named by defines the other builds
    do not carry (their libraries keep their names); the carry build's
    entry is ``flight_chunk_*`` and takes five more arguments; a recording
    carry build is refused before any compiler starts."""
    with open(fs.SOURCE, "rb") as f:
        src = f.read()
    parity, defines = fs._library(fs.PARITY, src)
    assert not any("SAFE_NORM" in d or "CARRY" in d for d in defines)
    carry = fs.kernel_flags(WINDOW, stacked_speed=True, carry=True)
    assert carry == fs.PARITY._replace(stacked_speed=True, carry=True)
    path, carry_defines = fs._library(carry, src)
    assert carry_defines == defines + ["-DFS_SAFE_NORM_SPEED=1", "-DFS_CARRY=1"]
    assert len({parity, path, fs._library(carry._replace(carry=False), src)[0]}) == 3
    assert fs.flags_name(carry) == "stacked_speed+carry"
    text = src.decode()
    carry_f = re.search(r"enum CarryF \{(.*?)\};", text, re.S).group(1)
    carry_i = re.search(r"enum CarryI \{(.*?)\};", text, re.S).group(1)
    assert "C_APO_T = C_S + N_STATE" in carry_f
    # the state's 14 values from C_S, then one value each after C_S's two names
    assert fs.N_CARRY_F == 14 + len(re.findall(r"\bC_\w+", carry_f)) - 2
    assert fs.N_CARRY_I == len(re.findall(r"\bC_\w+", carry_i))
    assert fs.entry_name(carry, "f32") == "flight_chunk_f32"
    assert fs.entry_name(carry._replace(carry=False), "f64") == "flight_summary_f64"
    with pytest.raises(ValueError, match="carry excludes record"):
        fs.build_many([carry._replace(record=True)])
    a = fs._kernel_args(*cpu_batch(3), WINDOW, stacked_speed=True, carry=True)
    assert a.build == carry
    carry_f = torch.zeros((fs.N_CARRY_F, 3))
    carry_i = torch.zeros((fs.N_CARRY_I, 3), dtype=torch.int32)
    active = torch.zeros(4, dtype=torch.int32)
    out = torch.zeros(1)
    args = fs.entry_args(a, WINDOW, out, out, None, chunk=(carry_f, carry_i, active[2:3], True,
                                                           256))
    assert len(args) == 14 + 5 and args[-2:] == [1, 256]
    assert args[-3].value == active.data_ptr() + 2 * 4
    with pytest.raises(ValueError, match="positive integer"):
        fs.flight_summary_chunked(*cpu_batch(3), WINDOW, 0)


def test_run_chunks_stops_when_no_lane_runs():
    """The host's chunk loop: a launch a chunk, a progress call after each,
    until a chunk leaves its flag 0 or the bound is reached."""
    for still_active, want in ((2, 3), (9, 5)):
        active = torch.zeros(5, dtype=torch.int32)
        launched, calls = [], []

        def launch(k):
            launched.append(k)
            active[k] = int(k < still_active)

        assert fs.run_chunks(launch, active, lambda k, n: calls.append((k, n))) == want
        assert launched == list(range(want)) and calls == [(k, 5) for k in range(1, want + 1)]
    assert fs.max_chunks(SimConfig(), 8192) == 9 and fs.max_chunks(WINDOW, 256) == 6


def test_bound_counts_the_carry():
    """A chunked run adds each lane's carry, written once a chunk it runs
    and read once a chunk but its first: a lane of 100 steps in chunks of
    30 runs 4 chunks, one of 40 steps 2, one that stops at once 1."""
    out = {"n_steps": torch.tensor([100, 40, 0], dtype=torch.int32),
           "rail_exit_time": torch.tensor([0.80, 0.87, 0.5], dtype=torch.float32)}
    assert fs.carry_runs(out["n_steps"], 30).tolist() == [4, 2, 1]
    base = fs.bound_ms(out, SimConfig(), torch.float32, in_bytes=1000)
    b = fs.bound_ms(out, SimConfig(), torch.float32, 1000, chunk_steps=30)
    assert b.ops == base.ops
    assert b.bytes == base.bytes + (7 + 3 + 1) * (23 * 4 + 5 * 4)


def test_rail_exit_ties_need_float64_evidence():
    """chip_smoke's ``rail_ties``: lane 15,106 of ``PRNGKey(0)``'s float32
    lanes under ``wind_table_bf16`` leaves the rail at 0.85 s in the plain
    version and at 0.84 s on the card. Flown in float64, a rail length
    moved by the float32 bar puts it on either step: a tie, excused. A lane
    a step apart that float64 does not put on both steps raises."""
    import chip_smoke

    lane = 15_106
    scene = nominal_scene(liquid_motor("cpu", torch.float32))
    ic = InitialConditions.vertical_launch("cpu", torch.float32)
    scene_b, ic_b, _ = sample_dispersions(prng.prng_key(0), scene, ic, n=lane + 1)
    args = prepare_batch(scene_b, ic_b)
    n = args[3][0].shape[0]
    args = chip_smoke.map_tensors(  # four lanes: no shared leaf is four long
        lambda t: t[lane - 3:].contiguous() if t.ndim >= 1 and t.shape[0] == n else t, args)
    cfg = SimConfig(max_time=1.0, wind_table_bf16=True)
    ref = fs.flight_summary_reference(*args, cfg)
    assert float(ref["rail_exit_time"][3]) == pytest.approx(0.85)
    got = {k: v.clone() for k, v in ref.items()}
    got["rail_exit_time"][3] = 0.84  # the card's exit
    ties = chip_smoke.rail_ties(args, ref, got, cfg, torch.float32)
    assert ties.tolist() == [False, False, False, True]
    got["rail_exit_time"][0] += 0.01  # a lane float64 puts on its step alone
    with pytest.raises(AssertionError, match="no tie"):
        chip_smoke.rail_ties(args, ref, got, cfg, torch.float32)


def test_apogee_ties_are_one_step_apart():
    """chip_smoke's ``apogee_ties``: on a landing tie, an apogee time at
    most a coarse step apart is excused only where the plain version in
    float64 admits it as its apex. ``PRNGKey(0)``'s first seven dispersed
    lanes with 10 kg of propellant, with a 0.08 s step and coarse steps of
    0.16 s, the coast turning coarse at lane 0's own dynamic pressure on its
    93rd step (7877.98 Pa in float64). Lane 0 peaks 19.28 s after rail exit
    in float32 and in float64 with the threshold moved up by the float32
    bar (the coast turns coarse a step earlier), and at 19.20 s in float64:
    both are ties. Lane 4 peaks at 18.24 s, 18.3 mm above the step after and
    233 mm above the step before, against a bar of 33.5 mm: 18.40 s is a
    tie, 18.08 s raises, and three steps away is off the bars."""
    import chip_smoke
    from erpl_monte_carlo_sim_tpu_torch.kernels.measure import FULL_FLIGHTS
    from erpl_monte_carlo_sim_tpu_torch.models import RocketParams

    f32 = torch.float32
    scene = dataclasses.replace(nominal_scene(liquid_motor("cpu", f32, propellant_mass=10.0)),
                                rocket=RocketParams.create("cpu", f32, propellant_mass=10.0))
    scene_b, ic_b, _ = sample_dispersions(  # seven lanes: no shared leaf is seven long
        prng.prng_key(0), scene, InitialConditions.vertical_launch("cpu", f32), n=7)
    args = prepare_batch(scene_b, ic_b)
    cfg = SimConfig(**dict(FULL_FLIGHTS, descent_dt_scale=2, ascent_q_threshold=7877.984034123052),
                    dt=0.08, max_time=21.0)
    coarse = cfg.dt * cfg.descent_dt_scale
    ref = fs.flight_summary_reference(*args, cfg)
    assert [float(ref["apogee_time"][i]) for i in (0, 4)] == pytest.approx([19.28, 18.24], abs=1e-4)
    got = {k: v.clone() for k, v in ref.items()}
    for lane in (0, 4):  # landings a step later: landing ties
        got["n_steps"][lane] += 1
        got["flight_time"][lane] += coarse
    got["apogee_time"][0] -= cfg.dt  # float64's apex, a coast coarse a step later
    got["apogee_time"][4] += coarse  # the step after the apex
    _, ties, _, _, tied_apex = chip_smoke.tied_landings(args, ref, got, cfg, "t")
    assert ties.nonzero().flatten().tolist() == tied_apex.nonzero().flatten().tolist() == [0, 4]
    got["apogee_time"][0] = ref["apogee_time"][0]
    got["apogee_time"][4] -= 2 * coarse  # the step before
    with pytest.raises(AssertionError, match="no tie"):
        chip_smoke.tied_landings(args, ref, got, cfg, "t")
    got["apogee_time"][4] += 4 * coarse  # three steps after
    with pytest.raises(AssertionError, match="apogee_time"):
        chip_smoke.tied_landings(args, ref, got, cfg, "t")
    got["apogee_time"][2] += 4 * coarse  # three steps later
    with pytest.raises(AssertionError, match="apogee_time"):
        chip_smoke.tied_landings(args, ref, got, cfg, "t")
    got["apogee_time"][0] += 2 * cfg.dt  # three steps later
    with pytest.raises(AssertionError, match="apogee_time"):
        chip_smoke.tied_landings(args, ref, got, cfg, "t")