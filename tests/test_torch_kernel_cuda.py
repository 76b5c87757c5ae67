"""PyTorch port, the whole-flight CUDA kernel (``csrc/flight_summary.cu``)
through its wrapper ``kernels/flight_summary.py``.

The wrapper's input checks and argument layout run on the CPU: they refuse
what the kernel does not take before any library is built or loaded. The
kernel itself runs only on a card. Those tests are marked ``cuda``, skip
without one, and hold the kernel to its plain PyTorch version with the
check ``chip_smoke.py`` runs. This file imports no JAX, so on a machine
with a card (and without JAX) they run with

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernel_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (compare, compare_records, head, kernel_and_plain, records_of,
                        sample_batch, slab_reference)
from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_flight_batch, simulate_summary_batch)
from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.engine import component
from erpl_monte_carlo_sim_tpu_torch.kernels.measure import (COMBINED, FLAG_SETS, combined,
                                                            digest, with_stall)
from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, sample_dispersions
from erpl_monte_carlo_sim_tpu_torch.mc.analyzer import _host_stats
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene

torch.set_num_threads(1)

WINDOW = SimConfig(max_time=6.0)


def cpu_batch(n, dtype=torch.float64):
    """A dispersed batch on the CPU, split as the wrapper takes it."""
    gen = torch.Generator().manual_seed(0)
    scene_b, ic_b, _ = sample_dispersions(
        gen, nominal_scene(liquid_motor("cpu", dtype)),
        InitialConditions.vertical_launch("cpu", dtype), n=n)
    return prepare_batch(scene_b, ic_b)


def with_leaf(scene_nw, part, **fields):
    return dataclasses.replace(
        scene_nw, **{part: dataclasses.replace(getattr(scene_nw, part), **fields)})


def test_kernel_args_layout():
    """Eight lanes, the length of the Mach table: per-lane leaves get stride
    1, shared ones stride 0, and the tables stay shared [K] whatever their
    length (a shared table of length B is not mistaken for a per-lane
    leaf)."""
    scene_nw, grid, wind, ics = cpu_batch(8)
    assert scene_nw.rocket.cd_mach.shape == (8,)
    a = fs._kernel_args(scene_nw, grid, wind, ics, WINDOW)
    n, ptrs, strides, table_ptrs, sizes, cfg_vals = (a.n, a.ptrs, a.strides, a.table_ptrs,
                                                     a.sizes, a.cfg_vals)
    assert n == 8 and len(ptrs) == len(strides) == fs._N_LEAVES
    stride = dict(zip([f"{p}.{f}" for p, f in fs._SCENE_LEAVES], strides))
    assert stride["rocket.dry_mass"] == 1 and stride["motor.burn_time"] == 1
    assert stride["atmosphere.density_scale"] == 1
    assert stride["rocket.diameter"] == 0 and stride["atmosphere.gravity"] == 0
    assert strides[len(fs._SCENE_LEAVES):] == [1] * 12
    assert sizes == [8, scene_nw.rocket.cp_shift_mach.numel(),
                     scene_nw.motor.curve_time.numel(), grid.numel()]
    # the seven tables, the grid, the (lane-minor) wind table, the flags
    assert len(table_ptrs) == 10 and a.wind_lane_stride == 1
    assert cfg_vals[:3] == [WINDOW.dt, 0.5 * WINDOW.dt, WINDOW.dt / 6.0]

    # a shared [N, 3] wind table has lane stride 0
    shared = fs._kernel_args(scene_nw, grid, wind[0].contiguous(), ics, WINDOW)
    assert shared.wind_lane_stride == 0


@pytest.mark.parametrize("case,error,match", [
    ("per_lane_table", ValueError, "per-lane tables are not supported"),
    ("table_length", ValueError, "table lengths"),
    ("leaf_shape", ValueError, r"expected a scalar or \[4\]"),
    ("dtype", ValueError, "float32 or float64"),
    ("mixed_dtype", ValueError, "expected torch.float64"),
    ("wind_lanes", ValueError, "shared or per lane"),
])
def test_kernel_args_refuse(case, error, match):
    scene_nw, grid, wind, ics = cpu_batch(4)
    cfg = WINDOW
    r = scene_nw.rocket
    if case == "per_lane_table":
        scene_nw = with_leaf(scene_nw, "rocket", cd0_table=r.cd0_table.repeat(4, 1))
    elif case == "table_length":
        scene_nw = with_leaf(scene_nw, "rocket", cda_table=r.cda_table[:-1].contiguous())
    elif case == "leaf_shape":
        scene_nw = with_leaf(scene_nw, "rocket", dry_mass=r.dry_mass[:3].contiguous())
    elif case == "dtype":
        ics = tuple(t.to(torch.bfloat16) for t in ics)
    elif case == "mixed_dtype":
        scene_nw = with_leaf(scene_nw, "rocket", diameter=r.diameter.float())
    elif case == "wind_lanes":
        wind = wind[:3].contiguous()
    with pytest.raises(error, match=match):
        fs._kernel_args(scene_nw, grid, wind, ics, cfg)


def test_kernel_args_take_the_bf16_table():
    """Under wind_table_bf16 the wrapper hands the kernel the lane-minor
    table in bfloat16 and picks the bfloat16 build."""
    scene_nw, grid, wind, ics = cpu_batch(4)
    a = fs._kernel_args(scene_nw, grid, wind, ics, SimConfig(max_time=6.0, wind_table_bf16=True))
    assert a.wind.dtype == torch.bfloat16 and a.wind.shape == (grid.numel(), 3, 4)
    assert torch.equal(a.wind, wind.permute(1, 2, 0).to(torch.bfloat16))
    assert a.build == fs.KernelFlags(wind_bf16=True) and a.table_ptrs[8] == a.wind.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(COMBINED))
def test_flag_sets_match_plain_version_on_cuda(name, dtype):
    """Each combined flag set's build (``kernels/measure.py COMBINED``)
    against the plain version on the card, 256 dispersed lanes for 2 s;
    with the stall-limited moments the wind is scaled 4x and lane 7's wind
    is NaN above 2 km, without the non-finite stop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    fields, stall = combined(COMBINED[name])
    scene_b, ic_b = sample_batch(256, dtype, nan_lane=7 if stall else None)
    if stall:
        scene_b = with_stall(dataclasses.replace(scene_b, wind=dataclasses.replace(
            scene_b.wind, wind=scene_b.wind.wind * 4.0)))
    before = fs.launches
    ref, got = kernel_and_plain(scene_b, ic_b, SimConfig(max_time=2.0, **fields))
    assert fs.launches == before + 1
    compare(ref, got, dtype)
    assert bool(got["diverged"].all()) == (name == "speed_guard")
    if stall:
        assert bool(got["apogee_altitude"][7].isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["parity", "full_flights+rk2"])
def test_plain_graph_replay_is_the_eager_loop_on_cuda(name, dtype, monkeypatch):
    """On the card the plain version replays one captured main-loop step
    (``engine/component.py _replay_steps``): every output bit as the eager
    loop's, on 256 dispersed lanes for 2 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the eager loop only")
    fields = {} if name == "parity" else FLAG_SETS[name][0]
    cfg = SimConfig(max_time=2.0, **fields)
    args = prepare_batch(*sample_batch(256, dtype))
    graphed = fs.flight_summary_reference(*args, cfg)
    monkeypatch.setattr(component, "_replay_steps", component._run_steps)
    eager = fs.flight_summary_reference(*args, cfg)
    assert (eager["n_steps"] > 150).all()
    assert digest(graphed) == digest(eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float64, 64), (torch.float32, 256),
                                     (torch.float32, 130)],
                         ids=["f64-64", "f32-256", "f32-130-ragged"])
def test_kernel_matches_plain_version_on_cuda(dtype, n):
    """The kernel against its plain version on the card, on the same
    dispersed lanes; in float64 lane 7's wind table is NaN above 2 km and
    must diverge at the same step in both. 130 lanes leave a ragged last
    block of 128 threads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    scene_b, ic_b = sample_batch(n, dtype, nan_lane=7 if dtype == torch.float64 else None)
    before = fs.launches
    ref, got = kernel_and_plain(scene_b, ic_b, WINDOW)
    assert fs.launches == before + 1
    compare(ref, got, dtype)
    assert (got["n_steps"][got["diverged"] == 0] > 1000).all()
    if dtype == torch.float64:
        assert bool(got["diverged"][7]) and int(got["n_steps"][7]) == int(ref["n_steps"][7])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged-845", "nan-mach", "unsorted-mach", "shared-wind"])
def test_kernel_paths_match_plain_version_on_cuda(case):
    """The kernel's other paths against the plain version, in float32: 845
    lanes (a multiple of no block size the kernel is built for) leave a
    ragged last block, whose idle threads still reach the block's barrier; a
    NaN in the cd0 table (every lane diverges at its first step) and a Mach
    table whose knots do not increase take the full-knot sum instead of the
    window; a shared [N, 3] wind table is read at lane stride 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    n = 845 if case == "ragged-845" else 256
    scene_b, ic_b = sample_batch(n, torch.float32)
    rocket, wind = scene_b.rocket, scene_b.wind
    if case == "nan-mach":
        cd0 = rocket.cd0_table.clone()
        cd0[3] = float("nan")
        scene_b = dataclasses.replace(scene_b, rocket=dataclasses.replace(rocket, cd0_table=cd0))
    elif case == "unsorted-mach":
        mach = rocket.cd_mach.clone()
        mach[[2, 3]] = mach[[3, 2]]
        scene_b = dataclasses.replace(scene_b, rocket=dataclasses.replace(rocket, cd_mach=mach))
    elif case == "shared-wind":
        scene_b = dataclasses.replace(
            scene_b, wind=dataclasses.replace(wind, wind=wind.wind[0].contiguous()))
    before = fs.launches
    ref, got = kernel_and_plain(scene_b, ic_b, WINDOW)
    assert fs.launches == before + 1
    compare(ref, got, torch.float32)
    if case == "nan-mach":
        assert bool(got["diverged"].all()) and bool((got["n_steps"] == 1).all())
    else:
        assert (got["n_steps"] > 1000).all()


@pytest.mark.cuda
def test_slabbed_run_is_its_single_calls_on_cuda():
    """A run of 3 slabs of 1024 lanes on the card launches the kernel once a
    slab, and its metrics, masks and stats blocks are those of one
    ``simulate_summary_batch`` call per slab on the slab's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    dev = torch.device("cuda")
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW)
    ic = InitialConditions.vertical_launch(dev)
    before = fs.launches
    a = mc.run_monte_carlo(ic, n_samples=3 * 1024, lane_slab=1024, seed=2)
    assert fs.launches == before + 3
    metrics, valid, reasons = slab_reference(mc, ic, 3 * 1024, 1024, 2)
    for k, v in metrics.items():
        np.testing.assert_array_equal(a["metrics"][k], v, err_msg=k)
    np.testing.assert_array_equal(a["valid_mask"], valid)
    np.testing.assert_array_equal(a["reasons"], reasons)
    assert 0 < a["n_samples"]
    for k in ("apogee_altitude", "range", "flight_time"):
        np.testing.assert_equal(a[k], _host_stats(metrics[k], valid), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [(torch.float32, 256), (torch.float64, 64)],
                         ids=["f32-256", "f64-64"])
def test_record_build_matches_plain_recorder_on_cuda(dtype, n):
    """The recording build against the plain recorder (graph-replayed on
    the card) on 64 of the lanes, a frame every 3 steps for 6 s; its summary
    the summary build's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU records with the plain version only")
    cfg = SimConfig(max_time=6.0, record_stride=3)
    args = prepare_batch(*sample_batch(n, dtype))
    before = fs.launches
    got, recs = fs.flight_record(*args, cfg)
    assert fs.launches == before + 1
    summary = fs.flight_summary(*args, cfg)
    assert digest(got) == digest(summary)
    part = head(args, n, 64)
    ref, ref_recs = fs.flight_record_reference(*part, cfg)
    compare(ref, head(got, n, 64), dtype)
    compare_records(ref_recs, {k: ({c: x[:, :64] for c, x in v.items()} if k == "derived"
                                   else v[:, :64]) for k, v in recs.items()}, dtype)
    assert bool((recs["valid"].sum(0) > 300).all())


@pytest.mark.cuda
def test_simulate_flight_batch_records_through_the_kernel_on_cuda():
    """``simulate_flight_batch`` on CUDA tensors launches the recording
    build once; its summary is ``simulate_summary_batch``'s bit for bit and
    its trajectory the records the wrapper returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU records with the plain version only")
    scene_b, ic_b = sample_batch(128, torch.float32)
    cfg = SimConfig(max_time=2.0, record_stride=2, record_channels=("mach", "euler_angles"))
    before = fs.launches
    s, traj = simulate_flight_batch(scene_b, ic_b, cfg)
    assert fs.launches == before + 1
    want = simulate_summary_batch(scene_b, ic_b, cfg)
    assert torch.equal(s.apogee_altitude, want.apogee_altitude)
    assert torch.equal(s.n_steps, want.n_steps)
    _, recs = fs.flight_record(*prepare_batch(scene_b, ic_b), cfg)
    mine = records_of(traj, 128)
    assert set(mine["derived"]) == set(recs["derived"]) == {"mach", "euler_roll",
                                                            "euler_pitch", "euler_yaw"}
    for k in ("time", "pz", "qw", "valid"):
        assert torch.equal(mine[k], recs[k]), k


@pytest.mark.cuda
def test_record_room_check_raises_before_the_launch_on_cuda():
    """60,001 frames of 35 channels for 16,384 lanes (2 x 138 GB) do not
    fit the card: the wrapper raises with the numbers, and launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = prepare_batch(*sample_batch(16_384, torch.float32))
    before = fs.launches
    with pytest.raises(RuntimeError, match="GiB are free"):
        fs.flight_record(*args, SimConfig())
    assert fs.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["recorder", "envelope"])
def test_graph_replayed_blocks_are_the_eager_loop_on_cuda(what, monkeypatch):
    """On the card the plain recorder and the in-loop envelope replay one
    captured block of steps (``engine/component.py _replay_blocks``): the
    recorder's every bit as the eager loop's; the envelope's counts,
    histograms, min and max too, its sums (scattered with atomic adds, in
    no fixed order) at rtol 1e-12, float64, 128 lanes for 2 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the eager loop only")
    cfg = SimConfig(max_time=2.0, record_stride=2)
    args = prepare_batch(*sample_batch(128, torch.float64))
    wind_fn = component.table_wind_fn(args[1], args[2])

    def run():
        if what == "recorder":
            return fs.flight_record_reference(*args, cfg)
        channels = ("altitude", "speed", "mach")
        lo = torch.zeros((3, 8), dtype=torch.float32, device="cuda")
        width = torch.full((3, 8), 100.0, dtype=torch.float32, device="cuda")
        return component.flight_components_envelope(args[0], cfg, wind_fn, args[3], channels,
                                                    8, 16, 0.25, lo, width, 2)

    graphed = run()
    monkeypatch.setattr(component, "_replay_blocks",
                        lambda block, carry, n, running, stride: component._run_blocks(
                            block, carry, n, running))
    eager = run()
    assert digest(graphed[0]) == digest(eager[0])
    for k, a in graphed[1].items():
        b = eager[1][k]
        if isinstance(a, dict):
            assert all(torch.equal(a[c], b[c]) for c in a), k
        elif k in ("mean", "m2"):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0.0)
        else:
            assert torch.equal(a, b), k
