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

from chip_smoke import (compare, compare_records, derived_of_frames, head, kernel_and_plain,
                        records_of, sample_batch, slab_reference)
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
from erpl_monte_carlo_sim_tpu_torch.ops import prng

torch.set_num_threads(1)

WINDOW = SimConfig(max_time=6.0)


def cpu_batch(n, dtype=torch.float64):
    """A dispersed batch on the CPU, split as the wrapper takes it."""
    scene_b, ic_b, _ = sample_dispersions(
        prng.prng_key(0), nominal_scene(liquid_motor("cpu", dtype)),
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
@pytest.mark.parametrize("dtype,n", [(torch.float32, 256), (torch.float64, 64),
                                     (torch.float32, 1), (torch.float32, 4096)],
                         ids=["f32-256", "f64-64", "f32-1", "f32-4096"])
def test_record_build_matches_plain_recorder_on_cuda(dtype, n):
    """The recording build (its flight and its derived pass, one launch
    each) against the plain recorder (graph-replayed on the card) on up to
    64 of the lanes, a frame every 3 steps for 6 s; its summary the summary
    build's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU records with the plain version only")
    cfg = SimConfig(max_time=6.0, record_stride=3)
    args = prepare_batch(*sample_batch(n, dtype))
    before, derived_before = fs.launches, fs.derived_launches
    got, recs = fs.flight_record(*args, cfg)
    assert fs.launches == before + 1 and fs.derived_launches == derived_before + 1
    summary = fs.flight_summary(*args, cfg)
    assert digest(got) == digest(summary)
    part = head(args, n, 64)
    ref, ref_recs = fs.flight_record_reference(*part, cfg)
    compare(ref, head(got, n, 64), dtype)
    compare_records(ref_recs, {k: ({c: x[:, :64] for c, x in v.items()} if k == "derived"
                                   else v[:, :64]) for k, v in recs.items()}, dtype)
    assert bool((recs["valid"].sum(0) > 300).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_derived_pass_is_the_plain_derived_c_on_cuda(dtype):
    """The recording build's derived pass alone, on frames whose derived
    channels were wiped, against the plain ``derived_c`` on the same frames
    (time and state): bit for bit in float64. In float32 within the bars of
    ``compare_records``: the kernel's own float32 sine and cosine (the fin
    sweep's, in every lift slope) are not torch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = SimConfig(max_time=6.0, record_stride=3)
    args = prepare_batch(*sample_batch(256, dtype))
    lay = fs.record_layout(cfg)
    frames = torch.empty((lay.n_frames, lay.n_channels, 256), dtype=dtype, device="cuda")
    stop = torch.empty(256, dtype=torch.int32, device="cuda")
    fs._launch(*args, cfg, rec=(frames, stop, lay))
    whole = fs.unpack_frames(frames.clone(), stop, lay)
    frames[:, len(fs.FRAME_KEYS):] = float("nan")
    before = fs.derived_launches
    fs._launch_derived(fs._kernel_args(*args, cfg, record=True), frames, stop, lay)
    assert fs.derived_launches == before + 1
    recs = fs.unpack_frames(frames, stop, lay)
    for k, v in whole["derived"].items():  # the pass alone is the build's pass
        assert torch.equal(v.nan_to_num(-1.0), recs["derived"][k].nan_to_num(-1.0)), k
    plain = derived_of_frames(args, recs, cfg)
    valid = recs["valid"]
    if dtype == torch.float64:
        for k, v in recs["derived"].items():
            a, b = v[valid], plain["derived"][k][valid]
            assert bool(((a == b) | (a.isnan() & b.isnan())).all()), k
    else:
        compare_records(plain, recs, dtype)


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


@pytest.mark.cuda
def test_sobol_points_on_the_card_are_the_cpus_on_cuda():
    """The scrambled Sobol integers are built from int64 words kept below
    2**32: the card's are the CPU's bit for bit for the same seeds; the
    normals (float64 inverse CDF, rounded) within 4 ulp of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from erpl_monte_carlo_sim_tpu_torch.ops import sobol

    seeds = sobol.draw_seeds(prng.prng_key(3, "cuda"), 4, 43)
    points = sobol.sobol_points(4096, 43, seeds)
    assert torch.equal(points.cpu(), sobol.sobol_points(4096, 43, seeds.cpu()))
    for dtype in (torch.float32, torch.float64):
        u = sobol._to_unit(points, dtype)
        a, b = sobol.ndtri(u).cpu().numpy(), sobol.ndtri(u.cpu()).numpy()
        ulps = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert ulps.max() <= 4, (dtype, ulps.max())


@pytest.mark.cuda
@pytest.mark.parametrize("option", [
    {"sampler": "sobol", "sobol_scrambles": 2, "sobol_wind_modes": 4},
    {"antithetic": True}, {"importance_shift": {"motor_thrust": 1.5}}],
    ids=["sobol", "antithetic", "importance"])
def test_sampling_variants_fly_through_the_kernel_on_cuda(option):
    """Each variant's lanes, drawn on the card over a three-member forecast
    ensemble, fly through the kernel (one launch) and meet the plain
    version at the float32 bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    dev = torch.device("cuda")
    grid = np.linspace(0.0, 25000.0, 100)
    ens = np.stack([np.zeros((100, 3)), np.full((100, 3), 3.0), np.full((100, 3), -3.0)])
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW, **option)
    mc.base_altitude_profile, mc.base_wind_profile = grid, ens
    before = fs.launches
    a = mc.run_monte_carlo(InitialConditions.vertical_launch(dev), n_samples=1024, seed=4)
    assert fs.launches == before + 1
    assert a["ensemble"]["n_members"] == 3 and a["wind_members"].shape == (1024,)
    ref, got = kernel_and_plain(*mc._last_batch, WINDOW)
    compare(ref, got, torch.float32)


@pytest.mark.cuda
def test_cv_moments_on_the_card_are_a_float64_recomputation_on_cuda():
    """The control variates' slab moments reduced on the card (float32 lanes,
    the turbulence and wind-speed controls included) against the same
    function on the CPU in float64 over the same lanes' controls and
    targets: counts exact, means and cross-moments within 1e-4 of their
    matrix's scale, the adjusted means within 1% of their stderr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from erpl_monte_carlo_sim_tpu_torch.mc.cv import CVMoments, cv_slab_moments, finalize_cv
    from erpl_monte_carlo_sim_tpu_torch.mc.filter import outlier_mask
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda")
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW, control_variates=True,
                            cv_wind_modes=4, cv_wind_speed=3)
    ic = InitialConditions.vertical_launch(dev)
    before = fs.launches
    a = mc.run_monte_carlo(ic, n_samples=8192, seed=5)
    assert fs.launches == before + 1
    scene_b, ic_b = mc._last_batch
    summary = simulate_summary_batch(scene_b, ic_b, WINDOW)
    valid, _ = outlier_mask(summary, mc.bounds)
    from erpl_monte_carlo_sim_tpu_torch.mc.analyzer import _draw_single

    _, _, sample = _draw_single(mc, ic, 8192, 5, None)
    ones = torch.ones(8192, dtype=torch.bool, device=dev)
    got = cv_slab_moments(sample, summary, valid, ones, mc.uncertainty_params, mc.scene.motor,
                          mc._cv_wind_ctrl(scene_b, sample, None))

    def host64(x):
        return tree_map(lambda t: t.detach().cpu().double() if t.is_floating_point()
                        else t.detach().cpu(), x)

    mc64 = MonteCarloAnalyzer(motor=liquid_motor("cpu", torch.float64), sim_config=WINDOW,
                              control_variates=True, cv_wind_modes=4, cv_wind_speed=3)
    ref = cv_slab_moments(host64(sample), host64(summary), valid.cpu(), ones.cpu(),
                          mc64.uncertainty_params, mc64.scene.motor,
                          mc64._cv_wind_ctrl(host64(scene_b), host64(sample), None))
    assert int(got[0]) == int(ref[0]) == int(valid.sum())
    for name, x, y in zip(("mz", "mt", "szz", "szt", "stt"), got[1:], ref[1:]):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4 * np.abs(y).max(), err_msg=name)
    acc = CVMoments()
    acc.add(ref)
    want = finalize_cv(acc, mc64._cv_names())
    for m in ("apogee_altitude", "range", "flight_time"):
        blk = a["control_variates"][m]
        assert abs(blk["mean"] - want[m]["mean"]) <= 1e-2 * want[m]["stderr"], m


@pytest.mark.cuda
def test_subset_level_g_flies_through_the_kernel_on_cuda():
    """One batched chain step of subset simulation: ``g`` of 2,048 lanes of
    standard normals is one kernel launch, equal to the kernel's apogee on
    the valid lanes (-inf elsewhere), and the kernel meets the plain version
    on those lanes at the float32 bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_from_normals
    from erpl_monte_carlo_sim_tpu_torch.mc.filter import outlier_mask

    dev = torch.device("cuda")
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW)
    ic = InitialConditions.vertical_launch(dev)
    g_fn, d, _, sign = mc._subset_g_fn(ic, "apogee_altitude", "above", 1, None)
    u = np.random.default_rng(0).standard_normal((2048, d))
    before = fs.launches
    g = g_fn(u)
    assert fs.launches == before + 1 and g.shape == (2048,) and sign == 1.0
    scene_b, ic_b, _ = sample_from_normals(u, mc.scene, ic)
    summary = simulate_summary_batch(scene_b, ic_b, WINDOW)
    valid = outlier_mask(summary, mc.bounds)[0].cpu().numpy()
    apogee = summary.apogee_altitude.cpu().numpy()
    np.testing.assert_array_equal(g, np.where(valid & np.isfinite(apogee), apogee, -np.inf))
    assert valid.mean() > 0.9
    ref, got = kernel_and_plain(scene_b, ic_b, WINDOW)
    compare(ref, got, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,k", [(torch.float32, 1024, 24), (torch.float64, 256, 24),
                                       (torch.float64, 256, 100)],
                         ids=["f32-k24", "f64-k24", "f64-full"])
def test_kernel_on_expanded_modes_is_the_modes_query_on_cuda(dtype, n, k):
    """Mode-compressed wind: the kernel flies each lane's expanded table
    (one launch), held to the plain version's modes query at the kernel's
    bars; at full rank also to the realized tables' flights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from erpl_monte_carlo_sim_tpu_torch.models import compress_wind, wind_mode_basis

    scene_b, ic_b = sample_batch(n, dtype)
    q = wind_mode_basis(scene_b.wind_model, scene_b.wind.altitudes.cpu().numpy(), k)
    modes = dataclasses.replace(scene_b, wind=compress_wind(scene_b.wind, q))
    before = fs.launches
    ref, got = kernel_and_plain(modes, ic_b, WINDOW)
    assert fs.launches == before + 1
    compare(ref, got, dtype)
    if k >= scene_b.wind.altitudes.numel():
        compare(fs.flight_summary(*prepare_batch(scene_b, ic_b), WINDOW), got, dtype)


@pytest.mark.cuda
def test_graphed_segments_are_eager_autograd_on_cuda():
    """The differentiable flight's graphed segments (CUDA graphs of the
    forward and of the recomputed vector-Jacobian product) against eager
    autograd on the card: metrics bit for bit, gradients with respect to
    the per-lane thrust scale and wind table at rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs eager autograd only")
    from erpl_monte_carlo_sim_tpu_torch.engine import diff

    scene_b, ic_b = sample_batch(16, torch.float64)
    cfg = SimConfig(max_time=1.2)
    out = {}
    for name, fn in (("graphed", diff.simulate_metrics_diff), ("eager", diff.metrics_reference)):
        ts = scene_b.motor.thrust_scale.detach().clone().requires_grad_(True)
        wt = scene_b.wind.wind.detach().clone().requires_grad_(True)
        scene = dataclasses.replace(scene_b, motor=dataclasses.replace(scene_b.motor,
                                                                       thrust_scale=ts),
                                    wind=dataclasses.replace(scene_b.wind, wind=wt))
        m = fn(scene, ic_b, cfg)
        grads = torch.autograd.grad(m["apogee_altitude"].sum() + m["range"].sum(), [ts, wt])
        out[name] = ({k: v.detach() for k, v in m.items()}, grads)
    (m_g, g_g), (m_e, g_e) = out["graphed"], out["eager"]
    for k in m_e:
        assert torch.equal(m_g[k], m_e[k]), k
    for a, b in zip(g_g, g_e):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()))


@pytest.mark.cuda
def test_nccl_one_rank_mesh_run_is_the_run_without_a_mesh_on_cuda():
    """``MonteCarloAnalyzer(mesh=...)`` on an NCCL group of one rank (a TCP
    store on a free localhost port): the single call and a 2-slab run are
    the runs without a mesh bit for bit, one launch a call or slab,
    ``cores_used`` 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device, nvcc and NCCL; the CPU tests run Gloo ranks")
    import torch.distributed as dist

    from chip_smoke import same_analysis
    from erpl_monte_carlo_sim_tpu_torch.parallel import init_distributed, make_mesh
    from erpl_monte_carlo_sim_tpu_torch.parallel.spawn import free_port

    dev = torch.device("cuda")
    ic = InitialConditions.vertical_launch(dev)
    plain = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW, max_lanes_per_call=4096)
    refs = [plain.run_monte_carlo(ic, n_samples=n, seed=1) for n in (4096, 8192)]
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and (mesh.size, mesh.rank) == (1, 0)
        mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=WINDOW, mesh=mesh,
                                max_lanes_per_call=4096)
        for n, ref in zip((4096, 8192), refs):
            before = fs.launches
            got = mc.run_monte_carlo(ic, n_samples=n, seed=1)
            assert fs.launches == before + n // 4096
            same_analysis(got, ref)
            assert got["performance"]["cores_used"] == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_threefry_kernel_is_plain_and_jax_on_cuda():
    """Every draw of chip_smoke.py phase 17a through the threefry kernel:
    the plain version's on the card and the committed JAX golden's at the
    phase's bars (the chains' kept lanes against the golden)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import (THREEFRY_GOLDEN, threefry_cases, threefry_error, threefry_key,
                            threefry_kept)
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf

    with np.load(THREEFRY_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    for name, spec, kind, shape, kw in threefry_cases():
        key = threefry_key(spec, torch.device("cuda"))
        before = tf.launches
        got = tf.draw(key, kind, shape, **kw)
        assert tf.launches == before + 1, name
        threefry_error(got, tf.draw_reference(key, kind, shape, **kw), kind, kw.get("dtype"))
        threefry_error(threefry_kept(name, got), golden[name], kind, kw.get("dtype"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chain", "given"])
def test_ar1_kernel_is_plain_on_cuda(mode):
    """The AR(1) kernel against its plain version on the card, bit for bit:
    the fused wind chain (float32 and float64, ``sub`` 1 and None, 4,099
    lanes: a ragged last block) and the recursion on a given driver; one
    launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import threefry_key
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
    from erpl_monte_carlo_sim_tpu_torch.models import WindModelParams
    from erpl_monte_carlo_sim_tpu_torch.models.wind import _ar1_constants

    dev = torch.device("cuda")
    turb = threefry_key(("turb", 0), dev)
    for dtype in (torch.float32, torch.float64):
        grid = torch.linspace(0.0, 25_000.0, 100, dtype=dtype, device=dev)
        consts = _ar1_constants(WindModelParams.create(dev, dtype), grid, dtype)
        for sub in ((1, None) if mode == "chain" else (None,)):
            kw = (dict(key=turb, lanes=4099, sub=sub) if mode == "chain" else
                  dict(noise=torch.randn(4099, 100, 3, dtype=dtype, device=dev)))
            before = tf.ar1_launches
            got = tf.ar1(*consts, **kw)
            assert tf.ar1_launches == before + 1
            assert torch.equal(got, tf.ar1_reference(*consts, **kw)), (dtype, sub)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_single_flight_entry_points_launch_the_kernel_on_cuda(dtype):
    """``engine.simulate_summary`` on CUDA tensors is one K1 launch, equal to
    the stacked plain version on the card at the kernel's bars (the launch
    quaternion the engine's own), and a single flight comes back without a
    lane axis; ``simulate_flight`` launches the recording build and its
    derived pass once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_flight, simulate_summary
    from erpl_monte_carlo_sim_tpu_torch.engine.simulate import simulate_summary_reference

    scene_b, ic_b = sample_batch(64, dtype)
    cfg = SimConfig(max_time=2.0)
    before = fs.launches
    got = simulate_summary(scene_b, ic_b, cfg)
    assert fs.launches == before + 1
    kernel = fs.flight_summary(*prepare_batch(scene_b, ic_b), cfg)
    assert torch.equal(got.n_steps, kernel["n_steps"])
    compare(fs.summary_out(simulate_summary_reference(scene_b, ic_b, cfg), ic_b), kernel,
            dtype)

    dev = torch.device("cuda")
    scene, ic = nominal_scene(liquid_motor(dev, dtype)), InitialConditions.vertical_launch(dev, dtype)
    launched = (fs.launches, fs.record_launches, fs.derived_launches)
    s, traj = simulate_flight(scene, ic, cfg)
    assert (fs.launches, fs.record_launches, fs.derived_launches) == tuple(
        n + 1 for n in launched)
    assert s.apogee_altitude.ndim == 0 and traj.position.shape == (cfg.max_steps + 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_stacked_graph_replay_is_the_eager_loop_on_cuda(dtype, monkeypatch):
    """On the card the stacked plain versions replay a captured step and a
    captured record block (``component._blocks``): every summary leaf and
    every frame as the eager loops', on 64 dispersed lanes for 1.5 s,
    recorded every 4 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the eager loop only")
    from chip_smoke import leaves
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate as stacked

    scene_b, ic_b = sample_batch(64, dtype)
    cfg = SimConfig(max_time=1.5, record_stride=4)
    graphed = (stacked.simulate_summary_reference(scene_b, ic_b, cfg),
               *stacked.simulate_flight_reference(scene_b, ic_b, cfg))
    monkeypatch.setattr(component, "_replay_blocks",
                        lambda block, carry, n, running, stride:
                        component._run_blocks(block, carry, n, running))
    eager = (stacked.simulate_summary_reference(scene_b, ic_b, cfg),
             *stacked.simulate_flight_reference(scene_b, ic_b, cfg))
    assert int(eager[0].n_steps.max()) > 100
    for a, b in zip(graphed, eager):
        for (path, x), (_, y) in zip(leaves(a), leaves(b)):
            if isinstance(x, dict):
                assert x.keys() == y.keys(), path
                pairs = [(x[k], y[k]) for k in x]
            else:
                pairs = [(x, y)]
            for u, v in pairs:
                assert torch.equal(u, v) or bool(((u == v) | (u.isnan() & v.isnan())).all()), path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_stacked_route_folds_a_nan_speed_on_cuda(dtype):
    """``engine.simulate_summary`` and ``simulate_batch_chunked`` on CUDA
    tensors launch builds with the stacked engine's speed: a NaN-wind
    lane's ``max_speed`` is 0 in both, as in the stacked plain version on
    the card, whose other leaves they meet at the kernel's bars; the two
    routes are the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from chip_smoke import same_summaries
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_batch_chunked, simulate_summary
    from erpl_monte_carlo_sim_tpu_torch.engine.simulate import simulate_summary_reference

    scene_b, ic_b = sample_batch(64, dtype, nan_lane=7)
    cfg = SimConfig(max_time=2.0)
    before = (fs.launches, fs.fold_launches, fs.chunk_launches)
    got = simulate_summary(scene_b, ic_b, cfg)
    chunked = simulate_batch_chunked(scene_b, ic_b, cfg, chunk_steps=64)
    chunks = fs.chunk_launches - before[2]
    assert chunks >= 3 and fs.launches - before[0] == fs.fold_launches - before[1] == 1 + chunks
    assert float(got.max_speed[7]) == float(chunked.max_speed[7]) == 0.0
    assert bool(got.diverged[7]) and not bool(got.diverged[:7].any())
    assert same_summaries(got, chunked)
    kernel = fs.flight_summary(*prepare_batch(scene_b, ic_b), cfg, stacked_speed=True)
    compare(fs.summary_out(simulate_summary_reference(scene_b, ic_b, cfg), ic_b), kernel,
            dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["parity", "parity+stacked_speed", "full_flights"])
def test_carry_build_is_the_one_shot_build_on_cuda(case, dtype):
    """The carry build chunk by chunk against the one-shot build of the same
    flags, bit for bit in every output: 4,096 dispersed lanes of a 6 s
    window (one NaN-wind lane) in chunks of 256 steps, or the low-apogee
    scenes to landing under the full-flight set in chunks of 500; one
    launch a chunk, as many chunks as the longest lane needs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; the CPU runs the plain version only")
    from erpl_monte_carlo_sim_tpu_torch.kernels.measure import flag_set, low_apogee_batch

    stacked = case.endswith("stacked_speed")
    if case == "full_flights":
        cfg, chunk = flag_set("full_flights")[0], 500
        args = prepare_batch(*low_apogee_batch(torch.device("cuda"), dtype))
    else:
        cfg, chunk = WINDOW, 256
        args = prepare_batch(*sample_batch(4096, dtype, nan_lane=7))
    want = fs.flight_summary(*args, cfg, stacked_speed=stacked)
    before = fs.chunk_launches
    got = fs.flight_summary_chunked(*args, cfg, chunk, stacked_speed=stacked)
    steps = int(want["n_steps"].max())
    assert fs.chunk_launches - before == -(-steps // chunk) > 1
    assert digest(got) == digest(want)
    for k in want:
        assert bool(((got[k] == want[k]) | (got[k].isnan() & want[k].isnan())).all()
                    if got[k].is_floating_point() else torch.equal(got[k], want[k])), k
