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

import pytest
import torch

from chip_smoke import compare, kernel_and_plain, sample_batch
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
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
    n, ptrs, strides, table_ptrs, sizes, wind_stride, cfg_vals = fs._kernel_args(
        scene_nw, grid, wind, ics, WINDOW)
    assert n == 8 and len(ptrs) == len(strides) == fs._N_LEAVES
    stride = dict(zip([f"{p}.{f}" for p, f in fs._SCENE_LEAVES], strides))
    assert stride["rocket.dry_mass"] == 1 and stride["motor.burn_time"] == 1
    assert stride["atmosphere.density_scale"] == 1
    assert stride["rocket.diameter"] == 0 and stride["atmosphere.gravity"] == 0
    assert strides[len(fs._SCENE_LEAVES):] == [1] * 12
    assert sizes == [8, scene_nw.rocket.cp_shift_mach.numel(),
                     scene_nw.motor.curve_time.numel(), grid.numel()]
    assert len(table_ptrs) == 9 and wind_stride == grid.numel() * 3
    assert cfg_vals[:3] == [WINDOW.dt, 0.5 * WINDOW.dt, WINDOW.dt / 6.0]

    # a shared [N, 3] wind table has lane stride 0
    *_, shared_stride, _ = fs._kernel_args(scene_nw, grid, wind[0].contiguous(), ics,
                                           WINDOW)
    assert shared_stride == 0


@pytest.mark.parametrize("case,error,match", [
    ("per_lane_table", ValueError, "per-lane tables are not supported"),
    ("table_length", ValueError, "table lengths"),
    ("leaf_shape", ValueError, r"expected a scalar or \[4\]"),
    ("dtype", ValueError, "float32 or float64"),
    ("mixed_dtype", ValueError, "expected torch.float64"),
    ("wind_lanes", ValueError, "shared or per lane"),
    ("flag", NotImplementedError, "ROADMAP P7"),
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
    else:
        cfg = SimConfig(max_time=6.0, wind_table_bf16=True)
    with pytest.raises(error, match=match):
        fs._kernel_args(scene_nw, grid, wind, ics, cfg)


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
    scene_b, ic_b = sample_batch(n, dtype)
    if dtype == torch.float64:
        table = scene_b.wind.wind.clone()
        table[7, scene_b.wind.altitudes > 2000.0] = float("nan")
        scene_b = dataclasses.replace(
            scene_b, wind=dataclasses.replace(scene_b.wind, wind=table))
    before = fs.launches
    ref, got = kernel_and_plain(scene_b, ic_b, WINDOW)
    assert fs.launches == before + 1
    compare(ref, got, dtype)
    assert (got["n_steps"][got["diverged"] == 0] > 1000).all()
    if dtype == torch.float64:
        assert bool(got["diverged"][7]) and int(got["n_steps"][7]) == int(ref["n_steps"][7])
