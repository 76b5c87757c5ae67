"""PyTorch port: imports and runs without JAX or Flax, and names neither."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "erpl_monte_carlo_sim_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax"}


def test_every_module_imports_with_jax_and_flax_blocked():
    assert {f"erpl_monte_carlo_sim_tpu_torch.mc.{m}" for m in (
        "slab_accumulators", "slab_checkpoint", "sequential", "checkpoint", "tail",
        "envelope", "resimulate", "ensemble", "importance", "cv", "two_level", "subset",
        "subset_driver", "sobol_indices", "robust")} <= set(MODULES)
    assert {f"erpl_monte_carlo_sim_tpu_torch.engine.{m}" for m in (
        "diff", "dynamics", "integrator", "rail", "simulate", "state")} <= set(MODULES)
    assert {f"erpl_monte_carlo_sim_tpu_torch.parallel.{m}" for m in (
        "mesh", "sharded", "pod_scale", "spawn")} <= set(MODULES)
    assert {f"erpl_monte_carlo_sim_tpu_torch.{m}" for m in (
        "ops.sobol", "ops.prng", "kernels.threefry", "random")} <= set(MODULES)
    assert {f"erpl_monte_carlo_sim_tpu_torch.capstones{m}" for m in (
        "", ".million_flights", ".full_flights", ".hundred_million_flights")} <= set(MODULES)
    assert {f"erpl_monte_carlo_sim_tpu_torch.{m}" for m in (
        "example", "reporting", "reporting.plots", "reporting.report", "reporting.results",
        "cli", "cli.find_max_apogee", "cli.analyze_outlier", "cli.launch_window",
        "cli.tail_probability", "cli.sensitivity", "cli.optimize_apogee",
        "utils.serialize", "utils.logging", "utils.scene_io", "utils.debug")} <= set(MODULES)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import importlib\n"
        "import torch\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary\n"
        "assert flight_summary.launches == 0\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine import simulate_flight_batch\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc import EnvelopeAccumulator, ResimulationMixin\n"
        "from erpl_monte_carlo_sim_tpu_torch.example import main\n"
        "from erpl_monte_carlo_sim_tpu_torch.cli.launch_window import main as lw\n"
        "from erpl_monte_carlo_sim_tpu_torch.reporting import save_report, plot_results\n"
        "from erpl_monte_carlo_sim_tpu_torch import Scene, WindField, RocketParams, cli\n"
        "from erpl_monte_carlo_sim_tpu_torch.ops import sobol\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc.ensemble import EnsembleAccumulator\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc.importance import log_weights\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc import (cv_slab_moments, subset_simulation,\n"
        "    sobol_indices, gpd_tail, two_level_block, sample_from_normals)\n"
        "from erpl_monte_carlo_sim_tpu_torch.cli.tail_probability import main as tp\n"
        "from erpl_monte_carlo_sim_tpu_torch.models import WindModes, compress_wind\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine.diff import simulate_metrics_diff\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine import (simulate_summary, simulate_flight,\n"
        "    simulate_rail, rocket_dynamics, rk4_step, advance, init_carry, EventState,\n"
        "    StepCarry, FlightState, initial_state)\n"
        "from erpl_monte_carlo_sim_tpu_torch.ops import (safe_norm, quaternion_multiply,\n"
        "    quaternion_to_rotation_matrix, rotate_by_matrix, rotate_by_matrix_t,\n"
        "    angular_velocity_to_quaternion_rate, mach_number, angle_of_attack,\n"
        "    sideslip_angle, wind_to_body_matrix)\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc import optimize_robust, auto_shift\n"
        "from erpl_monte_carlo_sim_tpu_torch.cli.sensitivity import variance_budget\n"
        "from erpl_monte_carlo_sim_tpu_torch.cli.optimize_apogee import optimize\n"
        "from erpl_monte_carlo_sim_tpu_torch.parallel import (collective_stats, make_mesh,\n"
        "    init_distributed, run_ranks)\n"
        "from erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale import main as pod\n"
        "from erpl_monte_carlo_sim_tpu_torch import parallel\n"
        "from erpl_monte_carlo_sim_tpu_torch.capstones import (full_flights,\n"
        "    hundred_million_flights, million_flights)\n"
        "assert callable(million_flights.run) and callable(hundred_million_flights.main)\n"
        "assert full_flights.TWO_LEVEL_SEED == 99\n"
        "assert sobol.sobol_points(8, 640, torch.zeros(1, 640, dtype=torch.int64)).shape[1] == 640\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_flight_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import torch\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer\n"
        "from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig\n"
        "mc = MonteCarloAnalyzer(motor=liquid_motor('cpu'), sim_config=SimConfig(max_time=1.5))\n"
        "a = mc.run_monte_carlo(InitialConditions.vertical_launch('cpu'), n_samples=4)\n"
        "print(a['summary'].n_steps.tolist())\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary\n"
        "from erpl_monte_carlo_sim_tpu_torch.models import nominal_scene\n"
        "s = simulate_summary(nominal_scene(liquid_motor('cpu')),\n"
        "                     InitialConditions.vertical_launch('cpu'), SimConfig(max_time=1.0))\n"
        "print([int(s.n_steps)])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and all(n > 0 for line in lines for n in eval(line))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernel_cuda.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_flax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("erpl_monte_carlo_sim_tpu.") and \
                name != "erpl_monte_carlo_sim_tpu", (path, name)


def test_no_source_reads_the_jax_packages_data():
    """The port keeps its own copies of the data it reads (the Sobol
    direction numbers among them): no source names the JAX package's data
    directory, and the Sobol table is the port's file."""
    from erpl_monte_carlo_sim_tpu_torch.ops import sobol

    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for name in ("erpl_monte_carlo_sim_tpu.data", "erpl_monte_carlo_sim_tpu/data"):
            assert name not in text, (path, name)
    assert pathlib.Path(sobol._TABLE).resolve() == PORT / "data" / "sobol_directions.npz"


def test_package_imports_without_matplotlib():
    """The figures import matplotlib when drawn: the package, its reports,
    exports and CLIs need no plotting library, and a figure raises naming
    the missing one."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import erpl_monte_carlo_sim_tpu_torch as p\n"
        "from erpl_monte_carlo_sim_tpu_torch.example import main\n"
        "from erpl_monte_carlo_sim_tpu_torch.reporting import plot_convergence\n"
        "h = [{'n_valid': n, **{k: {'mean': 1.0, 'stderr': 0.1} for k in "
        "('apogee_altitude', 'range', 'flight_time')}} for n in (1, 2)]\n"
        "try:\n"
        "    plot_convergence({'convergence': h}, '.')\n"
        "except ImportError as e:\n"
        "    print('matplotlib' in str(e))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
