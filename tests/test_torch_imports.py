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
        "envelope", "resimulate")} <= set(MODULES)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary\n"
        "assert flight_summary.launches == 0\n"
        "from erpl_monte_carlo_sim_tpu_torch.engine import simulate_flight_batch\n"
        "from erpl_monte_carlo_sim_tpu_torch.mc import EnvelopeAccumulator, ResimulationMixin\n"
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
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert all(n > 0 for n in eval(out.stdout.strip()))


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
