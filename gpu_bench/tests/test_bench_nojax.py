"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares each module's top-level name whole, so the port
(``erpl_monte_carlo_sim_tpu_torch``) passes and the JAX package does not."""

from __future__ import annotations

import os
import subprocess
import sys
import types

from gpu_bench import run, spec
from gpu_bench.tests.fixtures import tiny_root  # noqa: F401


def test_names_are_compared_whole(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "erpl_monte_carlo_sim_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "erpl_monte_carlo_sim_tpu_torch", types.ModuleType("p"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("j"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "erpl_monte_carlo_sim_tpu.engine", types.ModuleType("e"))
    assert run.loaded_forbidden() == ["erpl_monte_carlo_sim_tpu"]


def test_a_whole_run_loads_no_jax(tiny_root):  # noqa: F811
    """A fresh process runs each tiny cell; ``main`` exits 4 where a
    forbidden module was loaded, and prints the result line otherwise."""
    code = ("import sys; from gpu_bench import run; "
            "rc = [run.main(['--workload', c, '--seed', '1', '--seconds', '0.1', '--trace', '1'], "
            f"root={tiny_root!r}, device='cpu') for c in ('tiny.analysis', 'tiny.gonogo')]; "
            "print('RC', rc, run.loaded_forbidden())")
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=tiny_root, timeout=600)
    assert "RC [0, 0] []" in p.stdout, p.stderr[-3000:]
