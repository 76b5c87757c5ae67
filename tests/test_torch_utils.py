"""PyTorch port, the helpers of ``utils/``: the twins of tests/test_aux.py's
``check_finite``, ``debug_mode``, logging and scene-JSON tests, and the
serialization the reports are built on, held to the JAX package's.

A scene written by the JAX package's ``save_scene`` loads in the port and
flies the JAX package's summary (float64, a 3 s window, at
tests/test_batch.py's rtol 5e-7).
"""

import dataclasses
import json
import logging
import math

import jax
import numpy as np
import pytest
import torch

from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_summary as jax_summary
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
from erpl_monte_carlo_sim_tpu.utils.scene_io import save_scene as jax_save_scene
from erpl_monte_carlo_sim_tpu.utils.scene_io import scene_to_dict as jax_scene_to_dict
from erpl_monte_carlo_sim_tpu.utils.serialize import to_serializable as jax_serializable
from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_summary_batch)
from erpl_monte_carlo_sim_tpu_torch.mc import OutlierBounds
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, solid_motor
from erpl_monte_carlo_sim_tpu_torch.utils.debug import check_finite, debug_mode, trace_profile
from erpl_monte_carlo_sim_tpu_torch.utils.logging import configure, get_logger
from erpl_monte_carlo_sim_tpu_torch.utils.scene_io import (load_scene, save_scene,
                                                           scene_from_dict, scene_to_dict)
from erpl_monte_carlo_sim_tpu_torch.utils.serialize import (object_to_serializable_dict,
                                                            to_serializable)
from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map
from test_torch_flight import compare

torch.set_num_threads(1)

WINDOW = 3.0


def fly(scene):
    """One lane's summary on the CPU, as NumPy."""
    ic = InitialConditions.vertical_launch("cpu")
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                 ic.angular_velocity)))
    return tree_map(lambda x: x[0].numpy(),
                    simulate_summary_batch(scene, ic1, SimConfig(max_time=WINDOW)))


def test_check_finite_names_the_leaf():
    check_finite({"a": torch.ones(3), "b": np.ones(2), "n": 3}, "ok")
    check_finite(nominal_scene(liquid_motor("cpu")), "scene")
    with pytest.raises(FloatingPointError, match=r"bad\['a'\]: 1 non-finite"):
        check_finite({"a": torch.tensor([1.0, float("nan")])}, "bad")
    with pytest.raises(FloatingPointError, match=r"arr\[1\]: 2 non-finite"):
        check_finite([np.ones(2), np.array([np.inf, -np.inf, 0.0])], "arr")
    scene = nominal_scene(liquid_motor("cpu"))
    bad = dataclasses.replace(scene, rocket=dataclasses.replace(
        scene.rocket, dry_mass=torch.tensor(float("inf"), dtype=torch.float64)))
    with pytest.raises(FloatingPointError, match=r"scene\.rocket\.dry_mass"):
        check_finite(bad, "scene")


def test_debug_mode_restores_anomaly_detection():
    prev = torch.is_anomaly_enabled()
    with debug_mode(nans=True):
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == prev
    with pytest.raises(ValueError):
        with debug_mode(nans=True):
            raise ValueError("inside")
    assert torch.is_anomaly_enabled() == prev


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with trace_profile(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_logging():
    configure()
    log = get_logger("test")
    assert log.name == "erpl_monte_carlo_sim_tpu_torch.test"
    assert logging.getLogger("erpl_monte_carlo_sim_tpu_torch").handlers
    log.info("structured logging live")


def test_scene_json_roundtrip(tmp_path):
    scene = nominal_scene(solid_motor("cpu"))
    path = str(tmp_path / "scene.json")
    save_scene(scene, path)
    loaded = load_scene(path, "cpu")
    compare(fly(scene), fly(loaded), 0.0, 0.0)  # the same flight, bit for bit
    assert loaded.motor.mdot_follows_thrust == scene.motor.mdot_follows_thrust is True
    assert loaded.rocket.name == "Sounding Rocket"
    d = scene_to_dict(scene)
    assert d["rocket"]["dry_mass"] == 113.4
    f32 = scene_from_dict(d, "cpu", torch.float32)
    assert f32.rocket.dry_mass.dtype == torch.float32


@pytest.mark.parametrize("motor", ["liquid", "solid"])
def test_scene_written_by_jax_flies_jax_summary(tmp_path, motor):
    """The JAX package's scene file: the same dict key for key, and in the
    port the JAX package's flight."""
    jscene = jax_nominal(jax_liquid() if motor == "liquid" else jax_solid())
    path = str(tmp_path / "scene.json")
    jax_save_scene(jscene, path)
    loaded = load_scene(path, "cpu")
    port = nominal_scene(liquid_motor("cpu") if motor == "liquid" else solid_motor("cpu"))
    assert scene_to_dict(port).keys() == jax_scene_to_dict(jscene).keys()
    for part, want in jax_scene_to_dict(jscene).items():
        got = scene_to_dict(loaded)[part]
        assert got.keys() == want.keys(), part
        for k, v in want.items():
            if isinstance(v, (str, bool)):
                assert got[k] == v, (part, k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-15, err_msg=f"{part}.{k}")
    ref = jax.jit(jax_summary, static_argnums=2)(jscene, JaxIC.vertical_launch(),
                                                  JaxConfig(max_time=WINDOW))
    compare(jax.tree.map(np.asarray, ref), fly(loaded), 5e-7)


def test_serialization_matches_jax():
    """The report's parameter blocks: key for key and value for value the
    JAX package's on the same scene; tensors on any device become lists,
    static fields plain values, NaN stays a float."""
    jscene = jax_nominal(jax_liquid())
    scene = nominal_scene(liquid_motor("cpu"))
    for part in ("rocket", "motor", "atmosphere", "wind_model"):
        want = jax_serializable(getattr(jscene, part))
        got = object_to_serializable_dict(getattr(scene, part))
        assert got.keys() == want.keys(), part
        for k, v in want.items():
            if isinstance(v, (str, bool)):
                assert got[k] == v
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-15, err_msg=f"{part}.{k}")
    assert object_to_serializable_dict(scene.rocket)["name"] == "Sounding Rocket"
    out = to_serializable({"t": torch.tensor([1.0, float("nan")]), "i": np.int64(3),
                           "s": torch.tensor(2.5), "b": OutlierBounds(), "l": (np.float32(1),)})
    assert out["i"] == 3 and out["s"] == 2.5 and out["l"] == [1.0]
    assert out["t"][0] == 1.0 and math.isnan(out["t"][1])
    assert out["b"] == jax_serializable(dataclasses.asdict(OutlierBounds()))
    assert json.loads(json.dumps(out))["i"] == 3
