"""PyTorch port, reporting (``reporting/``) and the post-hoc CLIs against the
JAX package's, on the same lanes: the twin of tests/test_reporting.py.

Both packages fly the same flights in float64: the single flight of the
nominal liquid scene at one lane through each package's recorder, and a
16-lane Monte Carlo run with tests/test_reporting.py's calm dispersions,
which the JAX analyzer draws and the port's run takes through its draw seam
(``mc.analyzer._draw_single``, as tests/test_torch_resimulate.py feeds it).
The flights are cut to a 2 s window (tests/test_reporting.py flies 30 s):
the port's plain version on the CPU costs about 13 ms a step whatever the
lane count. Held: the results dict key for key (values at rtol 1e-9), the
report's JSON keys recursively with its statistics and parameter blocks at
rtol 1e-9 and its TXT line for line (but the timestamp and the performance
block, which measure the host), the per-sim exports (the same files and
keys, histories at tests/test_trajectory_batch.py's bars), the CLIs on both
packages' exports, and every figure.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu import reporting as jax_reporting
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine import simulate_flight_batch as jax_flight_batch
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxUncertainty
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.utils.serialize import to_serializable as jax_serializable
from erpl_monte_carlo_sim_tpu_torch import reporting
from erpl_monte_carlo_sim_tpu_torch.cli.analyze_outlier import main as analyze
from erpl_monte_carlo_sim_tpu_torch.cli.find_max_apogee import main as find_max
from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                   simulate_flight_batch)
from erpl_monte_carlo_sim_tpu_torch.mc import (EnvelopeAccumulator, EnvelopeConfig,
                                               MonteCarloAnalyzer, UncertaintyParams)
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                         scene_from_numpy)
from erpl_monte_carlo_sim_tpu_torch.utils.serialize import to_serializable
from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

WINDOW = 2.0
N = 16
SEED = 0
RTOL = 1e-9
CALM = dict(wind_speed_range=(0.0, 0.5), initial_attitude=(0.001, 0.001, 0.001))
JSCENE = jax_nominal(jax_liquid())
JIC = JaxIC.vertical_launch()

# tests/test_reporting.py's result-dict contract
RESULT_KEYS = [
    "time", "position", "velocity", "quaternion", "angular_velocity",
    "propellant_fraction", "mass", "moments_of_inertia", "altitude", "speed",
    "euler_angles", "center_of_mass", "thrust", "drag", "cd", "cl", "cm",
    "cp_location_dynamic", "cp_location", "thrust_curve_time",
    "thrust_curve_thrust", "stability_margin", "angle_of_attack",
    "sideslip_angle", "apogee_time", "apogee_altitude", "range",
    "flight_time", "rail_exit_time", "rail_exit_speed", "rail_exit_euler",
    "rail_exit_angle_of_attack", "rail_exit_sideslip", "wind_at_exit",
    "rocket_parameters", "motor_parameters", "simulation_assumptions",
    "trajectory",
]
# the blocks of a report that measure the host, not the run
HOST_BLOCKS = ("timestamp", "performance")


def same_keys(a, b, path=""):
    """The same dict keys at every depth (lists element by element)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in a:
            same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_keys(x, y, f"{path}[{i}]")


def same_values(a, b, rtol, atol=0.0, path=""):
    """Every number within ``rtol``/``atol`` (NaN meets NaN), every other
    value equal."""
    if isinstance(a, dict):
        for k in a:
            same_values(a[k], b[k], rtol, atol, f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)) and np.asarray(a).dtype.kind in "fiub":
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=rtol, atol=atol, err_msg=path)
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_values(x, y, rtol, atol, f"{path}[{i}]")
    elif isinstance(a, (float, int)) and not isinstance(a, bool):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=path)
    else:
        assert a == b, (path, a, b)


def jax_single(analyzer, ic, n, seed, base_wind):
    """The port's single-call draw, replaced: the JAX analyzer's lanes."""
    scene_b, ic_b, sample = jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC,
                                       JaxUncertainty(**CALM), n, base_wind=base_wind)
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


@pytest.fixture(scope="module")
def single():
    """``(JAX results dict, port results dict)`` of the nominal flight."""
    jic1 = jax.tree.map(lambda x: np.asarray(x)[None], JIC)
    ref_s, ref_t = (jax.tree.map(lambda x: np.asarray(x)[0], part)
                    for part in jax_flight_batch(JSCENE, jic1, JaxConfig(max_time=WINDOW)))
    ref = jax_reporting.to_results_dict(JSCENE, ref_s, ref_t, JaxConfig(max_time=WINDOW),
                                        initial_conditions=JIC)
    scene = nominal_scene(liquid_motor("cpu"))
    ic = InitialConditions.vertical_launch("cpu")
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                 ic.angular_velocity)))
    s, t = (tree_map(lambda x: x[0], part)
            for part in simulate_flight_batch(scene, ic1, SimConfig(max_time=WINDOW)))
    got = reporting.to_results_dict(scene, s, t, SimConfig(max_time=WINDOW),
                                    initial_conditions=ic)
    return ref, got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 16 lanes through both analyzers, each report written:
    ``{package: (analyzer, analysis, output dir, report dict)}``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_single", jax_single)
        ref_mc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW),
                             uncertainty_params=JaxUncertainty(**CALM), persistent_cache=False)
        ref = ref_mc.run_monte_carlo(JIC, n_samples=N, seed=SEED)
        mc = MonteCarloAnalyzer(motor=liquid_motor("cpu"), sim_config=SimConfig(max_time=WINDOW),
                                uncertainty_params=UncertaintyParams(**CALM))
        got = mc.run_monte_carlo(InitialConditions.vertical_launch("cpu"), n_samples=N,
                                 seed=SEED)
    base = tmp_path_factory.mktemp("reports")
    out = {}
    for name, module, analyzer, analysis in (("jax", jax_reporting, ref_mc, ref),
                                             ("port", reporting, mc, got)):
        d = module.create_output_directory(base=str(base / name))
        report = module.save_report(analysis, d, analyzer=analyzer)
        out[name] = (analyzer, analysis, d, report)
    return out


def test_results_dict_matches_jax(single):
    ref, got = single
    for key in RESULT_KEYS + ["initial_conditions"]:
        assert key in got, key
    assert got.keys() == ref.keys()
    for key, a in ref.items():
        b = got[key]
        if isinstance(a, np.ndarray):
            assert b.shape == a.shape, (key, a.shape, b.shape)
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-12, err_msg=key)
        else:
            same_keys(jax_serializable(a), to_serializable(b), key)
            same_values(jax_serializable(a), to_serializable(b), RTOL, 1e-12, key)
    T = len(got["time"])
    assert got["position"].shape == (3, T) and got["euler_angles"].shape == (3, T)
    assert got["rocket_parameters"]["name"] == "Sounding Rocket"
    assert got["initial_conditions"]["position"] == [0.0, 0.0, 10.0]


def test_report_matches_jax(runs):
    _, ref_a, ref_dir, ref = runs["jax"]
    _, got_a, got_dir, got = runs["port"]
    assert got_a["n_samples"] == ref_a["n_samples"] >= 2
    files = [json.load(open(os.path.join(d, "monte_carlo_report.json")))
             for d in (ref_dir, got_dir)]
    same_keys(files[0], files[1])
    for key in files[0]:
        if key not in HOST_BLOCKS:
            same_values(files[0][key], files[1][key], RTOL, 1e-9, key)
    assert got["rocket_parameters"]["name"] == "Sounding Rocket"
    assert files[1]["performance"].keys() == files[0]["performance"].keys()

    def lines(d):
        with open(os.path.join(d, "monte_carlo_report.txt")) as f:
            text = f.read().split("Performance Statistics:")[0]
        return [ln for ln in text.splitlines() if not ln.startswith("Generated:")]

    assert lines(got_dir) == lines(ref_dir)
    assert "Percentile sampling CIs (95%)" in "\n".join(lines(got_dir))


@pytest.fixture(scope="module")
def exports(runs):
    """Each package's ``simulation_results`` directory, 4 lanes."""
    out = {}
    for name, module in (("jax", jax_reporting), ("port", reporting)):
        analyzer, analysis, d, _ = runs[name]
        assert module.save_simulation_results(analyzer, analysis, d, max_sims=4) == 4
        out[name] = os.path.join(d, "simulation_results")
    return out


def test_per_sim_exports_match_jax(exports):
    names = sorted(os.listdir(exports["port"]))
    assert names == sorted(os.listdir(exports["jax"])) and len(names) == 4
    for name in names:
        ref, got = (json.load(open(os.path.join(exports[k], name))) for k in ("jax", "port"))
        same_keys(ref, got, name)
        for key, a in ref.items():
            # tests/test_trajectory_batch.py's bars: state 5e-7 / 1e-6, derived 1e-6
            rtol = 5e-7 if key in ("time", "position", "velocity", "quaternion",
                                   "angular_velocity", "propellant_fraction") else 1e-6
            same_values(a, got[key], rtol, 1e-6, f"{name}.{key}")


def test_clis_on_both_packages_exports(exports, capsys):
    found = {k: find_max(d) for k, d in exports.items()}
    assert found["port"][0] == found["jax"][0] >= 0
    np.testing.assert_allclose(found["port"][1], found["jax"][1], rtol=5e-7)
    assert found["port"][1] > 100.0
    info = {k: analyze(d, found[k][0]) for k, d in exports.items()}
    assert info["port"].keys() == info["jax"].keys()
    for key in ("apogee", "flight_time", "max_speed"):
        np.testing.assert_allclose(info["port"][key], info["jax"][key], rtol=1e-6, err_msg=key)
    assert info["port"]["burnout_index"] == info["jax"]["burnout_index"]
    assert info["port"]["max_quat_norm_drift"] < 1e-6
    assert info["jax"]["max_quat_norm_drift"] < 1e-6
    assert "Max quaternion norm deviation" in capsys.readouterr().out


def test_find_max_apogee_handles_null_and_empty(tmp_path):
    d = tmp_path / "sims"
    d.mkdir()
    (d / "sim_0.json").write_text(json.dumps({"apogee_altitude": None}))
    (d / "sim_1.json").write_text(json.dumps({"apogee_altitude": 1234.5, "simulation_id": 1}))
    assert find_max(str(d)) == (1, 1234.5)
    empty = tmp_path / "none"
    empty.mkdir()
    assert find_max(str(empty)) == (None, None)


def test_every_figure(runs, exports, single):
    mc, analysis, out, _ = runs["port"]
    first = mc._resim_memo
    paths = [
        reporting.plot_results(analysis, out),
        reporting.plot_landing_footprint(analysis, out),
        reporting.plot_trajectory_cloud(mc, analysis, out, max_trajectories=4),
        reporting.plot_trajectory_cloud_3d(mc, analysis, out, max_trajectories=4),
        reporting.plot_single_simulation(single[1], out),
        reporting.plot_thrust_twr(single[1], out),
        reporting.plot_exceedance(analysis, "apogee_altitude", out),
    ]
    # the clouds fly nothing: the exports' recording serves them
    assert mc._resim_memo is first
    _, traj = first[1]
    acc = EnvelopeAccumulator(mc.sim_config, EnvelopeConfig(bin_dt=0.1))
    acc.add(traj)
    paths.append(reporting.plots.plot_flight_envelope(acc.result(), out))
    hist = [{"n_valid": n, **{k: {"mean": m + 0.1 * n, "stderr": 1.0 / n}
                              for k, m in (("apogee_altitude", 100.0), ("range", 2.0),
                                           ("flight_time", 2.0))}}
            for n in (4, 8, 16)]
    paths.append(reporting.plot_convergence({"convergence": hist}, out))
    # the estimators' figures: the GPD overlay on this run, and a Sobol'
    # decomposition with intervals and a pair row in mc.sobol_indices' schema
    gpd_dir = os.path.join(out, "gpd")
    os.makedirs(gpd_dir)
    paths.append(reporting.plot_exceedance(analysis, "apogee_altitude", gpd_dir, gpd=True))
    groups = ["mass", "motor_thrust", "wind_turbulence"]
    indices = {"groups": groups, "pairs": ["mass*motor_thrust"]}
    for k, m in enumerate(("apogee_altitude", "range")):
        s = [0.1 + 0.2 * k, 0.5, 0.05]
        indices[m] = {
            "variance": 4.0 + k,
            "first_order": {g: {"S": v, "ci95": [v - 0.05, v + 0.05]} for g, v in zip(groups, s)},
            "total_order": {g: {"T": v + 0.1, "ci95": [v, v + 0.2]} for g, v in zip(groups, s)},
            "second_order": {"mass*motor_thrust": {"closed": 0.7, "interaction": 0.04,
                                                   "ci95": [0.0, 0.08]}}}
    paths.append(reporting.plot_sobol_indices(indices, out))
    for p in paths:
        assert p is not None and os.path.getsize(p) > 10_000, p
    assert reporting.plot_sobol_indices({"groups": []}, out) is None


def test_txt_report_every_block_matches_jax(runs, exports, tmp_path):
    """``_write_txt_report`` line for line the JAX package's, over every
    block it renders: the run's own stats and footprint, a flight envelope
    and a sequential record made by the port from the run, and the blocks
    of the estimators still to port (ROADMAP P12, P13) in their schema."""
    from erpl_monte_carlo_sim_tpu.reporting.report import _write_txt_report as jax_write
    from erpl_monte_carlo_sim_tpu_torch.mc import parse_criterion
    from erpl_monte_carlo_sim_tpu_torch.reporting.report import _write_txt_report

    mc, analysis, _, report = runs["port"]
    acc = EnvelopeAccumulator(mc.sim_config, EnvelopeConfig(bin_dt=0.1))
    acc.add(mc._resim_memo[1][1])
    apogee = analysis["summary"].apogee_altitude[analysis["valid_mask"]]
    crits = [parse_criterion(c) for c in (
        {"metric": "apogee_altitude", "mean_stderr": 0.5},
        {"metric": "apogee_altitude", "exceed": 150.0, "p_limit": 0.1},
        {"metric": "apogee_altitude", "exceed": 150.0, "ci_halfwidth": 0.2},
        {"metric": "apogee_altitude", "percentile": 95.0, "ci_halfwidth": 5.0})]
    for c in crits:
        c.update(apogee)
    est = {m: {"mean": 101.5, "std": 2.5, "stderr": 0.25, "variance_reduction": 3.0, "n_eff": 12.0,
               "bias": -0.125, "bias_stderr": 0.05, "corrected_mean": 101.375,
               "corrected_stderr": None if m == "range" else 0.3}
           for m in ("apogee_altitude", "range", "flight_time")}
    full = dict(report,
                flight_envelope=acc.result(),
                sequential={"n_used": 16, "max_samples": 32, "stopped_early": True,
                            "criteria": [c.block() for c in crits]},
                control_variates=est, importance=dict(est, shift={"motor_thrust": 2.0}),
                two_level=dict(est, n_coupled=64),
                ensemble={"n_members": 2, "members": [
                    {"member": k, "n_valid": 8, "n_drawn": 8, "apogee_altitude": est["range"],
                     "range": est["range"]} for k in range(2)],
                    "post_stratified": est})
    full = json.loads(json.dumps(to_serializable(full)))
    for name, write in (("jax", jax_write), ("port", _write_txt_report)):
        os.makedirs(tmp_path / name)
        write(full, str(tmp_path / name))
    ref, got = (open(tmp_path / k / "monte_carlo_report.txt").read() for k in ("jax", "port"))
    assert got == ref
    for block in ("Flight Envelope", "Sequential Stopping", "Control-Variate",
                  "Two-Level", "Importance-Sampled", "Forecast Ensemble",
                  "Landing Dispersion Footprint", "Performance Statistics"):
        assert block in got, block
