"""PyTorch port, ``MonteCarloAnalyzer(mesh=...)``, ``run_sharded_summaries``
and the multi-process entry point ``parallel.pod_scale`` on Gloo ranks on the
CPU.

Two spawned ranks (``run_ranks``, once for the module) run the analyzer
with a mesh on the JAX package's lanes (16 calm lanes, tests/test_parallel.py's
dispersion, on a 1.0 s window with the outlier floor near the median
apogee), fed through the draw seams (``_draw_single``, ``_draw_slab``): the
single call, re-simulation, a 2-slab run, the single call in chunks
(``chunk_steps``), the 2-slab run killed and
resumed (the checkpoint in a directory both ranks see, and in one directory
a rank, where only rank 0 sees it) and an uneven batch. Held against
the port's run without a mesh on the same lanes, float leaves at rtol 1e-9
(on the CPU ATen's vectorised loops run a shard's tail through scalar code,
so a lane's last bits can depend on where a shard ends: in the single
call of 2 x 8 lanes against 16, a lane's rail-exit angle of attack and
sideslip differ in their last bits here; on the card the flight kernel has
no cross-lane arithmetic, and chip_smoke holds the analysis bit for bit),
masks, counts and integers exact; and against the JAX analyzer with its
8-device mesh (rtol 1e-6, tests/test_parallel.py's bar for calm lanes
across shardings). ``pod_scale`` runs as two OS processes joined
through a TCP store, as tests/test_multihost.py runs the JAX script: both
print the same JSON, but for wall and rate. The ranks import this module,
which imports no JAX. The ranks, ``pod_scale``'s processes, the JAX run
and the run without a mesh go at once (the ranks are processes; XLA
compiles with the interpreter lock released).
"""

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
from erpl_monte_carlo_sim_tpu_torch.mc import (MonteCarloAnalyzer, OutlierBounds,
                                               UncertaintyParams)
from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
from erpl_monte_carlo_sim_tpu_torch.parallel import (init_distributed, make_mesh,
                                                     run_ranks, run_sharded_summaries,
                                                     shard_batch)
from erpl_monte_carlo_sim_tpu_torch.parallel.spawn import free_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SLAB, SEED, WINDOW = 16, 8, 0, 1.0
MIN_APOGEE = 34.4  # near the window's median apogee: 7 valid lanes, 9 outliers
SHARDED_WINDOW = 0.3
CHUNK_STEPS = 7  # the chunked run: chunks of the 1.0 s window's 26 steps
RESIM = [0, 9, 15]
CALM = dict(wind_speed_range=(0.0, 0.3), initial_attitude=(0.001, 0.001, 0.001))
METRICS = ("apogee_altitude", "range", "flight_time")


def analyzer(mesh=None):
    return MonteCarloAnalyzer(motor=liquid_motor("cpu"),
                              uncertainty_params=UncertaintyParams(**CALM),
                              sim_config=SimConfig(max_time=WINDOW),
                              bounds=OutlierBounds(min_apogee=MIN_APOGEE), mesh=mesh)


def plain(obj):
    """An analysis as nested dicts, lists and NumPy arrays."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def close(a, b, what=""):
    """Two plain analyses equal in structure, integers, booleans and strings,
    their floats within rtol 1e-9 (NaN meets NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, list) and not (a and isinstance(a[0], (float, int))):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{what}[{i}]")
    elif isinstance(a, (float, np.floating)) or (
            isinstance(a, (np.ndarray, list)) and np.asarray(a).dtype.kind == "f"):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-9, atol=1e-15, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_equal(a, b, err_msg=what)


def fed(lanes: dict):
    """The draw seams fed with given lanes: ``lanes["single"]`` for a single
    call, ``lanes["slabs"][k]`` for slab k."""
    def single(analyzer, ic, n, seed, base_wind):
        return lanes["single"]

    def slab(analyzer, ic, k, slab, seed, base_wind):
        return lanes["slabs"][k]

    return single, slab


def runs(mc, lanes: dict) -> dict:
    """The analyzer's runs on the fed lanes: the single call with three lanes
    re-simulated, the 2-slab run, the single call in chunks of
    ``CHUNK_STEPS`` steps, and an uneven call."""
    ic = InitialConditions.vertical_launch("cpu")
    single, slab = fed(lanes)
    saved = analyzer_mod._draw_single, analyzer_mod._draw_slab
    analyzer_mod._draw_single, analyzer_mod._draw_slab = single, slab
    try:
        out = {"single": mc.run_monte_carlo(ic, n_samples=N, seed=SEED)}
        s, traj = mc.resimulate_trajectories(RESIM)
        out["resim"] = {"apogee_altitude": s.apogee_altitude, "n_steps": s.n_steps,
                        "frames": traj.position.shape}
        out["slabbed"] = mc.run_monte_carlo(ic, n_samples=N, lane_slab=SLAB, seed=SEED)
        out["chunked"] = mc.run_monte_carlo(ic, n_samples=N, seed=SEED, chunk_steps=CHUNK_STEPS)
        try:
            mc.run_monte_carlo(ic, n_samples=N - 1, seed=SEED)
            out["uneven"] = "no error"
        except ValueError as e:
            out["uneven"] = str(e)
    finally:
        analyzer_mod._draw_single, analyzer_mod._draw_slab = saved
    for k in ("single", "slabbed", "chunked"):
        out[k] = {key: v for key, v in out[k].items() if key != "initial_conditions"}
    return plain(out)


def killed_and_resumed(mc, lanes: dict, path: str) -> dict:
    """The 2-slab run stopped at its second draw with a checkpoint after the
    first slab (rank 0 writes it), then resumed from it by every rank; the
    slabs the resumed run drew."""
    import torch.distributed as dist

    ic = InitialConditions.vertical_launch("cpu")
    single, slab = fed(lanes)
    drawn = []

    def dying(analyzer, ic, k, slab_size, seed, base_wind):
        if k == 1:
            raise RuntimeError("simulated crash")
        return slab(analyzer, ic, k, slab_size, seed, base_wind)

    def counted(analyzer, ic, k, slab_size, seed, base_wind):
        drawn.append(k)
        return slab(analyzer, ic, k, slab_size, seed, base_wind)

    saved = analyzer_mod._draw_slab
    try:
        analyzer_mod._draw_slab = dying
        with pytest.raises(RuntimeError, match="simulated crash"):
            mc.run_monte_carlo(ic, n_samples=N, lane_slab=SLAB, seed=SEED,
                               checkpoint_path=path, checkpoint_every=1)
        dist.barrier()  # a resumed job starts after the killed one ended on every rank
        written = os.path.exists(path)
        analyzer_mod._draw_slab = counted
        out = mc.run_monte_carlo(ic, n_samples=N, lane_slab=SLAB, seed=SEED,
                                 checkpoint_path=path, checkpoint_every=1)
    finally:
        analyzer_mod._draw_slab = saved
    dist.barrier()
    out = {key: v for key, v in out.items() if key != "initial_conditions"}
    return {"written": written, "left": os.path.exists(path), "drawn": drawn,
            "analysis": plain(out)}


def on_ranks(mesh, lanes: dict, tmp: str) -> dict:
    """One rank's runs with the mesh, a killed and resumed slabbed run with
    the checkpoint in a directory every rank sees (``resumed``) and in one
    directory a rank (``resumed_apart``: ranks on nodes that share no
    filesystem), and ``run_sharded_summaries`` on its block of the single
    call's lanes (a 0.3 s window)."""
    torch.set_num_threads(1)
    mc = analyzer(mesh)
    out = runs(mc, lanes)
    out["resumed"] = killed_and_resumed(mc, lanes, os.path.join(tmp, "run.ckpt.npz"))
    out["resumed_apart"] = killed_and_resumed(
        mc, lanes, os.path.join(tmp, f"rank{mesh.rank}", "run.ckpt.npz"))
    scene_b, ic_b, _ = lanes["single"]
    summary = run_sharded_summaries(shard_batch(scene_b, mesh, N, base_tree=mc.scene),
                                    shard_batch(ic_b, mesh, N), None,
                                    SimConfig(max_time=SHARDED_WINDOW), mesh, N)
    out["sharded_summaries"] = plain(summary)
    return out


def jax_lanes(key, n):
    import jax

    from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
    from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxParams
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
    from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
    from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import (ic_from_numpy, sample_from_numpy,
                                                             scene_from_numpy)

    scene_b, ic_b, sample = jax.device_get(jax_sample(
        key, jax_nominal(jax_liquid()), JaxIC.vertical_launch(), JaxParams(**CALM), n=n))
    return (scene_from_numpy(scene_b, "cpu"), ic_from_numpy(ic_b, "cpu"),
            sample_from_numpy(sample, "cpu"))


def jax_mesh_run() -> dict:
    """The JAX analyzer with its 8-device mesh on the same lanes (its own draw
    from the seed)."""
    from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
    from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
    from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
    from erpl_monte_carlo_sim_tpu.mc import OutlierBounds as JaxBounds
    from erpl_monte_carlo_sim_tpu.mc import UncertaintyParams as JaxParams
    from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
    from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
    from erpl_monte_carlo_sim_tpu.parallel import make_mesh as jax_mesh

    mc = JaxAnalyzer(scene=jax_nominal(jax_liquid()), uncertainty_params=JaxParams(**CALM),
                     sim_config=JaxConfig(max_time=WINDOW),
                     bounds=JaxBounds(min_apogee=MIN_APOGEE), mesh=jax_mesh(n_devices=8),
                     persistent_cache=False)
    return mc.run_monte_carlo(JaxIC.vertical_launch(), n_samples=N, seed=SEED)


def start_pod_scale() -> list:
    """The entry point as two OS processes on the CPU, joined through a TCP
    store, at 256 lanes on a 1.0 s window (tests/test_multihost.py's run of
    the JAX script, cut to fit)."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-m", "erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale", "256",
         "--max-time", "1.0", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]


def finish(procs: list) -> list:
    """Each process's ``(return code, stdout, stderr)``; none outlives this."""
    try:
        outs = [p.communicate(timeout=240) for p in procs]
        return [(p.returncode, *out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def everything():
    """``(rank results, the run without a mesh, the JAX mesh run, the
    lanes, pod_scale's two processes' (return code, stdout, stderr))``,
    all run at once."""
    import jax

    procs = start_pod_scale()
    try:
        with ThreadPoolExecutor(2) as ex, tempfile.TemporaryDirectory() as tmp:
            ref = ex.submit(jax_mesh_run)
            key = jax.random.PRNGKey(SEED)
            lanes = {"single": jax_lanes(key, N),
                     "slabs": [jax_lanes(jax.random.fold_in(key, k), SLAB)
                               for k in range(N // SLAB)]}
            on = ex.submit(run_ranks, on_ranks, 2, lanes, tmp, device="cpu", timeout_s=300)
            without = runs(analyzer(), lanes)
            ranks, jax_ref = on.result(), ref.result()
    finally:
        pod = finish(procs)
    return ranks, without, jax_ref, lanes, pod


@pytest.fixture(scope="module")
def ranks(everything):
    return everything[0]


@pytest.fixture(scope="module")
def no_mesh(everything):
    return everything[1]


@pytest.fixture(scope="module")
def jax_mesh(everything):
    return everything[2]


def test_ranks_form_the_same_analysis(ranks):
    """Every rank forms the same analysis (but for its own timings; where
    each rank has its own directory, only rank 0's holds the checkpoint)."""
    for r in ranks:
        for run in (r["single"], r["slabbed"], r["chunked"], r["resumed"]["analysis"],
                    r["resumed_apart"]["analysis"]):
            del run["performance"]["total_time"], run["performance"]["simulations_per_second"]

    def but_written(r):
        return {**r, "resumed_apart": {k: v for k, v in r["resumed_apart"].items()
                                       if k != "written"}}

    np.testing.assert_equal(but_written(ranks[1]), but_written(ranks[0]))


@pytest.mark.parametrize("run", ["single", "slabbed", "chunked"])
def test_mesh_run_is_the_run_without_a_mesh(ranks, no_mesh, run):
    """Every key but ``performance`` (``close``); ``cores_used`` is the
    mesh's size. In the chunked run each rank's chunks end when its own
    lanes are done."""
    got, ref = ranks[0][run], no_mesh[run]
    assert got.keys() == ref.keys()
    for k in got:
        if k != "performance":
            close(got[k], ref[k], k)
    assert got["performance"]["cores_used"] == 2 and ref["performance"]["cores_used"] == 1
    assert got["n_samples"] > 0


def test_mesh_run_matches_jax_mesh_run(ranks, jax_mesh):
    """The JAX analyzer sharded over 8 devices on the same lanes: the
    summaries and the statistics at rtol 1e-6, the masks exact."""
    got, ref = ranks[0]["single"], jax_mesh
    assert ref["performance"]["cores_used"] == 8
    assert got["n_samples"] == ref["n_samples"] and got["n_outliers"] == ref["n_outliers"]
    np.testing.assert_array_equal(got["valid_mask"], np.asarray(ref["valid_mask"]))
    for k in METRICS:
        np.testing.assert_allclose(got["summary"][k], np.asarray(getattr(ref["summary"], k)),
                                   rtol=1e-6)
        for s in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(got[k][s], ref[k][s], rtol=1e-6, err_msg=f"{k} {s}")
        np.testing.assert_allclose(got[k]["percentiles"], ref[k]["percentiles"], rtol=1e-6)


def test_run_sharded_summaries_is_one_device_call(ranks, everything):
    """Each rank's block flown and gathered: the global summary of one
    ``simulate_summary_batch`` call on every lane (``close``)."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch

    scene_b, ic_b, _ = everything[3]["single"]
    ref = plain(simulate_summary_batch(scene_b, ic_b, SimConfig(max_time=SHARDED_WINDOW)))
    close(ranks[0]["sharded_summaries"], ref)


def test_resimulation_after_a_mesh_run(ranks, no_mesh):
    """Re-simulated lanes fly on the rank's device and give the run's
    summaries, as without a mesh."""
    got = ranks[0]
    np.testing.assert_array_equal(got["resim"]["apogee_altitude"],
                                  got["single"]["summary"]["apogee_altitude"][RESIM])
    np.testing.assert_array_equal(got["resim"]["n_steps"],
                                  got["single"]["summary"]["n_steps"][RESIM])
    close(got["resim"], no_mesh["resim"])
    assert got["resim"]["frames"][0] == len(RESIM)


def test_killed_and_resumed_mesh_run(ranks):
    """The checkpoint (rank 0 writes it) is there for every rank after the
    kill, every rank resumes from it, the resumed run is the uninterrupted
    one, and the file goes at the end."""
    assert [r["resumed"]["written"] for r in ranks] == [True, True]
    for r in ranks:
        assert not r["resumed"]["left"] and r["resumed"]["drawn"] == [1]
        got, ref = r["resumed"]["analysis"], r["slabbed"]
        for k in got:
            if k != "performance":
                close(got[k], ref[k], k)


def test_resume_when_only_rank_0_sees_the_checkpoint(ranks):
    """Each rank's checkpoint path in a directory of its own, as on nodes
    that share no filesystem: rank 0 writes the file, reads it on resume and
    hands it to rank 1, so both resume at the second slab and form the
    uninterrupted run's analysis."""
    assert [r["resumed_apart"]["written"] for r in ranks] == [True, False]
    for r in ranks:
        got = r["resumed_apart"]
        assert not got["left"] and got["drawn"] == [1]
        for k in got["analysis"]:
            if k != "performance":
                close(got["analysis"][k], r["slabbed"][k], k)


def test_uneven_batch_raises(ranks):
    for r in ranks:
        assert "does not split evenly over 2 ranks" in r["uneven"]


def test_mesh_must_be_on_the_scene_device():
    with pytest.raises(TypeError, match="LaneMesh"):
        analyzer(mesh=object())
    mesh = make_mesh("cpu")
    assert analyzer(mesh=mesh).mesh is mesh
    meta = mesh.__class__(None, 0, 1, torch.device("meta"))
    with pytest.raises(ValueError, match="build the scene on mesh.device"):
        analyzer(mesh=meta)


def test_no_fallback_without_a_card():
    """Without a job ``init_distributed`` does nothing; a card that is asked
    for and missing raises, and nothing falls back to the CPU."""
    assert init_distributed() == 0
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed(f"127.0.0.1:{free_port()}", 2, 0)
    with pytest.raises(ValueError, match="num_processes and process_id"):
        init_distributed("127.0.0.1:1", 2)


def test_pod_scale_two_processes_identical_stats(everything):
    """The entry point as two OS processes on the CPU (tests/test_multihost.py's
    bars at 256 lanes, on a 1.0 s window; started with the module's other
    runs): both print the same JSON, but for their walls and rates."""
    outs = []
    for rc, stdout, stderr in everything[4]:
        assert rc == 0, f"rc={rc}\n{stderr[-2000:]}"
        outs.append(json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1]))
    a, b = ({k: v for k, v in o.items() if k not in ("wall_s", "traj_per_s")} for o in outs)
    assert a == b
    assert outs[0]["processes"] == outs[0]["devices"] == 2
    assert outs[0]["lanes"] == 256 and outs[0]["apogee_extremes"]["n"] > 0
    assert outs[0]["apogee_mean_at_cutoff"] > 0
    assert outs[0]["apogee_extremes"]["min"] <= outs[0]["apogee_extremes"]["max"]


@pytest.mark.parametrize("size", [1, 2], ids=["world1", "world2"])
def test_pod_scale_draws_the_jax_scripts_lanes(size):
    """``pod_scale``'s slab k is the JAX script's: one rank draws the whole
    slab under ``fold_in(PRNGKey(seed), k)``, more ranks their shares under
    ``fold_in(slab_key, rank)`` (scripts/pod_scale.py:96-112)."""
    import jax

    from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
    from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
    from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
    from erpl_monte_carlo_sim_tpu_torch.models import nominal_scene
    from erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale import rank_lanes

    seed, k, n = 3, 1, 8
    slab_key = jax.random.fold_in(jax.random.PRNGKey(seed), k)
    for rank in range(size):
        key = slab_key if size == 1 else jax.random.fold_in(slab_key, rank)
        _, _, want = jax_sample(key, jax_nominal(jax_liquid()), JaxIC.vertical_launch(), n=n)
        _, _, got = rank_lanes(nominal_scene(liquid_motor("cpu")),
                               InitialConditions.vertical_launch("cpu"), seed, k, rank, n, size)
        for f in ("wind_speed", "wind_direction"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        for f in ("initial_velocity_offset", "mass_multiplier", "motor_thrust_multiplier"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-12, err_msg=f)
