"""PyTorch port, the stacked-vector single-flight engine (``ops`` helpers,
``engine.state``, ``engine.dynamics``, ``engine.integrator``,
``engine.rail``, ``engine.simulate``) against the JAX package's functions
of the same names, on the same inputs made from a seed with numpy.

On CPU tensors ``simulate_summary`` and ``simulate_flight`` run the eager
stacked physics, the plain version of the CUDA kernel they launch on a
card, so these tests pin that oracle to the JAX package (and to the
port's own component path, ``simulate_summary_batch``). Bars: the ops at
rtol 1e-12 in float64 and 2e-6 in float32; the right-hand side, RK4 and 50
``advance`` steps at 1e-9; flights in float64 at rtol 5e-7 / atol 1e-6
(tests/test_batch.py), in float32 at 2e-5 (tests/test_pallas.py);
integer leaves and flags exact.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu.engine as je
import erpl_monte_carlo_sim_tpu.ops as jops
from erpl_monte_carlo_sim_tpu.engine.rail import simulate_rail_masked as jax_rail_masked
from erpl_monte_carlo_sim_tpu.mc import scene_in_axes
from erpl_monte_carlo_sim_tpu.models import WindField as JaxWind
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import solid_motor as jax_solid
import erpl_monte_carlo_sim_tpu_torch.engine as pe
import erpl_monte_carlo_sim_tpu_torch.ops as pops
from erpl_monte_carlo_sim_tpu_torch.engine import batch as pbatch
from erpl_monte_carlo_sim_tpu_torch.engine import simulate as psim
from erpl_monte_carlo_sim_tpu_torch.engine.rail import simulate_rail_masked
from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
from erpl_monte_carlo_sim_tpu_torch.utils.convert import (carry_from_numpy, ic_from_numpy,
                                                         scene_from_numpy, state_from_numpy,
                                                         to_numpy)
from test_torch_flight import compare, leaves

torch.set_num_threads(1)

# s: rail exit at 0.87 s (liquid) and 0.67 s (solid), then 66 steps each
WINDOW = {"liquid": 1.2, "solid": 1.0}
FLIGHT_BARS = {jnp.float64: 5e-7, jnp.float32: 2e-5}
OP_BARS = {np.float64: 1e-12, np.float32: 2e-6}
STEP_BAR = 1e-9
N_LANES = 8
NAN_LANE = 3


def cast(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype)
                        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


def jax_scene(motor, dtype=jnp.float64):
    return cast(jax_nominal(jax_liquid() if motor == "liquid" else jax_solid()), dtype)


def port(obj, dtype=None):
    """A JAX scene or initial conditions on the port's side."""
    if hasattr(obj, "rocket"):
        return scene_from_numpy(obj, "cpu", dtype)
    return ic_from_numpy(obj, "cpu", dtype)


def flat(obj, path=""):
    """(path, array) for every leaf of a port result, in the JAX package's
    flattening order: dataclass fields in order, dict keys sorted."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from flat(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from flat(obj[k], f"{path}[{k!r}]")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from flat(x, f"{path}[{i}]")
    else:
        yield path, obj.detach().cpu().numpy()


def assert_close(ref, got, rtol, atol=None, what=""):
    """Every leaf of a port result against the JAX pytree of the same
    structure: floats at ``rtol``/``atol`` (``rtol`` by default), integers
    and flags exact, NaN meeting NaN."""
    ref_l = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_l = list(flat(got))
    assert len(ref_l) == len(got_l), (what, len(ref_l), len(got_l))
    for (path, a), (gpath, b) in zip(ref_l, got_l):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, gpath, a.shape, b.shape,
                                                            a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol if atol is None else atol,
                                       err_msg=f"{what}{gpath}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}{gpath}")


# ------------------------------------------------------------------ ops

def op_inputs(name, rng, n=64):
    """Random inputs of each op, with the degenerate points of its masks."""
    v3 = rng.normal(scale=100.0, size=(n, 3))
    v3[:4] = [[0.0, 0.0, 0.0], [0.0, 5.0, 0.0], [1e-7, 3.0, -1e-7], [1e-7, 0.0, 2e-7]]
    q = rng.normal(size=(n, 4)) * rng.uniform(0.9, 1.1, size=(n, 1))
    R = rng.normal(size=(n, 3, 3))
    return {
        "safe_norm": (v3,),
        "quaternion_multiply": (q, rng.normal(size=(n, 4))),
        "quaternion_to_rotation_matrix": (q,),
        "rotate_by_matrix": (R, v3),
        "rotate_by_matrix_t": (R, v3),
        "angular_velocity_to_quaternion_rate": (rng.normal(size=(n, 3)), q),
        "mach_number": (v3, rng.uniform(180.0, 300.0, size=n)),
        "angle_of_attack": (v3,),
        "sideslip_angle": (v3,),
        "wind_to_body_matrix": (rng.uniform(-1.6, 1.6, size=n), rng.uniform(-1.6, 1.6, size=n)),
    }[name]


OPS = ("safe_norm", "quaternion_multiply", "quaternion_to_rotation_matrix",
       "rotate_by_matrix", "rotate_by_matrix_t", "angular_velocity_to_quaternion_rate",
       "mach_number", "angle_of_attack", "sideslip_angle", "wind_to_body_matrix")


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax(name, dtype):
    args = [a.astype(dtype) for a in op_inputs(name, np.random.default_rng(len(name)))]
    jax_fn = getattr(jops.math if name == "safe_norm" else jops, name)
    ref = np.asarray(jax_fn(*map(jnp.asarray, args)))
    got = getattr(pops, name)(*map(torch.from_numpy, args)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=OP_BARS[dtype], atol=OP_BARS[dtype])


# ------------------------------------------------------------------ the right-hand side

def random_wind(rng, dtype=jnp.float64):
    alts = np.linspace(0.0, 30000.0, 16)
    return JaxWind(altitudes=jnp.asarray(alts, dtype),
                   wind=jnp.asarray(rng.normal(scale=8.0, size=(16, 3)), dtype))


def random_states(rng, n=64):
    """A ``FlightState`` of ``n`` lanes as numpy arrays: every phase of a
    flight, the first 16 lanes low (half of them descending), quaternions
    off unit norm by up to 2%, propellant fractions below 0 too."""
    pos = np.column_stack([rng.normal(scale=500.0, size=(n, 2)),
                           rng.uniform(0.0, 40000.0, size=n)])
    pos[:16, 2] = rng.uniform(0.0, 400.0, size=16)
    vel = rng.normal(scale=200.0, size=(n, 3))
    vel[:8, 2] = -np.abs(vel[:8, 2])
    q = rng.normal(size=(n, 4))
    q *= rng.uniform(0.98, 1.02, size=(n, 1)) / np.linalg.norm(q, axis=1, keepdims=True)
    return {"position": pos, "velocity": vel, "quaternion": q,
            "angular_velocity": rng.normal(scale=0.5, size=(n, 3)),
            "propellant_fraction": rng.uniform(-0.1, 1.0, size=n)}


@pytest.mark.parametrize("latch", [False, True], ids=["latch-off", "latch-on"])
@pytest.mark.parametrize("motor", ["liquid", "solid"])
def test_rocket_dynamics_matches_jax(motor, latch):
    """64 random states on the nominal scene with a random wind table (and,
    on the liquid scene, the energy-consistent aerodynamics too), the latch
    set or clear (it must come out set where the state is low and
    descending)."""
    rng = np.random.default_rng(64 + 2 * latch + (motor == "solid"))
    scene = jax_scene(motor).replace(wind=random_wind(rng))
    s = random_states(rng)
    t = rng.uniform(0.0, 1.2 * float(scene.motor.burn_time), size=64)
    para = np.full(64, latch)
    cfgs = [je.SimConfig()] + [je.SimConfig(energy_consistent_aero=True)] * (motor == "liquid")
    for cfg in cfgs:
        ref = jax.jit(je.rocket_dynamics, static_argnums=1)(
            scene, cfg, jnp.asarray(t), je.FlightState(**jax.tree.map(jnp.asarray, s)),
            jnp.asarray(para))
        got = pe.rocket_dynamics(port(scene), pe.SimConfig(**dataclasses.asdict(cfg)),
                                 torch.from_numpy(t), state_from_numpy(s, "cpu"),
                                 torch.from_numpy(para))
        assert_close(ref, got, STEP_BAR, what=f"{cfg.energy_consistent_aero}")
    assert latch or bool(np.asarray(ref[1]).any() & ~np.asarray(ref[1]).all())


# ------------------------------------------------------------------ RK4 and the events

def event_lanes(rng):
    """8 lanes as numpy arrays (a state, rail times, and event overrides),
    each set up for an event within 50 steps: boost; apogee detection; the
    coast timeout above 25 km (apogee detected 119.9 s before); the
    ground; the 100 km cut; a non-finite vertical velocity (a NaN the speed
    alone would not show: ``safe_norm`` maps it to 0); the chute latch; a
    lane stopped already (``advance`` steps it all the same)."""
    n = 8
    pos = np.array([[0.3, 0.0, 30.0], [10.0, 5.0, 1500.0], [50.0, 0.0, 30000.0],
                    [80.0, 20.0, 1.0], [0.0, 0.0, 99990.0], [0.0, 0.0, 5000.0],
                    [100.0, 0.0, 450.0], [0.0, 0.0, 2000.0]])
    vel = np.array([[0.8, 0.0, 42.0], [20.0, 1.0, 0.5], [30.0, 0.0, 3.0],
                    [2.0, 0.5, -8.0], [0.0, 0.0, 400.0], [0.0, 0.0, np.nan],
                    [3.0, 0.0, -20.0], [0.0, 0.0, -30.0]])
    q = rng.normal(size=(n, 4))
    q[:, 0] += 3.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = {"position": pos, "velocity": vel, "quaternion": q,
             "angular_velocity": rng.normal(scale=0.2, size=(n, 3)),
             "propellant_fraction": np.array([0.9, 0.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.0])}
    rail_time = np.full(n, 0.87)
    lane = np.arange(n)
    events = {"apogee_detected": lane == 2, "apogee_time": np.where(lane == 2, -119.0, 0.0),
              "max_coast_time": np.where(lane == 2, 120.0, 0.0), "done": lane == 7}
    return state, rail_time, events


def test_rk4_step_and_advance_match_jax():
    """``init_carry`` of ``event_lanes`` against JAX's; then, from JAX's
    carry carried across (``carry_from_numpy``), 50 ``advance`` steps on the
    nominal liquid scene with a random wind, every step held to JAX's (its
    first state and latch to the port's ``rk4_step``): every float at 1e-9,
    every event flag and step count exact, each event where it was set up."""
    rng = np.random.default_rng(50)
    scene = jax_scene("liquid").replace(wind=random_wind(rng))
    state, rail_time, events = event_lanes(rng)
    cfg, pcfg = je.SimConfig(), pe.SimConfig()

    def jax_run(scene, state, rail_time, events):
        c = je.init_carry(state, rail_time)
        c = c.replace(events=c.events.replace(**events))
        return c, jax.lax.scan(lambda c, _: (je.advance(scene, cfg, c),) * 2, c, length=50)[1]

    c0, steps = jax.jit(jax_run)(scene, je.FlightState(**jax.tree.map(jnp.asarray, state)),
                                 jnp.asarray(rail_time), jax.tree.map(jnp.asarray, events))
    pscene = port(scene)
    c = pe.init_carry(state_from_numpy(state, "cpu"), torch.from_numpy(rail_time))
    c = dataclasses.replace(c, events=dataclasses.replace(
        c.events, **{k: torch.from_numpy(v) for k, v in events.items()}))
    assert_close(c0, c, STEP_BAR, what="init_carry")
    # the first step's state and latch are rk4_step's at t = rail_time
    # from here on, JAX's carry carried across
    got = carry_from_numpy(c0, "cpu")
    one = pe.rk4_step(pscene, pcfg, got.rail_time, got.state, got.events.parachute_deployed)
    assert_close((jax.tree.map(lambda x: x[0], steps.state),
                  steps.events.parachute_deployed[0]), one, STEP_BAR, what="rk4_step")
    for k in range(50):
        got = pe.advance(pscene, pcfg, got)
        assert_close(jax.tree.map(lambda x: x[k], steps), got, STEP_BAR, what=f"step {k + 1}")
    ev = got.events
    assert ev.apogee_detected[1] and ev.done[2] and ev.done[3] and ev.done[4]
    assert ev.diverged[5] and ev.parachute_deployed[6] and not ev.done[0]
    assert (got.step == 50).all()


# ------------------------------------------------------------------ the rail

@pytest.fixture(scope="module")
def dispersed():
    """8 lanes of the liquid scene (float64) dispersed with numpy: thrust
    scale, dry mass and launch attitude per lane, each lane its own wind
    table on a shared 16-knot grid; and the same with lane ``NAN_LANE``'s
    table NaN above 2 km."""
    rng = np.random.default_rng(8)
    base = jax_scene("liquid").replace(wind=random_wind(rng))
    n = N_LANES
    table = rng.normal(scale=4.0, size=(n, 16, 3))
    scene = base.replace(
        motor=base.motor.replace(thrust_scale=jnp.asarray(rng.normal(1.0, 0.03, size=n))),
        rocket=base.rocket.replace(
            dry_mass=jnp.asarray(float(base.rocket.dry_mass) * rng.uniform(0.98, 1.02, n))),
        wind=base.wind.replace(wind=jnp.asarray(table)))
    ic = je.InitialConditions.vertical_launch(dtype=jnp.float64)
    attitude = np.asarray(ic.attitude) + np.column_stack(
        [np.zeros(n), rng.normal(scale=0.01, size=n), rng.normal(scale=0.02, size=n)])
    ic_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (n, 3)), ic).replace(
        attitude=jnp.asarray(attitude))
    table = table.copy()  # the scene's table may share this buffer
    table[NAN_LANE, np.asarray(base.wind.altitudes) > 2000.0, :] = np.nan
    nan_b = scene.replace(wind=scene.wind.replace(wind=jnp.asarray(table)))
    return base, scene, nan_b, ic_b


@pytest.mark.parametrize("case", ["liquid", "solid", "dispersed"])
def test_rail_matches_jax(case, dispersed):
    """The port's ``simulate_rail`` and ``simulate_rail_masked`` against the
    JAX package's ``simulate_rail`` on a nominal scene and its
    ``simulate_rail_masked`` on the dispersed lanes (its ``vmap`` of
    ``simulate_rail`` there is the batched flight's, in
    ``test_batched_summary_matches_jax``), and the two port functions
    against each other bit for bit."""
    cfg = je.SimConfig()
    if case == "dispersed":
        _, scene, _, ic = dispersed
        ref = jax_rail_masked(scene, cfg, je.initial_state(ic))
    else:
        scene = jax_scene(case)
        ic = je.InitialConditions.vertical_launch(dtype=jnp.float64)
        ref = je.simulate_rail(scene, cfg, je.initial_state(ic))
    state0 = pe.initial_state(port(ic))
    got = pe.simulate_rail(port(scene), pe.SimConfig(), state0)
    got_masked = simulate_rail_masked(port(scene), pe.SimConfig(), state0)
    assert_close(ref, got, FLIGHT_BARS[jnp.float64], atol=1e-6, what="simulate_rail")
    assert_close(ref, got_masked, FLIGHT_BARS[jnp.float64], atol=1e-6,
                 what="simulate_rail_masked")
    for (_, a), (_, b) in zip(flat(got), flat(got_masked)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ whole flights

MOTORS = ("liquid", "solid")
DTYPES = (jnp.float64, jnp.float32)
STRIDES = (1, 4)


@pytest.fixture(scope="module", autouse=True)
def jax_flights(dispersed):
    """The JAX package's flights the tests below hold the port to, as numpy
    results: ``jax.jit(simulate_summary)`` of each nominal scene in each
    precision, ``jax.vmap(simulate_summary)`` of the dispersed lanes with
    the NaN-wind lane, and ``jax.jit(simulate_flight)`` of the liquid scene
    (stride 1). Most of each is XLA's compile, so they run in threads from
    the module's first test on, beside the tests' eager flights."""
    base, _, scene, ic = dispersed
    jobs = {(motor, dtype): (lambda m=motor, d=dtype: jax.jit(
        je.simulate_summary, static_argnums=2)(jax_scene(m, d),
                                               je.InitialConditions.vertical_launch(dtype=d),
                                               je.SimConfig(max_time=WINDOW[m])))
            for motor in MOTORS for dtype in DTYPES}
    jobs["batched"] = lambda: jax.jit(
        jax.vmap(je.simulate_summary, in_axes=(scene_in_axes(base, scene), 0, None)),
        static_argnums=2)(scene, ic, je.SimConfig(max_time=WINDOW["liquid"]))
    jobs["flight"] = lambda: jax.jit(je.simulate_flight, static_argnums=2)(
        jax_scene("liquid"), je.InitialConditions.vertical_launch(dtype=jnp.float64),
        je.SimConfig(max_time=WINDOW["liquid"]))
    with ThreadPoolExecutor(3) as ex:
        yield {k: ex.submit(lambda f=f: jax.tree.map(np.asarray, f())) for k, f in jobs.items()}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("motor", MOTORS)
def test_summary_matches_jax(motor, dtype, jax_flights):
    """One unbatched flight of the nominal scene over the window against
    ``jax.jit(simulate_summary)``; on CPU tensors no kernel is launched."""
    before = fs.launches
    got = pe.simulate_summary(port(jax_scene(motor, dtype)),
                              port(je.InitialConditions.vertical_launch(dtype=dtype)),
                              pe.SimConfig(max_time=WINDOW[motor]))
    assert fs.launches == before
    compare(jax_flights[motor, dtype].result(), to_numpy(got), FLIGHT_BARS[dtype])
    assert int(got.n_steps) > 60


@pytest.fixture(scope="module")
def batched(dispersed, jax_flights):
    """The dispersed lanes with the NaN-wind lane through
    ``jax.vmap(simulate_summary)`` and the port's stacked ``simulate_summary``."""
    _, _, scene, ic = dispersed
    got = pe.simulate_summary(port(scene), port(ic), pe.SimConfig(max_time=WINDOW["liquid"]))
    return jax_flights["batched"].result(), to_numpy(got)


def test_batched_summary_matches_jax(batched):
    """A NaN anywhere in a lane's wind table poisons that lane's wind at any
    altitude (the tent sum): both packages stop it diverged at the same
    step, and no other lane."""
    ref, got = batched
    compare(ref, got, FLIGHT_BARS[jnp.float64])
    assert got.diverged[NAN_LANE] and not np.delete(got.diverged, NAN_LANE).any()


def test_stacked_matches_summary_batch(dispersed, batched):
    """The stacked plain version against the port's component path on the
    same lanes, at tests/test_batch.py's bars: the CPU twin of chip_smoke's
    K1-against-stacked phase. The NaN-wind lane stops at the same step in
    both; its ``max_speed`` is the one leaf the two engines form apart, as
    the JAX package's two do: the stacked engine's ``safe_norm`` maps a NaN
    speed to 0, the component core's ``safe_sqrt`` keeps it NaN."""
    _, _, scene, ic = dispersed
    got = to_numpy(pe.simulate_summary_batch(port(scene), port(ic),
                                             pe.SimConfig(max_time=WINDOW["liquid"])))
    stacked = batched[1]
    assert stacked.max_speed[NAN_LANE] == 0.0 and np.isnan(got.max_speed[NAN_LANE])
    got.max_speed[NAN_LANE] = 0.0
    compare(stacked, got, FLIGHT_BARS[jnp.float64])


@pytest.fixture(scope="module")
def flights(jax_flights):
    """JAX's stride-1 recording of the nominal liquid scene over the window,
    with ``record_derived``, and the port's ``simulate_flight`` at each of
    ``STRIDES``."""
    got = {k: pe.simulate_flight(port(jax_scene("liquid")),
                                 pe.InitialConditions.vertical_launch("cpu"),
                                 pe.SimConfig(max_time=WINDOW["liquid"], record_stride=k))
           for k in STRIDES}
    return jax_flights["flight"].result(), got


def strided(traj, stride):
    """JAX's stride-1 recording as its recorder records every ``stride``-th
    step: frame k is the state after k*stride masked steps (the stopped
    state past the stop), valid where the block's first step ran."""
    take = lambda x: x[::stride]
    out = jax.tree.map(take, traj)
    valid = np.concatenate([traj.valid[:1], traj.valid[1::stride]])
    return out.replace(valid=valid)


@pytest.mark.parametrize("stride", STRIDES)
def test_flight_matches_jax(stride, flights):
    """``simulate_flight`` with ``record_derived`` against JAX's
    ``simulate_flight``: the summary, every frame and ``valid`` (the frames
    past the stop repeat the stopped state), derived channels at
    tests/test_trajectory_batch.py's bars. Stride 4 is held to JAX's stride-1
    recording as a stride-4 recording reads it (``strided``): the flight
    stops 66 steps in, long before the last frame of either."""
    (ref_s, ref_t), got = flights
    ref_t = strided(ref_t, stride)
    cfg = pe.SimConfig(max_time=WINDOW["liquid"], record_stride=stride)
    got_s, got_t = got[stride]
    compare(ref_s, to_numpy(got_s), FLIGHT_BARS[jnp.float64])
    assert got_t.time.shape == ref_t.time.shape == (-(-cfg.max_steps // stride) + 1,)
    state = ("time", "position", "velocity", "quaternion", "angular_velocity",
             "propellant_fraction")
    assert_close({k: getattr(ref_t, k) for k in state},
                 {k: getattr(got_t, k) for k in state}, FLIGHT_BARS[jnp.float64],
                 atol=1e-6, what="frames")
    np.testing.assert_array_equal(got_t.valid.numpy(), ref_t.valid)
    assert 1 < int(got_t.valid.sum()) < got_t.valid.numel()
    assert set(got_t.derived) == set(ref_t.derived)
    assert_close(dict(ref_t.derived), got_t.derived, 1e-6, what="derived")


@pytest.mark.parametrize("entry,lanes", [("simulate_summary", "single"),
                                         ("simulate_flight", "single"),
                                         ("simulate_flight", "batched"),
                                         ("simulate_summary", "batched")])
def test_card_route_matches_the_stacked_engine(entry, lanes, dispersed, monkeypatch):
    """The card route's plumbing, run here on CPU tensors: ``engine.batch``
    (whose CPU route is the component core's plain version), a single
    flight lifted to one lane and squeezed back, equal to the stacked plain
    version at tests/test_batch.py's bars; recorded, every frame, ``valid``
    and every derived channel, also for the dispersed lanes' ``[B, T]``
    layout. The dispersed lanes hold the NaN-wind lane: the card route
    forms the speeds as the stacked engine does (the kernel's
    ``stacked_speed`` builds), so that lane's ``max_speed`` is 0 there
    too."""
    monkeypatch.setattr(psim, "_on_card", lambda ic: True)
    if lanes == "single":
        scene = port(jax_scene("liquid"))
        ic = pe.InitialConditions.vertical_launch("cpu")
    else:
        scene, ic = port(dispersed[2]), port(dispersed[3])
    cfg = pe.SimConfig(max_time=1.0, record_stride=4)
    got = getattr(pe, entry)(scene, ic, cfg)
    want = getattr(psim, f"{entry}_reference")(scene, ic, cfg)
    if entry == "simulate_summary":
        got, want = (got,), (want,)
    compare(to_numpy(want[0]), to_numpy(got[0]), FLIGHT_BARS[jnp.float64])
    if lanes == "batched":
        assert got[0].diverged[NAN_LANE] and float(got[0].max_speed[NAN_LANE]) == 0.0
    if entry == "simulate_flight":
        g, w = to_numpy(got[1]), to_numpy(want[1])
        assert set(g.derived) == set(w.derived)
        for (path, a), (_, b) in zip(leaves(w), leaves(g)):
            assert a.shape == b.shape, path
        np.testing.assert_array_equal(g.valid, w.valid)
        for k in ("time", "position", "velocity", "quaternion", "angular_velocity",
                  "propellant_fraction"):
            np.testing.assert_allclose(getattr(g, k), getattr(w, k), rtol=5e-7, atol=1e-6,
                                       err_msg=k)
        for k in w.derived:
            np.testing.assert_allclose(g.derived[k], w.derived[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("entry", ["simulate_summary", "simulate_flight"])
def test_descent_dt_scale_is_refused(entry):
    """The tiered timestep is the component path's, as in the JAX package:
    each entry point refuses it, naming the port's
    ``simulate_summary_batch``, before any flight."""
    scene = port(jax_scene("liquid"))
    ic = pe.InitialConditions.vertical_launch("cpu")
    with pytest.raises(ValueError, match="engine.simulate_summary_batch"):
        getattr(pe, entry)(scene, ic, pe.SimConfig(descent_dt_scale=4))
    with pytest.raises(ValueError, match="descent_dt_scale"):
        je.simulate_summary(jax_scene("liquid"), je.InitialConditions.vertical_launch(),
                            je.SimConfig(descent_dt_scale=4))


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("entry", ["simulate_summary", "simulate_flight"])
def test_rk2_and_bf16_table_are_ignored(entry, route, monkeypatch):
    """``integrator`` and ``wind_table_bf16`` are not read by the JAX
    package's stacked path: both routes accept them and fly RK4 on the
    table as given, so the card's kernel, which would honour them, is given
    ``integrator="rk4"`` and ``wind_table_bf16=False`` (and the stacked
    engine's speed, ``_stacked_speed``)."""
    seen, options = [], []

    class Flown(Exception):
        pass

    def capture(scene, ic, cfg, **kw):
        seen.append(cfg)
        options.append(kw)
        raise Flown

    if route == "card":
        monkeypatch.setattr(psim, "_on_card", lambda ic: True)
        monkeypatch.setattr(pbatch, f"{entry}_batch", capture)
    else:
        monkeypatch.setattr(psim, f"{entry}_reference", capture)
    scene = port(jax_scene("liquid"))
    ic = pe.InitialConditions.vertical_launch("cpu")
    cfg = pe.SimConfig(max_time=1.0, integrator="rk2", wind_table_bf16=True)
    with pytest.raises(Flown):
        getattr(pe, entry)(scene, ic, cfg)
    assert seen == [dataclasses.replace(cfg, integrator="rk4", wind_table_bf16=False)]
    assert options == [{"_stacked_speed": True} if route == "card" else {}]