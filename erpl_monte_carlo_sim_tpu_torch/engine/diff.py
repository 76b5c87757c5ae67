"""The differentiable flight (``erpl_monte_carlo_sim_tpu/engine/diff.py``).

Gradients of a flight's metrics through the whole 6DOF integration, by
PyTorch autograd over the port's own eager core: ``flight_setup`` runs the
rail phase and ``main_loop``'s ``step`` runs the main loop, the same
closures that fly the summaries, so there is no other copy of the dynamics.
The metrics are the running extrema (the step that sets ``max_alt``
through ``where``, ``max_spd`` through ``maximum``, gets the gradient) and
the landing estimates of a quadratic backtrack to the ground crossing.

The main loop runs in segments of ``SEGMENT_STEPS`` steps, and stops once no lane
runs (a finished lane is held by ``where`` and changes no more), or after
``n_steps`` steps. The JAX package scans ``n_steps`` masked steps; its
extra steps leave every value as it was and pass the gradient through
unchanged, so the port's value and gradient equal JAX's wherever JAX's are
finite (its masked steps can turn a frozen lane's gradient into NaN, which
the early stop does not).

How a segment is differentiated depends on where the tensors lie:
- CPU (and ``metrics_reference`` on any device): eager autograd, each
  segment under ``torch.utils.checkpoint`` (``use_reentrant=False``), so the
  backward pass recomputes a segment's steps instead of keeping them.
- CUDA: each segment is a ``torch.autograd.Function`` that replays CUDA
  graphs (``_Graphs``): its forward replays ``SEGMENT_STEPS`` captured no-grad
  steps and saves only the segment's inputs; its backward replays a captured
  recomputation of the segment with grad and its vector-Jacobian product
  (``torch.autograd.grad`` under ``torch.cuda.graph``). The scene's tensors
  are inputs of every segment, so their gradients add up across segments.
  A segment shorter than that (``n_steps`` not a multiple) runs
  eager. Eager autograd on the card (``metrics_reference``) is its oracle.

``metric_and_grad`` differentiates one metric with respect to one dotted
scene field; ``line_search_ascent`` is the scalar optimizer both
``cli.optimize_apogee`` and ``mc.robust`` ride.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch.utils.checkpoint import checkpoint

from ..models.rocket import refresh_derived
from ..utils.tree import tree_map
from .component import (_capture, _packing, dynamics_c, flight_setup, main_loop,
                        table_wind_fn)
from .config import SimConfig

__all__ = ["DIFF_METRICS", "simulate_metrics_diff", "metrics_reference", "gradients",
           "simulate_apogee_diff", "metric_and_grad", "apogee_and_grad",
           "AscentHistory", "line_search_ascent"]

# the differentiable metrics of simulate_metrics_diff
DIFF_METRICS = ("apogee_altitude", "range", "flight_time", "landing_x", "landing_y",
                "max_speed")

# main-loop steps a segment runs
SEGMENT_STEPS = 16

# host seconds spent capturing segments' CUDA graphs (warm-ups included),
# so that a run can tell the capture, paid once a flight, from the replays
capture_seconds = 0.0


def _leaves(tree) -> list:
    """The tensor leaves of a parameter dataclass, in ``tree_map`` order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def _rebuilt(tree, leaves):
    """``tree`` with its tensor leaves replaced, in ``tree_map`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def gradients(out: torch.Tensor, inputs: list) -> list:
    """``torch.autograd.grad(out, inputs)`` with zeros where ``out`` does not
    depend on an input (a window that ends on the rail, a metric no input
    reaches), as ``jax.grad`` gives them."""
    if not out.requires_grad:
        return [torch.zeros_like(x) for x in inputs]
    grads = torch.autograd.grad(out, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def _eager_loop(step, st, ev, run, n_steps: int):
    """The main loop on eager autograd: segments of ``SEGMENT_STEPS`` steps,
    each under ``torch.utils.checkpoint`` when grad is on, until no lane
    runs or ``n_steps`` steps."""
    pack, unpack = _packing()

    def run_steps(k, *flat):
        st, ev, (run,) = unpack(flat)
        for _ in range(k):
            st, ev, run = step(st, ev, run)
        return pack(st, ev, run)

    done = 0
    while done < n_steps and bool(run.any()):
        k = min(SEGMENT_STEPS, n_steps - done)
        flat = pack(st, ev, run)
        if torch.is_grad_enabled():
            out = checkpoint(run_steps, k, *flat, use_reentrant=False)
        else:
            out = run_steps(k, *flat)
        st, ev, (run,) = unpack(out)
        done += k
    return st, ev


class _Graphs:
    """One segment of ``steps`` main-loop steps captured as CUDA graphs over
    static tensors: ``forward`` (no grad, the carry replaced in place) and,
    when ``with_backward``, ``backward`` (the segment recomputed from leaf
    copies of its inputs with grad, then ``torch.autograd.grad`` of its
    float outputs against static cotangents, for the float inputs and the
    ``params`` that need a gradient). ``params`` are detached views of the
    tensors the step reads (the scene's leaves and the wind table), so they
    hold this flight's values; ``make_step(params)`` builds the step over
    them."""

    def __init__(self, make_step, params: list, carry: tuple, steps: int, packing,
                 with_backward: bool):
        pack, unpack = packing
        self.is_float = [c.is_floating_point() for c in carry]
        self.wanted = [p for p in params if p.requires_grad]
        step = make_step(params)

        def segment(c):
            st, ev, (run,) = unpack(c)
            for _ in range(steps):
                st, ev, run = step(st, ev, run)
            return pack(st, ev, run)

        with torch.no_grad():
            self.fwd_graph, self.fwd_carry = _capture(segment, carry)
        if not with_backward:
            return
        self.bwd_in = tuple(c.detach().clone().requires_grad_(f)
                            for c, f in zip(carry, self.is_float))
        self.cot = [torch.zeros_like(c) if f else None for c, f in zip(carry, self.is_float)]

        def vjp():
            with torch.enable_grad():
                out = segment(self.bwd_in)
                keep = [i for i, c in enumerate(out) if self.is_float[i] and c.requires_grad]
                inputs = [c for c, f in zip(self.bwd_in, self.is_float) if f] + self.wanted
                grads = torch.autograd.grad([out[i] for i in keep], inputs,
                                            [self.cot[i] for i in keep], allow_unused=True)
            return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]

        # a warm-up on a side stream first, as _capture does
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            vjp()
        torch.cuda.current_stream().wait_stream(side)
        self.bwd_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bwd_graph):
            self.bwd_out = vjp()

    def forward(self, carry) -> tuple:
        with torch.no_grad():
            for s, c in zip(self.fwd_carry, carry):
                s.copy_(c)
        self.fwd_graph.replay()
        return tuple(c.clone() for c in self.fwd_carry)

    def backward(self, carry, cots) -> tuple:
        """``(carry grads, params grads)`` of the segment from ``carry``
        against the cotangents ``cots`` of its outputs."""
        with torch.no_grad():
            for s, c in zip(self.bwd_in, carry):
                s.copy_(c)
            for s, g in zip(self.cot, cots):
                if s is not None:
                    s.zero_() if g is None else s.copy_(g)
        self.bwd_graph.replay()
        grads = [g.clone() for g in self.bwd_out]
        n_float = sum(self.is_float)
        it = iter(grads[:n_float])
        return [next(it) if f else None for f in self.is_float], grads[n_float:]


class _Segment(torch.autograd.Function):
    """A graphed segment as one autograd node: inputs ``(graphs, n_carry,
    *carry, *leaves)``, outputs the carry after the segment. ``leaves`` are
    the caller's tensors behind the graphs' ``params``: they receive the
    parameter gradients, which autograd adds up over the segments."""

    @staticmethod
    def forward(ctx, graphs, n_carry, *tensors):
        carry = tensors[:n_carry]
        ctx.graphs = graphs
        ctx.wanted = ctx.needs_input_grad[2 + n_carry:]
        ctx.save_for_backward(*carry)
        out = graphs.forward(carry)
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return out

    @staticmethod
    def backward(ctx, *cots):
        carry_grads, param_grads = ctx.graphs.backward(ctx.saved_tensors, cots)
        it = iter(param_grads)
        return (None, None, *carry_grads, *[next(it) if w else None for w in ctx.wanted])


def _graphed_loop(make_step, views: list, leaves: list, step, st, ev, run, n_steps: int):
    """The main loop on a CUDA device: whole segments through ``_Segment``
    (captured once a flight), a last partial segment eager. ``views`` feed
    the graphs; ``leaves`` are the tensors they stand for."""
    packing = _packing()
    pack, unpack = packing
    need_grad = torch.is_grad_enabled() and any(x.requires_grad for x in views)
    done, graphs = 0, None
    while done < n_steps and bool(run.any()):
        if n_steps - done < SEGMENT_STEPS:
            return _eager_loop(step, st, ev, run, n_steps - done)
        flat = pack(st, ev, run)
        if graphs is None:
            global capture_seconds
            t0 = time.perf_counter()
            need = need_grad or any(x.requires_grad for x in flat)
            graphs = _Graphs(make_step, views, flat, SEGMENT_STEPS, packing, need)
            capture_seconds += time.perf_counter() - t0
        out = _Segment.apply(graphs, len(flat), *flat, *leaves)
        st, ev, (run,) = unpack(out)
        done += SEGMENT_STEPS
    return st, ev


def _split_ic(ic, dtype):
    """12 ``[B]`` initial-condition tensors of ``ic`` (``[3]`` or ``[B,
    3]`` leaves) in ``dtype``, and whether ``ic`` was a single flight."""
    single = ic.position.ndim == 1
    ics = tuple((arr[None] if single else arr)[:, c].to(dtype)
                for arr in (ic.position, ic.velocity, ic.attitude, ic.angular_velocity)
                for c in range(3))
    return ics, single


def _metrics(scene, ic, cfg: SimConfig, n_steps, rail_steps: int, graphed: bool) -> dict:
    if n_steps is None:
        n_steps = cfg.max_steps
    dtype = ic.position.dtype
    ics, single = _split_ic(ic, dtype)
    wind = scene.wind
    scene_nw = tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                        dataclasses.replace(scene, wind=None))
    grid, table = wind.altitudes.to(dtype), wind.wind.to(dtype)
    wind_fn = table_wind_fn(grid, table)
    st, ev, core = flight_setup(scene_nw, cfg, wind_fn, ics, rail_steps=rail_steps)
    run = core.lane_active(ev)
    if graphed:
        # the tensors every step reads, as detached views: a segment's
        # graphs read them, and _Segment routes their gradients back
        leaves = _leaves(scene_nw) + [grid, table]
        views = [x.detach().requires_grad_(x.requires_grad and x.is_floating_point())
                 for x in leaves]

        def make_step(ps):
            return main_loop(_rebuilt(scene_nw, ps[:-2]), cfg, table_wind_fn(ps[-2], ps[-1]),
                             core.rail_time)[2]

        st, ev = _graphed_loop(make_step, views, leaves, core.step, st, ev, run, n_steps)
    else:
        st, ev = _eager_loop(core.step, st, ev, run, n_steps)
    res = core.summarize(st, ev)

    # quadratic backtrack to the ground crossing: one evaluation of the
    # dynamics at the frozen state, one Newton step on the quadratic model
    # of the altitude (the crossing's seams in the parameter become O(dt^3))
    deriv, _ = dynamics_c(scene_nw, cfg, wind_fn, core.time_of(ev), st, ev["para"])
    ax, ay, az = deriv[3], deriv[4], deriv[5]
    fpx, fpy, fpz = res["final_px"], res["final_py"], res["final_pz"]
    fvx, fvy, fvz = res["final_vx"], res["final_vy"], res["final_vz"]
    ground = cfg.ground_altitude
    landed = (fpz <= ground) & (fvz < 0.0)
    d0 = (ground - fpz) / torch.where(landed, fvz, -1.0)
    z_d0 = fpz + fvz * d0 + 0.5 * az * d0 * d0
    slope = torch.where(landed, fvz + az * d0, -1.0)
    slope = torch.where(torch.abs(slope) > 1e-6, slope, -1.0)
    delta = torch.where(landed, d0 - (z_d0 - ground) / slope, 0.0)
    land_x = fpx + fvx * delta + 0.5 * ax * delta * delta
    land_y = fpy + fvy * delta + 0.5 * ay * delta * delta
    rng_sq = land_x * land_x + land_y * land_y
    ok = rng_sq > 0.0
    rng = torch.where(ok, torch.sqrt(torch.where(ok, rng_sq, 1.0)), 0.0)
    out = {"apogee_altitude": res["apogee_altitude"], "range": rng,
           "flight_time": res["flight_time"] + delta, "landing_x": land_x,
           "landing_y": land_y, "max_speed": res["max_speed"]}
    return {k: v[0] for k, v in out.items()} if single else out


def simulate_metrics_diff(scene, ic, cfg: SimConfig = SimConfig(), n_steps: int | None = None,
                          rail_steps: int = 512) -> dict:
    """Every metric of ``DIFF_METRICS`` through one differentiable flight
    of ``scene`` (a single scene or a batch: ``[B]`` leaves, ``[B, N, 3]``
    wind) from ``ic`` (``[3]`` or ``[B, 3]`` leaves), in the dtype of
    ``ic``; a single flight gives 0-d metrics, a batch ``[B]``.

    The same physics as the summaries (masked events, the parachute latch,
    the frozen state after termination). ``apogee_altitude`` and
    ``max_speed`` are the running extrema, the summary's to the last bit.
    The landing metrics are differentiable ground-crossing estimates: the
    summary freezes a lane at a whole step, so the crossing is backtracked
    from the frozen state with one quadratic Newton step (``flight_time`` =
    end time + delta, ``landing_xy`` = the quadratic position at delta);
    lanes that do not land keep the frozen values. ``rail_steps`` caps the
    rail phase as the JAX package's fixed rail scan does; ``n_steps``
    (default ``cfg.max_steps``) caps the main loop, which also stops once
    no lane runs: value and gradient equal the JAX package's wherever its
    are finite. CPU tensors run eager autograd with checkpointed segments;
    CUDA tensors replay graphed segments (module docstring)."""
    return _metrics(scene, ic, cfg, n_steps, rail_steps, ic.position.is_cuda)


def metrics_reference(scene, ic, cfg: SimConfig = SimConfig(), n_steps: int | None = None,
                      rail_steps: int = 512) -> dict:
    """``simulate_metrics_diff`` on eager autograd (checkpointed segments)
    on any device: on a card, the oracle of the graphed segments."""
    return _metrics(scene, ic, cfg, n_steps, rail_steps, False)


def simulate_apogee_diff(scene, ic, cfg: SimConfig = SimConfig(), n_steps: int | None = None,
                         rail_steps: int = 512) -> torch.Tensor:
    """The apogee of ``simulate_metrics_diff`` (the running maximum: the
    gradient flows through the step that attains it)."""
    return simulate_metrics_diff(scene, ic, cfg, n_steps, rail_steps)["apogee_altitude"]


# rocket fields refresh_derived computes: a write to one of them sticks (a
# refresh would recompute it from the primaries and zero its gradient)
_DERIVED_ROCKET_FIELDS = frozenset({"cp_location", "reference_area", "reference_diameter"})


def _scene_accessors(wrt: str):
    """``(read, write)`` of the dotted scene field ``wrt`` (e.g.
    "motor.thrust_scale", "rocket.fin_span"). ``write(scene, v)`` returns
    the scene with the field set to ``v`` and, unless the field is one of
    the derived rocket fields, the rocket's derived geometry refreshed in
    tensors (``refresh_derived``), so a geometry gradient carries the CP
    travel."""
    parts = wrt.split(".")
    is_derived = parts[0] == "rocket" and len(parts) == 2 and parts[1] in _DERIVED_ROCKET_FIELDS

    def read(s):
        v = s
        for p in parts:
            v = getattr(v, p)
        v = torch.as_tensor(v)
        return v if v.is_floating_point() else v.to(torch.get_default_dtype())

    def write(s, v):
        objs = [s]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        child = dataclasses.replace(objs[-1], **{parts[-1]: v})
        for obj, p in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            child = dataclasses.replace(obj, **{p: child})
        if is_derived:
            return child
        return dataclasses.replace(child, rocket=refresh_derived(child.rocket))

    return read, write


def metric_and_grad(scene, ic, cfg: SimConfig = SimConfig(), metric: str = "apogee_altitude",
                    wrt: str = "motor.thrust_scale", **kw):
    """``(metric, d metric / d scene.<wrt>)`` of a single flight in one
    reverse pass. ``metric`` is one of ``DIFF_METRICS``; ``wrt`` a dotted
    scene field (``_scene_accessors``); ``kw`` go to
    ``simulate_metrics_diff``."""
    if metric not in DIFF_METRICS:
        raise ValueError(f"metric must be one of {DIFF_METRICS}, got {metric!r}")
    read, write = _scene_accessors(wrt)
    v = read(scene).detach().clone().requires_grad_(True)
    with torch.enable_grad():
        m = simulate_metrics_diff(write(scene, v), ic, cfg, **kw)[metric]
        (grad,) = gradients(m, [v])
    return m.detach(), grad


def apogee_and_grad(scene, ic, cfg: SimConfig = SimConfig(), wrt: str = "motor.thrust_scale",
                    **kw):
    """The apogee and d(apogee)/d(scene.<wrt>) in one reverse pass."""
    return metric_and_grad(scene, ic, cfg, metric="apogee_altitude", wrt=wrt, **kw)


class AscentHistory(list):
    """The per-evaluation history list, with an ``info`` dict:
    ``{"converged", "reason", "value", "objective", "grad", "n_evals"}``."""

    def __init__(self, *a):
        super().__init__(*a)
        self.info = {"converged": False, "reason": "max_evals", "value": float("nan"),
                     "objective": float("nan"), "grad": float("nan"), "n_evals": 0}


def line_search_ascent(evaluate, v0: float, steps: int, lr: float | None = None, *,
                       bounds: tuple | None = None, grad_tol: float = 0.0,
                       step_tol: float | None = None, grow: float = 2.0, shrink: float = 0.5,
                       c1: float = 1e-4):
    """Backtracking gradient ascent on one scalar parameter (host Python).

    ``evaluate(value) -> (history_entry, objective, grad)`` must be
    deterministic in ``value``. A move of ``step`` along the gradient's sign
    must pass the Armijo test ``f_new >= f + c1 |move| |g|``: accepted steps
    grow by ``grow`` (up to 32x the first), rejected ones shrink by
    ``shrink``; a non-finite trial rejects. The first step is ``lr``, or 2%
    of ``|v0|``. Stops on ``grad_tol`` (|grad| at an accepted point),
    ``step_tol`` (the step below it, default 1% of the first), ``bound`` (at
    a bound with the gradient pointing out), ``nonfinite_start`` or
    ``max_evals`` (``steps`` evaluations). Returns an ``AscentHistory``."""
    history = AscentHistory()
    budget = int(steps)
    if budget <= 0:
        return history
    lo, hi = bounds if bounds is not None else (-float("inf"), float("inf"))
    if lo > hi:
        raise ValueError(f"bounds lo > hi: {bounds}")

    def clip(x):
        return min(max(x, lo), hi)

    init_step = lr if lr is not None else 0.02 * max(abs(float(v0)), 1e-12)
    if init_step <= 0:
        raise ValueError("lr must be positive")
    tol = step_tol if step_tol is not None else 0.01 * init_step
    step = init_step
    max_step = 32.0 * init_step

    v = clip(float(v0))
    entry, f, g = evaluate(v)
    history.append(entry)
    f, g = float(f), float(g)
    n_evals = 1
    if not (math.isfinite(f) and math.isfinite(g)):
        # nothing to bracket around a start that was never finite
        history.info.update(converged=False, reason="nonfinite_start", value=v, objective=f,
                            grad=g, n_evals=1)
        return history
    reason, converged = "max_evals", False
    while n_evals < budget:
        if abs(g) <= grad_tol:
            reason, converged = "grad_tol", True
            break
        d = 1.0 if g > 0 else -1.0
        v_try = clip(v + d * step)
        if v_try == v:
            reason, converged = "bound", True
            break
        entry, f_try, g_try = evaluate(v_try)
        history.append(entry)
        f_try, g_try = float(f_try), float(g_try)
        n_evals += 1
        if f_try >= f + c1 * abs(v_try - v) * abs(g):  # a NaN trial fails here
            v, f, g = v_try, f_try, g_try
            step = min(step * grow, max_step)
        else:
            step *= shrink
            if step < tol:
                reason, converged = "step_tol", True
                break
    else:
        if abs(g) <= grad_tol:
            reason, converged = "grad_tol", True
    history.info.update(converged=converged, reason=reason, value=v, objective=f, grad=g,
                        n_evals=n_evals)
    return history
