"""The yardstick of the flight kernel (K1), frozen: its operation tables as
they stand in the port's ``kernels/flight_summary.py`` at commit 848e839,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W,
dense, outside the tensor cores: 67 TFLOP/s FP32, 34 TFLOP/s FP64, 3.35 TB/s
of HBM3). A peak counts a fused multiply-add as two operations.

``k1_bound_ms`` is the least time those flights could take on the card: the
larger of their operations (each main-loop step at ``ops_per_step`` of the
build the ``SimConfig`` selects, a coarse step counting one, plus each rail
step at ``OPS_PER_RAIL_STEP``) over the peak, and of the bytes every input
is read once and every output written once over the memory rate.
"""

from __future__ import annotations

__all__ = ["DYNAMICS_OPS", "RK4_OPS", "RAIL_OPS", "RK2_OPS", "ENERGY_AERO_OPS", "TIERED_OPS",
           "OPS_PER_RAIL_STEP", "PEAK_FLOPS", "PEAK_BYTES_PER_S", "ops_per_step",
           "k1_flags", "k1_ops", "k1_lane_bytes", "k1_bound_ms"]

DYNAMICS_OPS = {  # one evaluation of csrc/flight_summary.cu dynamics
    "propellant fraction: max(frac, 0)": 1,
    "normalize the quaternion: 4 squares, 3 adds, sqrt, 1/n, 4 scales": 13,
    "rotation matrix: a second normalize (13), 3 diagonal x 5, 6 others x 4": 52,
    "mass, cg, Ixx, Iyy (lane-constant parts hoisted)": 12,
    "troposphere: temperature 2, pressure (max, /, pow, *) 4, density 3, sound 2": 11,
    "wind: window 14, segment guess 2, 3 components x 3 knots x (*, +) 18": 34,
    "air-relative velocity 3, body frame 15, |v|^2 5, Mach (sqrt, /) 2": 25,
    "angle of attack and sideslip: 2 abs, 2 atan2, 3 + sqrt": 8,
    "dynamic pressure": 2,
    "aero: Mach window 14, cd0 and cda sums 12, cd 3, |alpha| 1, stall factor 4, "
    "sqrt|1-M^2| 4, k 2, denominator 4, cl_alpha 2, cl 1, CP window and sum "
    "20 + 1, margin 1, pitch 3, side 1, yaw 3": 76,
    "drag, lift, side force": 6,
    "sin and cos of alpha and beta": 4,
    "aero force in the body frame": 17,
    "pitch and yaw moments with damping": 8,
    "body force to the inertial frame": 15,
    "gravity at altitude": 4,
    "linear accelerations: 1/m, 3 scales, weight 2": 6,
    "angular accelerations (Izz := Iyy): 3 x 5": 15,
    "quaternion derivative 24, norm error 8, correction 12": 44,
}
RK4_OPS = {  # the rest of one main-loop step
    "stage times": 2,
    "three stage inputs: 14 x (*, +) each": 84,
    "combine: 14 x (2*k2, 2*k3, 3 adds, *dt/6, +s)": 98,
    "renormalize the quaternion": 13,
    "events: step time (fused, 2), speed 6, max speed 1, coast time 1": 10,
}
RAIL_OPS = {  # one forward-Euler rail step
    "time": 1,
    "mass properties": 12,
    "troposphere": 11,
    "wind": 34,
    "air-relative velocity 6, axial speed 5, Mach 7": 18,
    "Mach window and cd0, cda sums 26, cd 3, drag 5": 34,
    "thrust on a 2-knot curve (clamp 2, 2 knots x (2 -, /, clip 2, *, +)), "
    "nozzle correction 2, scale 2": 20,
    "gravity 4, acceleration 4, speed 2, position 9, distance 2, fraction 5": 26,
}
RK2_OPS = {  # the rest of one main-loop step of the midpoint method
    "stage time": 1,
    "one stage input: 14 x (*, +)": 28,
    "combine: 14 x (*dt, +s)": 28,
    "renormalize the quaternion": 13,
    "events: step time (fused, 2), speed 6, max speed 1, coast time 1": 10,
}
# energy_consistent_aero, in place of "aero force in the body frame" (17)
ENERGY_AERO_OPS = {
    "1 / max(|v|, 1e-12) 2, unit air velocity 3, lift and side force 9, "
    "their component along it 5, force 3 x 4": 31,
}
TIERED_OPS = {  # descent_dt_scale > 1, beside the events
    "fall speed 1, clearance 3, t + dt 1 in place of the fused step time 2": 3,
}


OPS_PER_RAIL_STEP = sum(RAIL_OPS.values())
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES_PER_S = 3.35e12


def k1_flags(sim_config: dict) -> dict:
    """The build's flags that change a step's operations, from a
    configuration's ``SimConfig`` fields."""
    return {"rk2": sim_config.get("integrator", "rk4") == "rk2",
            "wind_per_step": bool(sim_config.get("wind_eval_per_step", False)),
            "energy_aero": bool(sim_config.get("energy_consistent_aero", False)),
            "tiered": int(sim_config.get("descent_dt_scale", 1)) > 1}


def ops_per_step(flags: dict) -> int:
    """Operations of one main-loop step: two or four dynamics evaluations
    and the rest of the step (the wind lookup once a step under
    ``wind_per_step``)."""
    wind = DYNAMICS_OPS["wind: window 14, segment guess 2, 3 components x 3 knots x (*, +) 18"]
    dyn = sum(DYNAMICS_OPS.values())
    if flags["energy_aero"]:
        dyn += sum(ENERGY_AERO_OPS.values()) - DYNAMICS_OPS["aero force in the body frame"]
    ops = wind if flags["wind_per_step"] else 0
    if flags["wind_per_step"]:
        dyn -= wind
    ops += 2 * dyn + sum(RK2_OPS.values()) if flags["rk2"] else 4 * dyn + sum(RK4_OPS.values())
    if flags["tiered"]:
        ops += sum(TIERED_OPS.values())
    return ops


# a lane's inputs and outputs: its wind table (knots x 3), 12 initial
# conditions, the 6 scene numbers the sampler draws per lane (dry and
# propellant mass, thrust scale, flow rate, burn time, density scale); 28
# float and 3 int32 outputs
_LANE_VALUES_IN = 12 + 6
_LANE_FLOATS_OUT, _LANE_INTS_OUT = 28, 3


def k1_lane_bytes(wind_knots: int, dtype: str) -> int:
    size = 4 if dtype == "float32" else 8
    return (3 * wind_knots + _LANE_VALUES_IN + _LANE_FLOATS_OUT) * size + 4 * _LANE_INTS_OUT


def k1_ops(main_steps: int, rail_steps: int, flags: dict) -> int:
    """The operations of flights that ran ``main_steps`` main-loop and
    ``rail_steps`` rail steps."""
    return main_steps * ops_per_step(flags) + rail_steps * OPS_PER_RAIL_STEP


def k1_bound_ms(main_steps: int, rail_steps: int, lanes: int, flags: dict, wind_knots: int,
                dtype: str) -> tuple:
    """``(ms, "operations" | "bytes")``: the least time of flights that ran
    ``main_steps`` main-loop and ``rail_steps`` rail steps over ``lanes``."""
    ops = k1_ops(main_steps, rail_steps, flags)
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = lanes * k1_lane_bytes(wind_knots, dtype) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
