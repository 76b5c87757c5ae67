"""The frozen operation tables reproduce the kernel's recorded bound: the
window workload's 262,144 lanes, 291,700,424 lane-steps (main-loop and rail
steps together), bound 6.549 ms by operations at the FP32 peak (the port's
PERF.md, phase 4)."""

from __future__ import annotations

from gpu_bench import yardstick as Y


def test_ops_per_step():
    assert Y.ops_per_step(Y.k1_flags({})) == 1619
    assert Y.OPS_PER_RAIL_STEP == 156
    stabilized = {"energy_consistent_aero": True, "descent_dt_scale": 16,
                  "ascent_q_threshold": 8000.0}
    assert Y.ops_per_step(Y.k1_flags(stabilized)) == 1619 - 4 * 17 + 4 * 31 + 3


def test_phase4_bound():
    lanes = 262_144
    # a 6 s window at dt 0.005 after a rail exit near 0.87 s: 1,026 main
    # steps a lane, the rest of the lane-steps on the rail
    main = lanes * 1026
    rail = 291_700_424 - main
    ms, by = Y.k1_bound_ms(main, rail, lanes, Y.k1_flags({"max_time": 6.0}), 100, "float32")
    assert by == "operations"
    assert abs(ms - 6.549) / 6.549 < 1e-3
