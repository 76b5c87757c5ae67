"""``k1_roofline_share``: the least time of the window's flights on the card
(the frozen ``yardstick``: operations over the FP32 or FP64 peak, or bytes
read and written once over the memory rate, whichever is longer) over the
flight kernel's device time, in percent. Needs each analysis's steps, so
it reads nothing where the analyses keep no per-lane summary."""

from gpu_bench import yardstick as Y


def read(run):
    if run.trace is None or run.work is None:
        return None
    k1_s = run.trace.device_s("flight_summary_kernel")
    if k1_s <= 0:
        return None
    cfg = run.cell.config
    ms, _ = Y.k1_bound_ms(run.work["main_steps"], run.work["rail_steps"], run.work["lanes"],
                          Y.k1_flags(cfg["sim_config"]), int(cfg["wind_grid"]["points"]),
                          cfg["dtype"])
    return ms / (k1_s * 1e3) * 100.0
