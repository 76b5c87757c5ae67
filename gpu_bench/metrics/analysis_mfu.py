"""``analysis_mfu``: the operations of the window's flights (the frozen
``yardstick``'s count, as ``k1_roofline_share`` takes it) over the window's
whole wall at the FP32 or FP64 peak, in percent: the whole analysis's share
of the card's peak, which bounds the flight kernel's share from below
whatever kernel flies the lanes. Reads nothing where the analyses keep no
per-lane summary."""

from gpu_bench import yardstick as Y


def read(run):
    if run.trace is None or run.work is None or run.trace.window_s <= 0:
        return None
    cfg = run.cell.config
    ops = Y.k1_ops(run.work["main_steps"], run.work["rail_steps"],
                   Y.k1_flags(cfg["sim_config"]))
    return ops / (run.trace.window_s * Y.PEAK_FLOPS[cfg["dtype"]]) * 100.0
