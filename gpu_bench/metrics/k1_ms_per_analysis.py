"""``k1_ms_per_analysis``: the device time of the flight kernel
(``flight_summary_kernel``) over the window, per analysis."""


def read(run):
    if run.trace is None or not len(run.trace.spans):
        return None
    s = run.trace.device_s("flight_summary_kernel")
    return s / len(run.trace.spans) * 1e3 if s > 0 else None
