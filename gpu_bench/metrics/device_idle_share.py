"""``device_idle_share``: 1 - the union of device activity over the window's
length, in percent (device trace)."""


def read(run):
    if run.trace is None or not len(run.trace.spans) or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
