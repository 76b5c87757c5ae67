"""``flights_per_s``: the dispersed flights of every analysis of the window
over the host wall from the window's start to the end of the last one."""


def read(run):
    return run.flights / run.window_s if run.window_s > 0 else None
