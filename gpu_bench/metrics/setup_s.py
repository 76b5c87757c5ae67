"""``setup_s``: host seconds from the process's start to the end of the
last warm analysis: imports, the device's start, loading (or, in a checkout's first
run, building) the kernels, the scene, and the warm analyses of the
cell's shape (``run.WARM_ANALYSES``)."""


def read(run):
    return run.setup_s
