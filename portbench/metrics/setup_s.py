"""Seconds from the harness's start to the window: imports, the kernels'
build (first run in a checkout), the problem, the ICs, the warm-up."""


def read(run):
    return run.setup_s
