"""Seconds from the process's start to the window's: imports, the kernels'
build where the checkout has none, both traces' VM, trace build and
ingest, and every job shape proved cold and warm (host clock)."""


def read(run):
    return run.setup_s
