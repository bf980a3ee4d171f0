"""setup_s: seconds from the start of the process to the first timed unit:
imports, the kernel library's load (or, in a checkout's first run, its
build), the scene, one warm-up unit of the cell's own shapes."""


def read(run):
    return run.setup_s
