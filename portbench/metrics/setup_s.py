"""Seconds from the process's start to the window's: imports, the kernel
libraries (built on a checkout's first run), the weights drawn on the
card, the pipeline and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
