"""Seconds from the process's start to the window: imports, CUDA set-up,
kernel builds, the pool, the program's objects and one decode of every
pool batch."""


def read(run):
    return run.setup_s
