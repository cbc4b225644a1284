"""Seconds from the process's start to the window's: imports, CUDA
initialisation, the kernel libraries (built by nvcc in a checkout's first
run, loaded from ``portbench/.kcache`` after), the inputs and the warm-up
fit."""


def read(run):
    return run.setup_s
