"""Seconds from the process's start to the first timed call: imports, the
card's start, the inputs, compile_program (nvcc on a checkout's first
run), the warm-up calls."""


def read(run):
    return run.setup_s
