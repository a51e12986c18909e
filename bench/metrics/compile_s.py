"""Seconds in compile_program (the benchmark's span around it, in set-up):
front end, passes, legalisation, planning, emitters, and nvcc where the
build cache misses."""


def read(run):
    return run.spans.get("compile")
