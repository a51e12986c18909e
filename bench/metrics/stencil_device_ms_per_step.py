"""Device milliseconds a step in the program's generated stencil kernels,
told from PyTorch's by their names (<entry>_kernel), on the mean card of
the cell."""


def read(run):
    tr = run.trace
    if not tr or not tr["generated_ops"]:
        return None
    return tr["generated_s"] * 1e3 / (tr["calls"] * run.steps_per_call)
