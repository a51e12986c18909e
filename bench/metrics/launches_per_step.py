"""Device operations (kernels, copies and sets) in the profiled calls over
the steps they advanced, on the mean card of the cell."""


def read(run):
    tr = run.trace
    if not tr or not tr["device_ops"]:
        return None
    return tr["device_ops"] / (tr["calls"] * run.steps_per_call)
