"""Device milliseconds a step in operations that are not the program's
generated kernels: pads, copies, sets, the update's arithmetic, the halo
exchange; on the mean card of the cell."""


def read(run):
    tr = run.trace
    if not tr or not tr["device_ops"]:
        return None
    return tr["aux_s"] * 1e3 / (tr["calls"] * run.steps_per_call)
