"""Gigabytes a step of halo slabs moved between shards: the growth of the
program's ``repro_torch.core.distribute.exchanged_bytes`` over the profiled
calls, over the steps they advanced, all cards together (bench/spans.py)."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("exchanged_bytes"):
        return None
    return tr["exchanged_bytes"] / (tr["calls"] * run.steps_per_call) / 1e9
