"""Device milliseconds a step that the program's mesh orchestrator launched
inside its ``distribute.exchange`` spans, on the mean card: the halo slabs
cut from each shard, moved between cards and joined to each shard's block
(bench/spans.py). Nothing where the stretch holds no such span."""

from bench import spans

SPAN = "distribute.exchange"


def read(run):
    att = spans.of_run(run)
    if att is None or SPAN not in att["by_span"]:
        return None
    return spans.device_ms_per_step(run, SPAN)
