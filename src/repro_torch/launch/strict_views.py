"""The strict-view guard: an architecture's sharded train step traced at
its full config's widths on the (32, 8) production mesh, counting what
shows a view DTensor cannot take without redistributing.

A view that flattens a dim group sharded on an inner dim (any but the
group's first) is refused by DTensor on torch 2.11 and kept on later
releases as a ``_StridedShard`` placement, whose redistributions DTensor
then plans with its min-cost graph search
(``DTensorRedistributePlanner.generate_graph_based_transform_infos``),
a search whose cost grows with the mesh's axes.  The model code moves
such shards itself before the view (``models.layers.flat_ready``,
``rows_ready``, ``kernels.ops.on_head_shards``); this guard counts, over
one traced train step of :func:`repro_torch.launch.specs.
build_train_step`:

* ``strided_shards``: ``_StridedShard`` placements constructed;
* ``graph_plans``: calls of the graph-based redistribution planner;
* ``fallbacks``: the dry run's ``replicated_to_propagate`` (an operation
  DTensor could not propagate, which the dry run replicates to run and a
  real ``Trainer(rules=)`` cannot).

A step that trains sharded at full width has all three at zero.  On
torch 2.11 a refused view shows as a fallback (the dry run catches it),
so the three counts hold there too.

Depth is cut to one layer of each kind the config has, in the order its
pattern first gives them (whisper: one encoder and one decoder block),
widths are the full config's, and the sequence is cut to ``SEQ``: lengths
that reach each architecture's longest path (hymba past its 1024-token
window, gemma3 past its 512, whisper's 4096 tokens that its sequence
sharding needs).  Usage (no card needed; a fake world of 256 ranks)::

    PYTHONPATH=src python -m repro_torch.launch.strict_views --arch hymba_1_5b
    PYTHONPATH=src python -m repro_torch.launch.strict_views --all

Each architecture prints one line ``STRICT {json}``; the exit code is 1
when any count is not zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from ..configs import ARCHS, SHAPES, get_config

#: tokens a sequence in the guard's trace (a batch of the train_4k cell's
#: 256 sequences)
SEQ = {
    "mixtral_8x7b": 512,
    "grok_1_314b": 512,
    "h2o_danube_1_8b": 4096,
    "nemotron_4_340b": 512,
    "gemma2_2b": 4096,
    "gemma3_1b": 4096,
    "chameleon_34b": 512,
    "hymba_1_5b": 2048,
    "whisper_small": 4096,
    "xlstm_350m": 512,
}


def guard_config(arch: str):
    """The full config of ``arch`` cut to one layer of each kind it has
    (whisper: one encoder and one decoder block)."""
    cfg = get_config(arch)
    kinds = tuple(dict.fromkeys(cfg.layer_pattern))
    cut = dict(n_layers=len(kinds), layer_pattern=kinds)
    if cfg.family == "encdec":
        cut = dict(n_layers=1, n_enc_layers=1)
    return dataclasses.replace(cfg, **cut)


class _Counts:
    """Counts ``_StridedShard`` constructions and graph-based plans while
    open (the two are patched on their classes, and restored)."""

    def __init__(self):
        self.strided = self.graph = 0
        self._undo = []

    def _wrap(self, owner, name, field):
        orig = getattr(owner, name)

        def counted(*args, **kwargs):
            setattr(self, field, getattr(self, field) + 1)
            return orig(*args, **kwargs)
        setattr(owner, name, counted)
        self._undo.append((owner, name, orig))

    def __enter__(self):
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor.placement_types import _StridedShard

        self._wrap(_StridedShard, "__init__", "strided")
        planner = getattr(_redistribute, "DTensorRedistributePlanner", None)
        if planner is not None and hasattr(
                planner, "generate_graph_based_transform_infos"):
            self._wrap(planner, "generate_graph_based_transform_infos",
                       "graph")
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def guard_trace(arch: str) -> dict:
    """One architecture's guard record: the cut, the trace's seconds, the
    three counts (``fallbacks`` by operation and axes), and the step's
    memory, FLOPs and collective wire bytes a device as the dry run
    counts them."""
    from .dryrun import fake_world, trace_cell
    from .mesh import make_production_mesh, make_rules

    cfg = guard_config(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ[arch])
    with fake_world(256), _Counts() as counts:
        t0 = time.perf_counter()
        rules = make_rules(make_production_mesh(), kind="train")
        rec = trace_cell(cfg, shape, rules)
        seconds = time.perf_counter() - t0
    return {"arch": arch, "layers": list(cfg.layer_pattern),
            "enc_layers": cfg.n_enc_layers, "seq": shape.seq_len,
            "batch": shape.global_batch, "trace_s": round(seconds, 2),
            "strided_shards": counts.strided, "graph_plans": counts.graph,
            "fallbacks": rec["replicated_to_propagate"],
            # what the step costs a device, as the dry run prices it
            "memory_bytes": rec["memory"]["per_device_total"],
            "flops_per_dev": rec["roofline"]["traced_flops_per_dev"],
            "wire_per_dev": rec["roofline"]["wire_per_dev"]}


def clean(rec: dict) -> bool:
    """True when a guard record has none of the three."""
    return not (rec["strided_shards"] or rec["graph_plans"]
                or rec["fallbacks"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCHS)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    archs = ARCHS if args.all or not args.arch else args.arch
    ok = True
    for arch in archs:
        rec = guard_trace(arch)
        ok &= clean(rec)
        print("STRICT " + json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
