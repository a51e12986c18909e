"""Multi-cluster dry run: trace every (architecture x input shape) step of
the port on H100 cluster meshes of 256 and 512 GPUs, with no card, and
record memory, operation counts and the roofline terms.

The reference lowers and compiles each cell with XLA on 512 host-platform
devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
collectives of the HLO text.  Here the same cells run the port's own step
(:mod:`.specs`) once over a ``DeviceMesh`` of the cluster's shape
(:mod:`.mesh`), on a fake process group of that many ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once, nothing crosses a wire), with DTensor parameters, moments, caches and
inputs whose local shards are ``"meta"`` tensors: nothing is allocated and
no card is needed.  DTensor propagates the sharding of every operation and
issues the collectives a real run would; the trace records, on one
device (rank 0; the rules shard evenly, so every rank does the same):

* every collective, with its op, result bytes, group size and the mesh
  axes of its group (a dispatch mode below DTensor sees the functional
  collectives it issues);
* FLOPs and bytes moved per device: each DTensor operation's FLOPs by
  ``torch.utils.flop_counter``'s formulas on its global shapes, divided by
  the number of devices that split its output (those where it is
  ``Shard`` or ``Partial``), so the count is that of the local operation;
  bytes as the local inputs read and the local output written, views
  excluded;
* operations where a plain (replicated) tensor of a million elements or
  more meets a DTensor: DTensor replicates such a tensor on every device,
  so each is logged (``implicit_replications``) rather than hidden;
* operations DTensor cannot propagate (a view that must flatten or split
  a dimension sharded unevenly, as hymba's 25 heads over 8 cards): their
  operands are replicated over the innermost mesh axes until the operation
  runs, the gathers recorded as collectives and each fallback logged
  (``replicated_to_propagate``);
* memory a device: argument bytes exactly from the local shard shapes,
  and the peak of what the step allocates: the local bytes of every
  tensor an operation returns, live until it is collected (a view keeps
  its base alive).  The buffers DTensor's collectives use inside an
  operation are not counted.  ``torch.distributed._tools.mem_tracker.
  MemTracker`` counts the same on meta shards, but took 43% of a hymba
  layer's 148 s trace; this count adds a finaliser an output.

The mesh's device type is ``"cuda"``, so DTensor takes the card's
collectives (an all-to-all where a CPU mesh would all-gather); the local
shards are meta tensors because a fake ``"cuda"`` tensor cannot be indexed
without CUDA in the process, and ``FakeTensorMode`` made DTensor's
sharding propagation read a scalar (``.item()``) on a batched product.

Usage (no card needed; ``--pods 2`` opens 512 fake ranks):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
        mixtral_8x7b --shape train_4k --pods 1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --pods 1 \\
        --out build/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch

from ..analysis.roofline import (analytic_flops, analytic_traffic,
                                 roofline_report)
from ..configs import ARCHS, SHAPES, get_config
from .mesh import make_production_mesh, make_rules, mesh_label
from .specs import build_step

# long_500k needs sub-quadratic attention: skip for pure full-attention
# archs; run for SWA/SSM/hybrid (the reference's rule)
FULL_ATTN_ARCHS = {"grok_1_314b", "nemotron_4_340b", "chameleon_34b",
                   "whisper_small"}

#: a plain tensor meeting a DTensor is logged from this many elements on
IMPLICIT_LOG_NUMEL = 1 << 20

#: functional collectives (``_c10d_functional``) and DTensor's own, by
#: the reference's names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    # a ring broadcast moves what an all-gather of its result does
    "broadcast": "all-gather",
}


def cell_is_skipped(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch in FULL_ATTN_ARCHS:
        return "skip:full-attention arch (sub-quadratic required)"
    return None


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the duration of the context (the group is process-wide)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a nest of modules, dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def local_bytes(tree) -> int:
    """Bytes one device holds of the tensors in ``tree`` (a DTensor's
    local shard)."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


class CollectiveLog:
    """A dispatch mode below DTensor that records each functional
    collective it issues on local shards: op (the reference's names),
    result bytes, group size and the mesh axis of its group.  It runs under
    the dry run's fake group and under a real one alike (the sharded
    step's collectives by op and axis, ``tests/test_torch_sharded_train.py``
    and ``chip_smoke.py``); ``during`` names the DTensor operation that
    issues a collective when a mode above DTensor sets it."""

    def __init__(self, mesh):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        groups = {mesh.get_group(d).group_name: d
                  for d in mesh.mesh_dim_names}
        log = self
        self.collectives = []
        # result bytes of each (collective, axis, DTensor op issuing it)
        self.during, self.during_bytes = None, {}

        class Comms(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                op = _COLLECTIVES.get(func._overloadpacket.__name__)
                if op is not None:
                    axis = next(groups[a] for a in args
                                if isinstance(a, str) and a in groups)
                    log.collectives.append(
                        {"op": op, "bytes": _nbytes(out),
                         "group": mesh.size(
                             mesh.mesh_dim_names.index(axis)),
                         "axes": [axis]})
                    key = (op, axis, log.during)
                    log.during_bytes[key] = log.during_bytes.get(
                        key, 0) + _nbytes(out)
                return out

        self.mode = Comms()

    def by_op_axis(self) -> dict:
        """{"<op> over <axis>": {"count", "bytes"}} of what was recorded."""
        out: dict = {}
        for c in self.collectives:
            a = out.setdefault(f"{c['op']} over {c['axes'][0]}",
                               {"count": 0, "bytes": 0})
            a["count"] += 1
            a["bytes"] += c["bytes"]
        return out

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


class StepTrace:
    """Records one step's collectives, FLOPs, bytes and implicit
    replications on one device of ``mesh`` (see the module docstring)."""

    def __init__(self, mesh):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        trace = self
        self.comms = CollectiveLog(mesh)
        self.collectives = self.comms.collectives
        self.during_bytes = self.comms.during_bytes
        self.implicit = []
        self.flops, self.bytes = 0.0, 0

        def split(out) -> int:
            n = 1
            if isinstance(out, DTensor):
                sizes = list(out.device_mesh.shape)
                for i, pl in enumerate(out.placements):
                    if not pl.is_replicate():
                        n *= sizes[i]
            return n

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        class Ops(TorchDispatchMode):
            """Above DTensor: FLOPs, bytes and implicit replications."""

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                trace.comms.during = str(func)
                try:
                    out = func(*args, **kwargs)
                except RuntimeError as err:
                    if not any(issubclass(t, DTensor) for t in types):
                        raise
                    out, args, kwargs = trace._fall_back(func, args, kwargs,
                                                         err)
                flat = [a for a in torch.utils._pytree.tree_leaves(
                    (args, kwargs)) if isinstance(a, torch.Tensor)]
                first = next((o for o in torch.utils._pytree.tree_leaves(
                    out) if isinstance(o, torch.Tensor)), None)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    trace.flops += formula(*args, **kwargs,
                                           out_val=out) / split(first)
                if not func.is_view:
                    outs = [o for o in torch.utils._pytree.tree_leaves(out)
                            if isinstance(o, torch.Tensor)]
                    trace.bytes += sum(_nbytes(local(t))
                                       for t in flat + outs)
                    ins = {id(local(a)) for a in flat}
                    for o in outs:
                        if id(local(o)) not in ins:
                            trace._hold(local(o))
                if any(isinstance(a, DTensor) for a in flat):
                    for a in flat:
                        if not isinstance(a, DTensor) and \
                                a.numel() >= IMPLICIT_LOG_NUMEL:
                            trace.implicit.append(
                                {"op": str(func), "shape": list(a.shape),
                                 "bytes": _nbytes(a)})
                return out

        self._modes = (self.comms, Ops())
        self.fallbacks = []
        self.live = self.peak = 0

    def _hold(self, t):
        """Count a tensor an operation returned as live until it is
        collected (its views keep it alive through ``_base``)."""
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def _fall_back(self, func, args, kwargs, err):
        """An operation DTensor cannot propagate (an uneven head split
        that a view must flatten or unflatten): its DTensor operands
        replicated over one more mesh axis at a time, innermost first,
        until it runs; each is logged, its gathers recorded with the
        step's collectives."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map

        mesh = next(a for a in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(a, DTensor)).device_mesh
        for upto in range(mesh.ndim - 1, -1, -1):
            def widen(a):
                if not isinstance(a, DTensor):
                    return a
                places = list(a.placements)
                for i in range(upto, mesh.ndim):
                    if places[i].is_shard():
                        places[i] = Replicate()
                return a.redistribute(a.device_mesh, places)
            try:
                wide = tree_map(widen, (args, kwargs))
                out = func(*wide[0], **wide[1])
            except RuntimeError:
                continue
            self.fallbacks.append(
                {"op": str(func), "replicated_axes":
                 list(mesh.mesh_dim_names[upto:]),
                 "reason": str(err).strip().splitlines()[0][:160]})
            return out, wide[0], wide[1]
        raise err

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, variant: str = "baseline") -> dict:
    """One cell's record: traced on a fake group of the mesh's size (which
    it opens and closes)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    label = mesh_label(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": label}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        rec["status"] = skip
        return rec
    chips = math.prod(int(n) for n in label.split("x"))
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = make_rules(mesh, kind=("train" if shape.kind == "train"
                                       else "serve"), variant=variant)
        rec.update(trace_cell(cfg, shape, rules))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{label}"
                                     f"{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def trace_cell(cfg, shape, rules) -> dict:
    """Build and trace one cell's step over ``rules.mesh`` (inside an open
    process group of its size): status, chips, microbatches, seconds,
    memory, analytic FLOPs, roofline and implicit replications."""
    mesh = rules.mesh
    chips = mesh.size()
    t0 = time.time()
    step, args = build_step(cfg, shape, rules)
    t_build = time.time() - t0
    arg_bytes = local_bytes(args)
    trace = StepTrace(mesh)
    with trace:
        out = step(*args)
    t_trace = time.time() - t0 - t_build
    peak = trace.peak
    af = analytic_flops(cfg, shape)
    tp = rules.axis_size(rules.tp) if rules.tp else 1
    fsdp = (chips // tp if (shape.kind == "train" and rules.fsdp) else 1)
    traffic = analytic_traffic(cfg, shape, chips=chips, tp=tp, fsdp=fsdp,
                               dp_total=chips // tp)
    rep = roofline_report(chips=chips, collectives=trace.collectives,
                          flops_per_dev=trace.flops,
                          bytes_per_dev=trace.bytes,
                          model_flops=af["model_flops"], analytic=traffic)
    fallbacks: dict = {}
    for r in trace.fallbacks:
        a = fallbacks.setdefault(f"{r['op']} over {'+'.join(r['replicated_axes'])}",
                                 {"count": 0, "reason": r["reason"]})
        a["count"] += 1
    implicit: dict = {}
    for r in trace.implicit:
        a = implicit.setdefault(r["op"], {"count": 0, "bytes": 0,
                                          "largest": r["shape"]})
        a["count"] += 1
        a["bytes"] += r["bytes"]
    del out
    return {
        "status": "ok",
        "chips": chips,
        "microbatches": getattr(step, "microbatches", 1),
        "build_s": round(t_build, 1),
        "trace_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_step_bytes": int(peak),
            "per_device_total": int(arg_bytes + peak),
        },
        "analytic_flops": af,
        "roofline": rep,
        "implicit_replications": implicit,
        "replicated_to_propagate": fallbacks,
        "collective_bytes_by_op": [
            {"collective": c, "axis": a, "during": d, "bytes": b}
            for (c, a, d), b in sorted(trace.during_bytes.items(),
                                       key=lambda kv: -kv[1])[:12]],
    }


def summarise(rec: dict) -> str:
    if rec["status"] != "ok":
        return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:8s} "
                f"{rec['status']}")
    m = rec["memory"]["per_device_total"] / 2**30
    t = rec["roofline"]["terms_primary"]
    return (f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:8s} ok "
            f"mem/dev={m:7.2f}GiB compute={t['compute_s']:.2e}s "
            f"memory={t['memory_s']:.2e}s coll={t['collective_s']:.2e}s "
            f"dom={t['dominant']:10s} (trace {rec['trace_s']:.0f}s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--pods", default="1", choices=["1", "2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="'+'-joined levers: sp, dp_remap, kvseq")
    args = ap.parse_args()

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"1": [False], "2": [True], "both": [False, True]}[args.pods]
    out = None if args.no_save else args.out

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                try:
                    rec = run_cell(arch, shape, mp, out, args.variant)
                except Exception as e:
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_label(mp),
                           "status": f"FAIL {type(e).__name__}: {e}"}
                    traceback.print_exc()
                    if out:
                        os.makedirs(out, exist_ok=True)
                        with open(os.path.join(
                                out, f"{arch}__{shape}__{rec['mesh']}.json"),
                                "w") as f:
                            json.dump(rec, f, indent=1)
                print(summarise(rec), flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
