"""End-to-end observability: trace a compile -> tune -> serve run.

    PYTHONPATH=src python examples_torch/trace_compile.py [--out TRACE.json]
    PYTHONPATH=src python examples_torch/trace_compile.py --device cpu

One :class:`repro_torch.obs.Tracer` watches the whole stack:

1. a **tuned compile** — the tuner's candidate loop shows up as nested
   ``tune.candidate`` spans under the ``compile`` span, each carrying its
   measured time and roofline-achieved fraction against the H100 plan
   model, and the winning plan is announced as a ``PlanChosen`` event;
2. a **serving session** — the engine pins the same tracer, so executor
   builds, cache hits/misses, and every ``serve.batch`` land in the same
   timeline;
3. the trace exports to Chrome ``trace_event`` JSON — open it in
   ``chrome://tracing`` or https://ui.perfetto.dev — plus optional JSONL
   for machine grep.  Process-wide metrics print at the end.

The same trace can be captured with zero code changes by running any
entry point under ``REPRO_TRACE=path``.
"""

import argparse
import json

import numpy as np

from repro_torch.apps import pw_advection, pw_advection_update
from repro_torch.core import PlanCache, TuneConfig, compile_program
from repro_torch.core.pipeline import resolve_device
from repro_torch.obs import Tracer, global_metrics
from repro_torch.serve import StencilEngine, StencilRequest


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="TRACE_compile.json",
                    help="Chrome trace_event JSON output path")
    ap.add_argument("--jsonl", default=None,
                    help="also export raw records as JSONL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p = pw_advection()
    grid = (16, 16, 16)
    update = pw_advection_update(0.1)
    rng = np.random.default_rng(0)
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in p.input_fields()}
    scalars = {s: np.float32(0.05) for s in p.scalars}
    coeffs = {c: np.linspace(0.9, 1.1, grid[ax]).astype(np.float32)
              for c, ax in p.coeffs.items()}

    tracer = Tracer()

    # -- 1. traced tuned compile --------------------------------------------
    ex = compile_program(
        p, grid, backend="cuda", strategy="tuned", steps=3, update=update,
        tune_config=TuneConfig(steps=3, repeats=1, max_measured=3),
        plan_cache=PlanCache(path=None), trace=tracer, device=device)
    chosen = tracer.events("PlanChosen")[-1]["args"]
    print(f"plan chosen: {chosen['label']} (schedule={chosen['schedule']}, "
          f"roofline_fraction={chosen['roofline_fraction']:.3e})")
    tuned = ex(fields, scalars, coeffs)

    # -- 2. traced serving --------------------------------------------------
    with StencilEngine(backend="torch_fused", max_batch=4, window_s=0.005,
                       tracer=tracer, device=device) as eng:
        futs = [eng.submit(StencilRequest(program=p, fields=fields,
                                          scalars=scalars, coeffs=coeffs))
                for _ in range(4)]
        served = [f.result(600) for f in futs]
    print(f"served {eng.stats.completed} requests in "
          f"{eng.stats.batches} batches")

    # -- 3. export ----------------------------------------------------------
    n = tracer.export_chrome(args.out)
    print(f"wrote {args.out}: {n} trace events "
          f"({len(tracer.spans())} spans, {len(tracer.events())} events)")
    if args.jsonl:
        tracer.export_jsonl(args.jsonl)
        print(f"wrote {args.jsonl}")

    summary = {
        "spans": sorted({s["name"] for s in tracer.spans()}),
        "events": sorted({e["name"] for e in tracer.events()}),
        "tune_candidates": len(tracer.spans("tune.candidate")),
        "serve_batches": len(tracer.spans("serve.batch")),
        "metrics": global_metrics().snapshot(),
    }
    print(json.dumps(summary, indent=2, default=str))

    assert tracer.spans("compile"), "no compile span recorded"
    assert summary["tune_candidates"] >= 2, "expected >= 2 tuner candidates"
    assert summary["serve_batches"] >= 1, "expected >= 1 serve batch"
    rf = chosen["roofline_fraction"]
    assert rf is not None and 0 < rf < float("inf"), rf
    return {"tuned": {k: v.cpu().numpy() for k, v in tuned.items()},
            "served": [{k: v.cpu().numpy() for k, v in r.outputs.items()}
                       for r in served]}


if __name__ == "__main__":
    main()
