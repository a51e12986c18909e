"""Stream schedule walkthrough: the paper's shift-register dataflow layer.

    PYTHONPATH=src python examples_torch/stream_schedule.py [--kernel tracer]
    PYTHONPATH=src python examples_torch/stream_schedule.py \\
        --device cpu --grid 8,8,32

Shows the HLS-dialect analogue end to end:

1. lower the stencil IR to the dataflow layer and print the stream graph —
   ``Load -> Window(depth) -> Compute[ring] -> Store`` regions, with
   window-buffer depths computed from the access offsets and fusion
   legalised (positive stream offsets split regions);
2. compile both schedules of the same program and check steps=N fused-loop
   parity between them;
3. time the fused loop under each schedule (on the H100 the stream
   schedule's generated sweep kernel fetches each input plane into a
   shared-memory ring once per sweep; on the CPU the plain PyTorch
   versions run and the times say nothing about the card).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.analysis.stencil_roofline import plan_bytes_per_point
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import CompileOptions, compile_program, lower_to_dataflow
from repro_torch.core.pipeline import resolve_device
from repro_torch.core.schedule import auto_plan


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="pw", choices=("pw", "tracer"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--boundary", default="zero", choices=("zero", "periodic"))
    ap.add_argument("--time-tile", type=int, default=4,
                    help="temporal-blocking depth for the chained stream run")
    ap.add_argument("--plane-tile", type=int, default=4,
                    help="spatial-unrolling width for the plane-tiled stream "
                         "run (P planes per sweep grid step)")
    ap.add_argument("--grid", default=None,
                    help="grid extents, comma-separated (default: 32,32,128 "
                         "for pw, 16,16,64 for tracer)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.kernel == "pw":
        p = pw_advection(boundary=args.boundary)
        update = pw_advection_update(0.1)
        grid = (32, 32, 128)
    else:
        p = tracer_advection(boundary=args.boundary)
        update = tracer_advection_update()
        grid = (16, 16, 64)
    if args.grid:
        grid = tuple(int(g) for g in args.grid.split(","))

    rng = np.random.default_rng(0)
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in p.input_fields()}
    if "e3t" in fields:
        fields["e3t"] = np.abs(fields["e3t"]) + 1.0
    scalars = {s: np.float32(0.05) for s in p.scalars}
    coeffs = {c: np.linspace(0.9, 1.1, grid[ax]).astype(np.float32)
              for c, ax in p.coeffs.items()}
    fields = {f: torch.from_numpy(v).to(device) for f, v in fields.items()}
    coeffs = {c: torch.from_numpy(v).to(device) for c, v in coeffs.items()}

    # -- 1. the dataflow layer: stencil IR -> stream graph ------------------
    plan = auto_plan(p, grid, schedule="stream")
    graph = lower_to_dataflow(p, plan)
    print(graph.to_text())
    print()
    for r in graph.regions:
        print(f"  {r.describe()}")
    print(f"  modeled bytes/point: stream="
          f"{plan_bytes_per_point(p, plan, grid):.1f} vs "
          f"block={plan_bytes_per_point(p, auto_plan(p, grid), grid):.1f}")
    print()

    # -- 2. both schedules, one fused loop each, parity ---------------------
    # CompileOptions is the canonical configuration object; loose kwargs
    # normalise to the same thing.  time_tile chains T time steps through
    # one stream sweep (legalisation may demote it — see the printed
    # effective depth); on the block schedule it does not apply.
    T, P = args.time_tile, args.plane_tile
    execs = {}
    for label, opts in (
        ("block", CompileOptions(schedule="block", steps=args.steps,
                                 update=update, device=device)),
        ("stream", CompileOptions(schedule="stream", steps=args.steps,
                                  update=update, device=device)),
        (f"stream/T={T}",
         CompileOptions(schedule="stream", steps=args.steps, update=update,
                        time_tile=T, device=device)),
        (f"stream/P={P}",
         CompileOptions(schedule="stream", steps=args.steps, update=update,
                        plane_tile=P, device=device)),
        (f"stream/P={P}/T={T}",
         CompileOptions(schedule="stream", steps=args.steps, update=update,
                        time_tile=T, plane_tile=P, device=device)),
    ):
        execs[label] = compile_program(p, grid, options=opts)
    tiled = execs[f"stream/T={T}"]
    print(f"requested time_tile={T}, effective "
          f"{tiled.plan.stream.time_tile} (legalisation demotes chains that "
          f"cross region splits or periodic wraps)")
    unrolled = execs[f"stream/P={P}"]
    print(f"requested plane_tile={P}, effective "
          f"{unrolled.plan.stream.plane_tile} (legalisation demotes sweeps "
          f"wider than the stream extent)")
    out = {s: ex(fields, scalars, coeffs) for s, ex in execs.items()}
    worst = max(float((out[s][k] - out["block"][k]).abs().max())
                for s in out if s != "block" for k in out["block"])
    print(f"fused steps={args.steps} parity vs block schedule: "
          f"max|diff| = {worst:.2e}")
    assert worst < 1e-5

    # -- 3. fused-loop timing under each schedule ---------------------------
    first = next(iter(fields))
    for schedule, ex in execs.items():
        ex(fields, scalars, coeffs)
        _sync(device)
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ex(fields, scalars, coeffs)[first]
            _sync(device)
            dt = min(dt, time.perf_counter() - t0)
        print(f"{schedule:>12}: {args.steps / dt:8.2f} steps/s "
              f"({dt * 1e6:.0f} us for {args.steps} fused steps)")
    return {s: {k: v.cpu().numpy() for k, v in o.items()}
            for s, o in out.items()}


if __name__ == "__main__":
    main()
