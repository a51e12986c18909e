"""Auto-tuning walkthrough: let the tooling pick the dataflow plan.

    PYTHONPATH=src python examples_torch/autotune.py [--backend cuda]
    PYTHONPATH=src python examples_torch/autotune.py --device cpu --grid 8,8,32

The paper's point is that the transformation space is searched by the
*compiler*, not the programmer.  This example closes that loop end to end:

1. first ``compile_program(..., strategy="tuned")`` call — cache miss: the
   tuner prunes candidates with the H100 shared-memory and roofline
   models, measures the survivors on the device (single-step and fused
   ``steps=N``), and persists the winner in a JSON plan cache;
2. second call — pure cache hit: the stored plan compiles immediately,
   zero timed runs;
3. the tuned executable is checked against the ``auto_plan`` heuristic for
   both numerics and steps/sec.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.apps import pw_advection, pw_advection_update
from repro_torch.core import (CompileOptions, PlanCache, TuneConfig,
                              compile_program)
from repro_torch.core.pipeline import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="torch_fused",
                    choices=("torch_naive", "torch_fused", "cuda"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--grid", default="32,32,128",
                    help="grid extents, comma-separated")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p = pw_advection()
    grid = tuple(int(g) for g in args.grid.split(","))
    update = pw_advection_update(0.1)
    rng = np.random.default_rng(0)
    fields = {f: torch.from_numpy(rng.normal(size=grid).astype(np.float32)
                                  * 0.1).to(device)
              for f in p.input_fields()}
    scalars = {s: np.float32(0.05) for s in p.scalars}
    coeffs = {c: torch.from_numpy(np.linspace(0.9, 1.1, grid[ax]).astype(
        np.float32)).to(device) for c, ax in p.coeffs.items()}

    with tempfile.TemporaryDirectory(prefix="stencil_hmls_") as tmp:
        cache = PlanCache(path=f"{tmp}/plan_cache.json")
        cfg = TuneConfig(steps=args.steps, repeats=2, max_measured=4)

        # one frozen CompileOptions is shared verbatim between both tuned
        # compiles (the canonical API; loose kwargs normalise to the same)
        opts = CompileOptions(backend=args.backend, strategy="tuned",
                              steps=args.steps, update=update,
                              tune_config=cfg, plan_cache=cache,
                              device=device)

        # -- 1. cache miss: the tuner searches the plan space by measurement
        t0 = time.perf_counter()
        ex_tuned = compile_program(p, grid, options=opts)
        print(f"tuned (cache miss, measured search): "
              f"{time.perf_counter()-t0:.2f}s")
        print("  winning plan:", ex_tuned.plan.describe())

        # -- 2. cache hit: zero timed runs ----------------------------------
        t0 = time.perf_counter()
        compile_program(p, grid, options=opts)
        print(f"tuned (cache hit): {time.perf_counter()-t0:.2f}s  -> "
              f"{cache.path}")

    # -- 3. tuned vs heuristic: same numbers, at least the same speed -------
    ex_auto = compile_program(p, grid, backend=args.backend,
                              steps=args.steps, update=update, device=device)
    out_t = ex_tuned(fields, scalars, coeffs)
    out_a = ex_auto(fields, scalars, coeffs)
    for k in out_a:
        np.testing.assert_allclose(out_t[k].cpu().numpy(),
                                   out_a[k].cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    print("tuned matches auto_plan numerics")

    for name, ex in (("auto_plan", ex_auto), ("tuned", ex_tuned)):
        ex(fields, scalars, coeffs)                         # warm
        _sync(device)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ex(fields, scalars, coeffs)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        print(f"  {name:10s} {args.steps / best:8.2f} steps/s")
    print("autotune OK")
    return {k: v.cpu().numpy() for k, v in out_t.items()}


if __name__ == "__main__":
    main()
