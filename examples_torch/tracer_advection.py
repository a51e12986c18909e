"""NEMO tracer advection (paper benchmark 2): 24 stencil ops / 6 fields.

    PYTHONPATH=src python examples_torch/tracer_advection.py \\
        --size 8M --steps 3
    PYTHONPATH=src python examples_torch/tracer_advection.py --fused-loop
    PYTHONPATH=src python examples_torch/tracer_advection.py \\
        --device cpu --size 16K

Demonstrates the dependency-chain handling (producer->consumer temps inside
one generated fuse-group kernel, kept in shared-memory rings on the H100)
on the paper's harder benchmark, and compares the three stage-split
strategies.  ``--fused-loop`` additionally compiles the whole tracer time
loop into one device-resident program and reports steps/sec for both
execution modes.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.apps import tracer_advection, tracer_advection_update
from repro_torch.core import compile_program, run_time_loop
from repro_torch.core.pipeline import resolve_device

SIZES = {"16K": (16, 16, 64), "1M": (128, 64, 128), "8M": (256, 256, 128),
         "33M": (512, 256, 256)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_fields(grid, device):
    """The example's tracer state, from seed 1."""
    rng = np.random.default_rng(1)
    host = {
        "t": rng.normal(size=grid).astype(np.float32) + 15.0,
        "un": rng.normal(size=grid).astype(np.float32) * 0.2,
        "vn": rng.normal(size=grid).astype(np.float32) * 0.2,
        "wn": rng.normal(size=grid).astype(np.float32) * 0.05,
        "e3t": np.abs(rng.normal(size=grid)).astype(np.float32) + 1.0,
        "msk": (rng.uniform(size=grid) > 0.05).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1M", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fused-loop", action="store_true",
                    help="compile the whole time loop on device and compare "
                         "steps/sec against the host-driven loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grid = SIZES[args.size]
    p = tracer_advection()
    fields = make_fields(grid, device)
    scalars = {"rdt": np.float32(0.05), "zeps": np.float32(1e-6)}
    coeffs = {"ztfreez": torch.full((grid[2],), -1.8, device=device)}
    pts = float(np.prod(grid))
    result = {}

    if not args.fused_loop:
        # a compile only plans; each first call below builds its kernels
        execs = {strategy: compile_program(
            p, grid, backend="torch_fused" if strategy == "auto" else "cuda",
            strategy=strategy, device=device)
            for strategy in ("fused", "per_field", "auto")}
        for strategy, ex in execs.items():
            t0 = time.perf_counter()
            out = ex(fields, scalars, coeffs)
            _sync(device)
            el = time.perf_counter() - t0
            print(f"strategy={strategy:9s} groups="
                  f"{len(ex.plan.groups):2d} first-call {el:6.2f}s")
            result[strategy] = out["ta"].cpu().numpy()

    if args.fused_loop:
        update = tracer_advection_update()
        ex = compile_program(p, grid, backend="torch_fused", device=device)
        exN = compile_program(p, grid, backend="torch_fused",
                              steps=args.steps, update=update, device=device)
        print("time loop:", exN.time_spec.describe())
        for label, fn in (
                ("host loop ", lambda: run_time_loop(
                    ex, dict(fields), scalars, coeffs, args.steps, update)),
                ("fused loop", lambda: exN(fields, scalars, coeffs))):
            fn()                                  # warm-up
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            el = time.perf_counter() - t0
            print(f"{label}: {args.steps} steps in {el*1e3:8.1f} ms  "
                  f"{args.steps/el:8.2f} steps/s  "
                  f"{pts*args.steps/el/1e6:8.2f} MPt/s")
            assert bool(torch.isfinite(out["t"]).all())
            result[label.strip()] = out["t"].cpu().numpy()
        print("tracer_advection fused-loop OK")
        return result

    ex = compile_program(p, grid, backend="torch_fused", device=device)
    tr = fields["t"]
    for step in range(args.steps):
        t0 = time.perf_counter()
        out = ex(dict(fields, t=tr), scalars, coeffs)
        tr = out["ta"]
        _sync(device)
        el = time.perf_counter() - t0
        print(f"step {step}: {el*1e3:8.1f} ms  {pts/el/1e6:8.2f} MPt/s  "
              f"t-mean={float(tr.mean()):.4f}")
    assert bool(torch.isfinite(tr).all())
    result["t"] = tr.cpu().numpy()
    print("tracer_advection OK")
    return result


if __name__ == "__main__":
    main()
