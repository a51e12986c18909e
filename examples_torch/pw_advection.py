"""PW advection solver (paper benchmark 1): a real time-stepping run.

    PYTHONPATH=src python examples_torch/pw_advection.py --size 8M --steps 5
    PYTHONPATH=src python examples_torch/pw_advection.py \\
        --fused-loop --steps 20
    PYTHONPATH=src python examples_torch/pw_advection.py \\
        --device cpu --size 16K

Integrates the MONC Piacsek-Williams advection source terms over several
steps (forward Euler on the wind fields), using the generated CUDA
dataflow kernels on the H100, and reports MPt/s per application.
``--fused-loop`` compiles the whole time loop into one program whose
fields stay resident and pre-padded on the device between steps (the
paper's device-resident inter-iteration dataflow) and reports steps/sec
for both execution modes.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.apps import pw_advection, pw_advection_update
from repro_torch.core import compile_program, run_time_loop
from repro_torch.core.pipeline import resolve_device

SIZES = {"16K": (16, 16, 64), "1M": (128, 64, 128), "8M": (256, 256, 128),
         "32M": (512, 256, 256)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1M", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "torch_fused", "torch_naive"])
    ap.add_argument("--fused-loop", action="store_true",
                    help="compile the whole time loop on device and compare "
                         "steps/sec against the host-driven loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grid = SIZES[args.size]
    p = pw_advection()
    ex = compile_program(p, grid, backend=args.backend, device=device)
    print("plan:", ex.plan.describe())

    rng = np.random.default_rng(0)
    fields = {f: torch.from_numpy(rng.normal(size=grid).astype(np.float32)
                                  * 0.1).to(device)
              for f in ("u", "v", "w")}
    scalars = {"tcx": np.float32(0.05), "tcy": np.float32(0.05)}
    coeffs = {c: torch.from_numpy(np.linspace(0.9, 1.1, grid[2]).astype(
        np.float32)).to(device) for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
    dt = 0.1
    pts = float(np.prod(grid))
    update = pw_advection_update(dt)

    if args.fused_loop:
        exN = compile_program(p, grid, backend=args.backend,
                              steps=args.steps, update=update, device=device)
        print("time loop:", exN.time_spec.describe())
        result = {}
        for label, fn in (
                ("host loop ", lambda: run_time_loop(
                    ex, dict(fields), scalars, coeffs, args.steps, update)),
                ("fused loop", lambda: exN(fields, scalars, coeffs))):
            fn()                                  # warm-up (kernel build)
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            el = time.perf_counter() - t0
            print(f"{label}: {args.steps} steps in {el*1e3:8.1f} ms  "
                  f"{args.steps/el:8.2f} steps/s  "
                  f"{pts*args.steps/el/1e6:8.2f} MPt/s")
            assert bool(torch.isfinite(out["u"]).all())
            result[label.strip()] = {k: v.cpu().numpy()
                                     for k, v in out.items()}
        print("pw_advection fused-loop OK")
        return result

    for step in range(args.steps):
        t0 = time.perf_counter()
        src = ex(fields, scalars, coeffs)
        fields = update(fields, src)
        _sync(device)
        el = time.perf_counter() - t0
        umax = float(fields["u"].abs().max())
        print(f"step {step}: {el*1e3:8.1f} ms  {pts/el/1e6:8.2f} MPt/s  "
              f"|u|max={umax:.4f}")
    assert np.isfinite(umax)
    print("pw_advection OK")
    return {k: v.cpu().numpy() for k, v in fields.items()}


if __name__ == "__main__":
    main()
