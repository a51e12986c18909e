"""Quickstart: write a stencil, let the compiler structure it for the H100.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py \\
        --device cpu --grid 8,8,32

Builds a 3-D 7-point diffusion stencil through the frontend (the PSyclone
role), lowers it through all three backends (``torch_naive``,
``torch_fused`` and ``cuda``, the generated fuse-group kernel), checks
they agree, and prints the plan the auto-scheduler derived (the
HLS-dialect analogue) with the shared memory one CTA of its kernel
claims.  ``--device cpu`` runs the kernel's plain PyTorch version.
"""

import argparse

import numpy as np

from repro_torch.core import ProgramBuilder, compile_program
from repro_torch.core.pipeline import resolve_device
from repro_torch.core.schedule import auto_plan, smem_cost


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--grid", default="64,64,256",
                    help="grid extents, comma-separated")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. write the maths (stencil dialect analogue) ----------------------
    b = ProgramBuilder("diffusion", ndim=3)
    u = b.input("u")
    alpha = b.scalar("alpha")
    out = b.output("u_next")
    b.define(out, u[0, 0, 0] + alpha * (
        u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]
        + u[0, 0, 1] + u[0, 0, -1] - 6.0 * u[0, 0, 0]))
    prog = b.build()
    print(prog.to_text())

    # -- 2. auto-plan (HLS dialect analogue) --------------------------------
    grid = tuple(int(g) for g in args.grid.split(","))
    plan = auto_plan(prog, grid)
    print("\nplan:", plan.describe())
    print(f"shared-memory claim: {smem_cost(prog, plan, grid) / 2**10:.2f} "
          "KiB a CTA")

    # -- 3. run all three backends ------------------------------------------
    rng = np.random.default_rng(0)
    fields = {"u": rng.normal(size=grid).astype(np.float32)}
    scalars = {"alpha": np.float32(0.1)}

    results = {}
    for backend in ("torch_naive", "torch_fused", "cuda"):
        ex = compile_program(prog, grid, backend=backend, device=device)
        results[backend] = ex(fields, scalars)["u_next"].cpu().numpy()

    for k in ("torch_fused", "cuda"):
        ok = np.allclose(results["torch_naive"], results[k], atol=1e-5)
        print(f"{k} matches oracle: {ok}")
        assert ok, k
    print("quickstart OK")
    return results


if __name__ == "__main__":
    main()
