"""Stencil serving example: mixed-shape traffic through the async engine.

    PYTHONPATH=src python examples_torch/serve_stencils.py --requests 16
    PYTHONPATH=src python examples_torch/serve_stencils.py --backend cuda
    PYTHONPATH=src python examples_torch/serve_stencils.py \\
        --device cpu --requests 4

A stream of PW-advection requests with four different grid shapes goes
through one StencilEngine.  The engine rounds each grid up to a
lane-quantised bucket, compiles one executor per bucket (grids that share
a bucket share an executor — sizes enter as scalars), micro-batches
same-bucket requests (with ``--backend cuda`` each generated kernel
launches once a step for the whole batch), and answers on futures.  Every
answer is checked against a direct ``compile_program`` at the request's
true grid.
"""

import argparse

import numpy as np

from repro_torch.apps import pw_advection, pw_advection_update
from repro_torch.core import compile_program
from repro_torch.core.pipeline import resolve_device
from repro_torch.serve import StencilEngine, StencilRequest

GRIDS = [(16, 16, 16), (12, 14, 16), (16, 16, 24), (10, 16, 16)]


def make_request(p, update, grid, rng, steps):
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in ("u", "v", "w")}
    scalars = {"tcx": 0.05, "tcy": 0.05}
    coeffs = {c: np.linspace(0.9, 1.1, grid[2]).astype(np.float32)
              for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
    return StencilRequest(program=p, fields=fields, scalars=scalars,
                          coeffs=coeffs, steps=steps, update=update,
                          update_key="pw/dt=0.1")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--backend", default="torch_fused",
                    choices=["torch_fused", "torch_naive", "cuda"])
    ap.add_argument("--boundary", default="zero",
                    choices=["zero", "periodic"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p = pw_advection(boundary=args.boundary)
    update = pw_advection_update(0.1)
    rng = np.random.default_rng(0)
    reqs = [make_request(p, update, GRIDS[i % len(GRIDS)], rng, args.steps)
            for i in range(args.requests)]

    answers = []
    with StencilEngine(backend=args.backend, max_batch=4, window_s=0.005,
                       device=device) as eng:
        results = eng.map(reqs, timeout=600)
        for req, res in zip(reqs, results):
            grid = req.grid()
            ref = compile_program(p, grid, backend=args.backend,
                                  steps=args.steps, update=update,
                                  device=device)(
                req.fields, req.scalars, req.coeffs)
            err = max(float((ref[k] - res.outputs[k]).abs().max())
                      for k in ref)
            print(f"grid {grid} -> bucket {res.bucket.bucket} "
                  f"batch={res.batch_size} lat={res.latency_ms:.1f}ms "
                  f"maxerr={err:.2e}")
            assert err < 1e-5
            answers.append({k: v.cpu().numpy()
                            for k, v in res.outputs.items()})
        s = eng.stats
        print(f"{s.completed} requests, {s.compiles} compiles, "
              f"hit_rate={s.cache_hit_rate():.2f} "
              f"occupancy={s.occupancy():.2f} "
              f"throughput={s.throughput():.1f} req/s "
              f"p50={s.p50_ms():.1f}ms p99={s.p99_ms():.1f}ms")
    print("serve_stencils OK")
    return answers


if __name__ == "__main__":
    main()
