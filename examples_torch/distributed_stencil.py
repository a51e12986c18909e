"""Distributed stencil run through the unified compile pipeline.

``compile_program`` is the single entry point for local AND domain-
decomposed execution: pass ``mesh=``/``mesh_axes=`` to cut the grid over a
mesh of devices, add ``steps=N`` to run the whole time loop with each
step's halo exchange between the shards' resident blocks, and
``boundary="periodic"`` to run the same program on a torus.

    PYTHONPATH=src python examples_torch/distributed_stencil.py
    PYTHONPATH=src python examples_torch/distributed_stencil.py --devices
    PYTHONPATH=src python examples_torch/distributed_stencil.py \\
        --device cpu --grid 8,8,32

The mesh is (2, 2, 2).  By default all eight shards share one device
(``--device``, the card unless ``--device cpu``), which measures the cost
of sharding and of the device-local exchange, not of a link between
cards; ``--devices`` takes eight cards in order, one shard a card.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.apps import pw_advection, pw_advection_update
from repro_torch.core import compile_program, run_time_loop
from repro_torch.core.pipeline import resolve_device
from repro_torch.dist import make_auto_mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="64,64,128",
                    help="grid extents, comma-separated")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the device every shard shares (default: the card)")
    ap.add_argument("--devices", action="store_true",
                    help="one card a shard, cuda:0 to cuda:7 in order")
    args = ap.parse_args(argv)

    if args.devices:
        mesh = make_auto_mesh((2, 2, 2), ("X", "Y", "Z"))
        device = torch.device("cuda:0")
        print("mesh (2, 2, 2): one card a shard, cuda:0 to cuda:7")
    else:
        device = resolve_device(args.device)
        mesh = make_auto_mesh((2, 2, 2), ("X", "Y", "Z"),
                              devices=[device] * 8)
        print(f"mesh (2, 2, 2): all 8 shards share {device} (the exchange "
              "is a copy on that device, not a link between cards)")
    grid = tuple(int(g) for g in args.grid.split(","))
    steps = args.steps
    rng = np.random.default_rng(0)
    # modest amplitudes: the PW scheme is quadratic, and forward Euler on
    # O(1) winds amplifies rounding noise across steps
    fields = {f: torch.from_numpy(rng.normal(size=grid).astype(np.float32)
                                  * 0.1).to(device) for f in ("u", "v", "w")}
    scalars = {"tcx": np.float32(0.05), "tcy": np.float32(0.05)}
    coeffs = {c: torch.from_numpy(np.linspace(0.9, 1.1, grid[2]).astype(
        np.float32)).to(device) for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
    update = pw_advection_update(0.05)
    result = {}

    # --- one sharded step: same API as a local compile, plus mesh= -------
    p = pw_advection()
    dist = compile_program(p, grid, backend="cuda", mesh=mesh,
                           mesh_axes=("X", "Y", "Z"))
    print(f"{dist.shard.describe()}\nplan {dist.plan.describe()}")
    out = dist(fields, scalars, coeffs)
    ref = compile_program(p, grid, backend="torch_naive", device=device)(
        fields, scalars, coeffs)
    for k in ref:
        err = float((out[k].to(device) - ref[k]).abs().max())
        print(f"single-step {k}: sharded-vs-local max err = {err:.2e}")
        assert err < 1e-4
        result[f"single/{k}"] = out[k].cpu().numpy()

    # --- the fused distributed time loop: N steps, halos refreshed in it --
    for boundary in ("zero", "periodic"):
        pb = pw_advection(boundary=boundary)
        exN = compile_program(pb, grid, backend="torch_fused", mesh=mesh,
                              mesh_axes=("X", "Y", "Z"), steps=steps,
                              update=update)
        exN(fields, scalars, coeffs)                          # warm
        _sync(device)
        t0 = time.perf_counter()
        got = exN(fields, scalars, coeffs)
        _sync(device)
        dt = time.perf_counter() - t0
        want = run_time_loop(compile_program(pb, grid, backend="torch_fused",
                                             device=device),
                             dict(fields), scalars, coeffs, steps, update)
        err = max(float((got[k].to(device) - want[k]).abs().max())
                  for k in want)
        print(f"fused loop ({boundary}): {steps} distributed steps, "
              f"{steps / dt:.1f} steps/s, max err = {err:.2e}")
        assert err < 1e-4
        result.update({f"{boundary}/{k}": v.cpu().numpy()
                       for k, v in got.items()})
    print("distributed_stencil OK")
    return result


if __name__ == "__main__":
    main()
