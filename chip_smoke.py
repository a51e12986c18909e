#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path — ``repro_torch.compile_program`` on the
paper's two apps, block schedule, generated CUDA fuse-group kernels — at
the paper's sizes, through the entry points a user calls:

1. ``pw_advection`` at 512x256x256 (32M points), float32, zero and
   periodic boundaries: a single step and a fused ``steps=10`` loop with
   ``pw_advection_update(0.1)``;
2. ``tracer_advection`` at 256x256x128 (8M points), zero boundary: a single
   step and a fused ``steps=4`` loop;
3. ``pw_advection`` in bfloat16 at 256x256x128, a single step.

Every path is compared with the same compile on ``backend="torch_fused"``
on the card; each group kernel is held against its plain PyTorch version
on the inputs the path gives it; and a small grid is compared with the CPU
oracle.  Every tolerance is relative to each output field's own max abs:
1e-5 for a float32 single step, 1e-4 for fused carries, and 2e-2 (a few
bfloat16 ulps) for bfloat16.  Launch counts are zeroed just
before each path and read just after.  Kernel, plain-version and
end-to-end times come from CUDA events (warm-up, then the median of 5).

Usage, from the root of a checkout (the kernels build with nvcc into
``build/repro_torch_kernels/`` on first use):

    python3 chip_smoke.py [--seed 0]

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches, error and times.  Everything measured is
also written to ``--out`` (``build/chip_smoke.json`` by default).  Any
failure exits
non-zero without a result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PW_GRID = (512, 256, 256)
TRACER_GRID = (256, 256, 128)
BF16_GRID = (256, 256, 128)
SMALL_GRID = (20, 18, 100)
PW_STEPS, TRACER_STEPS = 10, 4


def log(*a):
    print(*a, flush=True)


def make_inputs(p, grid, seed):
    """Seeded numpy inputs as the repo's benchmarks make them: normal
    fields, ``e3t`` >= 1, ``msk`` in {0, 1}, scalars 0.1, normal coeffs;
    pw fields scaled by 0.1 so ten Euler steps stay bounded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    scale = 0.1 if p.name == "pw_advection" else 1.0
    fields = {f: rng.standard_normal(size=grid, dtype=np.float32) * scale
              for f in p.input_fields()}
    if "e3t" in fields:
        fields["e3t"] = np.abs(fields["e3t"]) + 1.0
    if "msk" in fields:
        fields["msk"] = (fields["msk"] > 0).astype(np.float32)
    if "t" in fields:
        fields["t"] += 15.0
    scalars = {s: np.float32(0.1) for s in p.scalars}
    coeffs = {c: rng.standard_normal(size=(grid[ax],), dtype=np.float32)
              for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


def time_ms(fn, inner=1, reps=5, warmup=2):
    """Median over ``reps`` of CUDA-event time per call of ``fn``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return statistics.median(ts)


def rel_err(got, want):
    """Max abs difference over the max abs of ``want`` (no floor, so a
    field of small values is held to its own scale)."""
    g, w = got.float(), want.float()
    err, scale = float((g - w).abs().max()), float(w.abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "chip_smoke.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import compile_program, hw
    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection, tracer_advection_update)
    from repro_torch.core import boundary as bc
    from repro_torch.core.ir import count_flops
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import build, stencil3d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- paths
    paths = [
        dict(name="pw_zero_step", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_periodic_step", app=pw_advection, boundary="periodic",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_zero_fused10", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=PW_STEPS, tol=1e-4,
             update=pw_advection_update(0.1)),
        dict(name="pw_periodic_fused10", app=pw_advection,
             boundary="periodic", grid=PW_GRID, dtype="float32",
             steps=PW_STEPS, tol=1e-4, update=pw_advection_update(0.1)),
        dict(name="tracer_zero_step", app=tracer_advection, boundary="zero",
             grid=TRACER_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="tracer_zero_fused4", app=tracer_advection,
             boundary="zero", grid=TRACER_GRID, dtype="float32",
             steps=TRACER_STEPS, tol=1e-4, update=tracer_advection_update()),
        dict(name="pw_bf16_step", app=pw_advection, boundary="zero",
             grid=BF16_GRID, dtype="bfloat16", steps=None, tol=2e-2),
    ]
    t0 = time.perf_counter()
    for ph in paths:
        ph["p"] = ph["app"](ph["boundary"])
        kw = {} if ph["steps"] is None else dict(steps=ph["steps"],
                                                 update=ph["update"])
        ph["ex"] = compile_program(ph["p"], ph["grid"], dtype=ph["dtype"],
                                   **kw)
        ph["plain_ex"] = compile_program(ph["p"], ph["grid"],
                                         dtype=ph["dtype"],
                                         backend="torch_fused", **kw)
    sources = [ph["ex"].kernels[0].module.source for ph in paths]
    build.build_many(sources)
    log(f"built {len(set(sources))} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in dict.fromkeys(sources):
        regs = [ln.strip() for ln in build.ptxas_report(src).splitlines()
                if "registers" in ln or "spill" in ln]
        log("ptxas:", " | ".join(regs))

    # ------------------------------------------- main path, counted launches
    for ph in paths:
        f, s, c = make_inputs(ph["p"], ph["grid"], args.seed)
        ph["inputs"] = inputs_from_numpy(f, s, c, "cuda", ph["dtype"])
    for ph in paths:
        stencil3d.launches = 0
        out = ph["ex"](*ph["inputs"])
        torch.cuda.synchronize()
        ph["launches"] = stencil3d.launches
        ph["out"] = out
        if ph["launches"] < 1:
            raise SystemExit(f"{ph['name']}: no kernel launch on the path")
    for ph in paths:
        want = ph["plain_ex"](*ph["inputs"])
        got = ph["out"]
        if set(got) != set(want):
            raise SystemExit(f"{ph['name']}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
        for k in want:
            if tuple(got[k].shape) != ph["grid"] or \
                    not bool(torch.isfinite(got[k].float()).all()):
                raise SystemExit(f"{ph['name']}/{k}: bad shape or values")
        ph["e2e_err"] = max(rel_err(got[k], want[k]) for k in want)
        log(f"{ph['name']}: launches {ph['launches']}, vs torch_fused "
            f"max rel err {ph['e2e_err']:.3e} (tol {ph['tol']})")
        if ph["e2e_err"] > ph["tol"]:
            raise SystemExit(f"{ph['name']}: disagrees with torch_fused")
        del ph["out"]

    # small grid against the CPU oracle
    for app in (pw_advection, tracer_advection):
        p = app()
        f, s, c = make_inputs(p, SMALL_GRID, args.seed)
        got = compile_program(p, SMALL_GRID)(f, s, c)
        want = compile_program(p, SMALL_GRID, backend="torch_naive",
                               device="cpu")(f, s, c)
        err = max(rel_err(got[k].cpu(), want[k]) for k in want)
        log(f"{p.name} {SMALL_GRID}: card vs CPU oracle max rel err "
            f"{err:.3e} (tol 1e-5)")
        if err > 1e-5:
            raise SystemExit(f"{p.name}: card disagrees with the CPU oracle")

    # ------------------------------- kernel vs plain version, and timings
    rows = []
    for ph in paths:
        p, ex, grid = ph["p"], ph["ex"], ph["grid"]
        call = ex.kernels[0]
        fields, scalars, coeffs = ph["inputs"]
        bnd = p.boundaries()
        spec = ex.time_spec
        if spec is None:
            padded = {f: bc.pad_field(fields[f], call.halo_lo, call.halo_hi,
                                      bnd[f], align_hi=call.align_hi
                                      ).contiguous()
                      for f in call.group_inputs}
            ipad = None
        else:                      # the fused loop's carry buffers
            al = spec.align_hi
            fp = spec.field_pad
            padded = {f: bc.pad_field(fields[f], fp[f][:, 0],
                                      [int(fp[f][a, 1]) - al[a]
                                       for a in range(3)],
                                      bnd[f], align_hi=al).contiguous()
                      for f in call.group_inputs}
            ipad = {f: fp[f] for f in call.group_inputs}
        pc = {c: bc.pad_coeff(coeffs[c], call.pad_lo[call.coeff_axis[c]],
                              call.pad_hi[call.coeff_axis[c]],
                              bc.coeff_mode(p)).contiguous()
              for c in call.group_coeffs}
        svec = [float(scalars[k]) for k in p.scalars]

        def kernel():
            return call(padded, svec, pc, input_pad=ipad)

        def plain():
            return stencil3d.group_call_reference(call, padded, svec, pc,
                                                  input_pad=ipad)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max(float((got[k].float() - want[k].float()).abs().max())
                  for k in want)
        rel = max(rel_err(got[k], want[k]) for k in want)
        log(f"{ph['name']}: kernel vs plain max abs err {err:.3e}, max rel "
            f"err {rel:.3e} (tol {ph['tol']} of each field's max abs)")
        if rel > ph["tol"]:
            raise SystemExit(f"{ph['name']}: kernel disagrees with its "
                             "plain version")
        del got, want
        ms = time_ms(kernel, inner=10)
        plain_ms = time_ms(plain, inner=1)
        step_ms = time_ms(lambda: ex(*ph["inputs"]))
        plain_step_ms = time_ms(lambda: ph["plain_ex"](*ph["inputs"]))
        steps = ph["steps"] or 1
        pts = int(grid[0] * grid[1] * grid[2])
        # each input's grid points read once, each output written once (the
        # halo and alignment slabs of the windows are padding, not data)
        in_bytes = len(call.group_inputs) * pts * call.itemsize
        in_bytes += sum(grid[call.coeff_axis[c]] * call.itemsize
                        for c in call.group_coeffs)
        out_bytes = pts * call.itemsize * len(call.group_outputs)
        flops = pts * sum(count_flops(p.ops[i].expr) for i in call.group)
        # the H100's published peaks (data sheet, 700 W); kernels compute
        # in float32 whatever the storage type
        t_bytes = (in_bytes + out_bytes) / hw.H100.hbm_bandwidth * 1e3
        t_ops = flops / hw.H100.peak_f32_flops * 1e3
        rows.append({
            "name": f"stencil3d.build_group_call[{ph['name']} "
                    f"{'x'.join(map(str, grid))} {ph['dtype']}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/stencil3d.py",
            "replaces": stencil3d.REPLACES,
            "launches": ph["launches"],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "step_ms": step_ms / steps,
            "plain_backend_step_ms": plain_step_ms / steps,
            "block": list(call.block),
            "smem_bytes": call.smem_bytes,
            "gen_flops_per_point": call.flops_per_point(),
            "min_bytes": in_bytes + out_bytes,
        })
        log(f"{ph['name']}: kernel {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f}"
            f" ms by {rows[-1]['bound_by']}), plain {plain_ms:.3f} ms, "
            f"end-to-end {step_ms / steps:.4f} ms/step, torch_fused "
            f"{plain_step_ms / steps:.4f} ms/step")

    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": rows,
              "paths": [{k: ph[k] for k in ("name", "grid", "dtype",
                                             "boundary", "steps",
                                             "launches", "e2e_err")}
                        for ph in paths]}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
