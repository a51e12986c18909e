#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path — ``repro_torch.compile_program`` on the
paper's two apps, through the entry points a user calls — at the paper's
sizes, under both schedules:

Block schedule (generated CUDA fuse-group kernels):

1. ``pw_advection`` at 512x256x256 (32M points), float32, zero and
   periodic boundaries: a single step and a fused ``steps=10`` loop with
   ``pw_advection_update(0.1)``;
2. ``tracer_advection`` at 256x256x128 (8M points), zero boundary: a single
   step and a fused ``steps=4`` loop;
3. ``pw_advection`` in bfloat16 at 256x256x128, a single step.

Stream schedule (``schedule="stream"``, generated CUDA sweep kernels):

4. ``pw_advection`` at 512x256x256, float32: zero and periodic single
   steps; zero fused ``steps=10`` at ``time_tile`` 1, 2 and 4 (4 runs two
   chained sweeps and a remainder chain of 2); periodic fused ``steps=10``
   at ``time_tile=2``, which legalisation demotes to 1 with a warning; a
   zero single step at ``plane_tile=2``;
5. ``tracer_advection`` at 256x256x128: zero single step (four regions),
   zero fused ``steps=4``, periodic single step (eight regions);
6. ``pw_advection`` in bfloat16 at 256x256x128, a zero single step.

Every path is compared with the same compile on ``backend="torch_fused"``
on the card, and each stream path with the block path of the same program,
boundary, grid and steps where there is one.  Each block path's first group
kernel, and every sweep kernel of a stream path (a chain's remainder
included) on the inputs the path gives it, is held against its plain
PyTorch version; small grids are compared with the CPU oracle.  Every
tolerance is relative to each output field's own max abs: 1e-5 for a
float32 single step, 1e-4 for fused loops, and 2e-2 (a few bfloat16 ulps)
for bfloat16.  Launch counts are zeroed just before each path and read just
after.  Kernel and end-to-end times come from CUDA events (warm-up, then
the median of 5); a stream path's kernel, plain-version and bound times
are per time step (a chained sweep's divided by its depth), and its plain
version is timed in the one run that checks it.

Usage, from the root of a checkout (the kernels build with nvcc into
``build/repro_torch_kernels/`` on first use):

    python3 chip_smoke.py [--seed 0]

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches, error and times.  Everything measured is
also written to ``--out`` (``build/chip_smoke.json`` by default).  Any
failure exits non-zero without a result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
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


def block_paths(pw_advection, pw_advection_update, tracer_advection,
                tracer_advection_update):
    """The block schedule's paths (each runs the generated fuse-group
    kernels)."""
    pw_upd = pw_advection_update(0.1)
    tr_upd = tracer_advection_update()
    return [
        dict(name="pw_zero_step", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_periodic_step", app=pw_advection, boundary="periodic",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_zero_fused10", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=PW_STEPS, tol=1e-4,
             update=pw_upd),
        dict(name="pw_periodic_fused10", app=pw_advection,
             boundary="periodic", grid=PW_GRID, dtype="float32",
             steps=PW_STEPS, tol=1e-4, update=pw_upd),
        dict(name="tracer_zero_step", app=tracer_advection, boundary="zero",
             grid=TRACER_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="tracer_zero_fused4", app=tracer_advection,
             boundary="zero", grid=TRACER_GRID, dtype="float32",
             steps=TRACER_STEPS, tol=1e-4, update=tr_upd),
        dict(name="pw_bf16_step", app=pw_advection, boundary="zero",
             grid=BF16_GRID, dtype="bfloat16", steps=None, tol=2e-2),
    ]


def stream_paths(pw_advection, pw_advection_update, tracer_advection,
                 tracer_advection_update):
    """The stream schedule's paths (each runs the generated sweep kernels);
    ``eff`` is the (time_tile, plane_tile) legalisation must keep, and
    ``demoted`` marks a request it must demote with a warning."""
    pw_upd = pw_advection_update(0.1)
    tr_upd = tracer_advection_update()
    pw = dict(app=pw_advection, grid=PW_GRID, dtype="float32")
    fused = dict(steps=PW_STEPS, tol=1e-4, update=pw_upd)
    tr = dict(app=tracer_advection, grid=TRACER_GRID, dtype="float32")
    return [{"schedule": "stream", "eff": (1, 1)} | ph for ph in [
        dict(name="pw_zero_stream_step", boundary="zero", steps=None,
             tol=1e-5, **pw),
        dict(name="pw_periodic_stream_step", boundary="periodic",
             steps=None, tol=1e-5, **pw),
        dict(name="pw_zero_stream_fused10_T1", boundary="zero",
             time_tile=1, **fused, **pw),
        dict(name="pw_zero_stream_fused10_T2", boundary="zero",
             time_tile=2, **fused, **pw) | dict(eff=(2, 1)),
        dict(name="pw_zero_stream_fused10_T4", boundary="zero",
             time_tile=4, **fused, **pw) | dict(eff=(4, 1)),
        dict(name="pw_periodic_stream_fused10_T2", boundary="periodic",
             time_tile=2, demoted=True, **fused, **pw),
        dict(name="pw_zero_stream_step_P2", boundary="zero", steps=None,
             tol=1e-5, plane_tile=2, **pw) | dict(eff=(1, 2)),
        dict(name="tracer_zero_stream_step", boundary="zero", steps=None,
             tol=1e-5, **tr),
        dict(name="tracer_zero_stream_fused4", boundary="zero",
             steps=TRACER_STEPS, tol=1e-4, update=tr_upd, **tr),
        dict(name="tracer_periodic_stream_step", boundary="periodic",
             steps=None, tol=1e-5, **tr),
        dict(name="pw_bf16_stream_step", app=pw_advection, boundary="zero",
             grid=BF16_GRID, dtype="bfloat16", steps=None, tol=2e-2),
    ]]


def config_key(ph) -> tuple:
    """Paths with equal keys compute the same function."""
    return (ph["p"].name, ph["boundary"], ph["grid"], ph["dtype"],
            ph["steps"])


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

    from repro_torch import compile_program
    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection, tracer_advection_update)
    from repro_torch.core import TileDemotionWarning
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import build, stencil3d, stream3d

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- paths
    apps = (pw_advection, pw_advection_update, tracer_advection,
            tracer_advection_update)
    paths = ([dict(ph, schedule="block") for ph in block_paths(*apps)]
             + stream_paths(*apps))
    t0 = time.perf_counter()
    plain_ex = {}
    for ph in paths:
        ph["p"] = ph["app"](ph["boundary"])
        kw = {} if ph["steps"] is None else dict(steps=ph["steps"],
                                                 update=ph["update"])
        if ph["schedule"] == "stream":
            kw.update({k: ph[k] for k in ("time_tile", "plane_tile")
                       if k in ph}, schedule="stream")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            ph["ex"] = compile_program(ph["p"], ph["grid"],
                                       dtype=ph["dtype"], **kw)
        demoted = any(issubclass(w.category, TileDemotionWarning)
                      for w in seen)
        if demoted != bool(ph.get("demoted")):
            raise SystemExit(f"{ph['name']}: TileDemotionWarning "
                             f"{'raised' if demoted else 'missing'}")
        if ph["schedule"] == "stream":
            st = ph["ex"].plan.stream
            if (st.time_tile, st.plane_tile) != ph["eff"]:
                raise SystemExit(f"{ph['name']}: effective tiles "
                                 f"{(st.time_tile, st.plane_tile)} != "
                                 f"{ph['eff']}")
        key = config_key(ph)
        if key not in plain_ex:
            kw.pop("schedule", None)
            kw.pop("time_tile", None)
            kw.pop("plane_tile", None)
            plain_ex[key] = compile_program(ph["p"], ph["grid"],
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
    inputs = {}
    for ph in paths:
        ikey = (ph["p"].name, ph["grid"], ph["dtype"])
        if ikey not in inputs:
            f, s, c = make_inputs(ph["p"], ph["grid"], args.seed)
            inputs[ikey] = inputs_from_numpy(f, s, c, "cuda", ph["dtype"])
        ph["inputs"] = inputs[ikey]
    for ph in paths:
        stencil3d.launches = stream3d.launches = 0
        out = ph["ex"](*ph["inputs"])
        torch.cuda.synchronize()
        ph["launches"] = (stream3d.launches if ph["schedule"] == "stream"
                          else stencil3d.launches)
        ph["out"] = out
        if ph["launches"] < 1:
            raise SystemExit(f"{ph['name']}: no kernel launch on the path")
    wants, block_out = {}, {}
    for ph in paths:
        key = config_key(ph)
        if key not in wants:
            wants[key] = plain_ex[key](*ph["inputs"])
        want, got = wants[key], ph.pop("out")
        if set(got) != set(want):
            raise SystemExit(f"{ph['name']}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
        for k in want:
            if tuple(got[k].shape) != ph["grid"] or \
                    not bool(torch.isfinite(got[k].float()).all()):
                raise SystemExit(f"{ph['name']}/{k}: bad shape or values")
        ph["e2e_err"] = max(rel_err(got[k], want[k]) for k in want)
        msg = (f"{ph['name']}: launches {ph['launches']}, vs torch_fused "
               f"max rel err {ph['e2e_err']:.3e}")
        if ph["schedule"] == "block":
            block_out[key] = got
        elif key in block_out:
            ph["block_err"] = max(rel_err(got[k], block_out[key][k])
                                  for k in want)
            msg += f", vs block path {ph['block_err']:.3e}"
            if ph["block_err"] > ph["tol"]:
                raise SystemExit(f"{ph['name']}: disagrees with the block "
                                 "path")
        log(msg + f" (tol {ph['tol']})")
        if ph["e2e_err"] > ph["tol"]:
            raise SystemExit(f"{ph['name']}: disagrees with torch_fused")
    del wants, block_out

    # small grids against the CPU oracle
    for app in (pw_advection, tracer_advection):
        p = app()
        f, s, c = make_inputs(p, SMALL_GRID, args.seed)
        want = compile_program(p, SMALL_GRID, backend="torch_naive",
                               device="cpu")(f, s, c)
        for schedule in ("block", "stream"):
            got = compile_program(p, SMALL_GRID, schedule=schedule)(f, s, c)
            err = max(rel_err(got[k].cpu(), want[k]) for k in want)
            log(f"{p.name} {SMALL_GRID} {schedule}: card vs CPU oracle max "
                f"rel err {err:.3e} (tol 1e-5)")
            if err > 1e-5:
                raise SystemExit(f"{p.name} {schedule}: card disagrees with "
                                 "the CPU oracle")

    # ------------------------------- kernel vs plain version, and timings
    rows, plain_step = [], {}
    for ph in paths:
        ex = ph["ex"]
        step_ms = time_ms(lambda: ex(*ph["inputs"]))
        key = config_key(ph)
        if key not in plain_step:
            plain_step[key] = time_ms(lambda: plain_ex[key](*ph["inputs"]))
        if ph["schedule"] == "stream":
            row = stream_row(ph, torch, stream3d)
        else:
            row = block_row(ph, torch, stencil3d)
        steps = ph["steps"] or 1
        row.update(step_ms=step_ms / steps,
                   plain_backend_step_ms=plain_step[key] / steps)
        rows.append(row)
        log(f"{ph['name']}: kernel {row['ms']:.4f} ms/step (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}), plain "
            f"{row['plain_ms']:.3f} ms, end-to-end {row['step_ms']:.4f} "
            f"ms/step, torch_fused {row['plain_backend_step_ms']:.4f} "
            f"ms/step, launches/step {row['launches_per_step']:g}")

    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": rows,
              "paths": [{k: ph.get(k) for k in (
                  "name", "schedule", "grid", "dtype", "boundary", "steps",
                  "time_tile", "plane_tile", "eff", "launches", "e2e_err",
                  "block_err")} for ph in paths]}
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


def bound(in_bytes, out_bytes, flops):
    """(bound ms, what bounds it) on the H100's published peaks (data sheet,
    700 W): bytes over 3.35 TB/s, float32 operations over 67 TFLOP/s (the
    kernels compute in float32 whatever the storage type)."""
    from repro_torch import hw

    t_bytes = (in_bytes + out_bytes) / hw.H100.hbm_bandwidth * 1e3
    t_ops = flops / hw.H100.peak_f32_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def block_row(ph, torch, stencil3d) -> dict:
    """The path's first fuse-group kernel against its plain version on the
    inputs the path gives it, and its times."""
    from repro_torch.core import boundary as bc
    from repro_torch.core.ir import count_flops

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
    pts = int(grid[0] * grid[1] * grid[2])
    # each input's grid points read once, each output written once (the
    # halo and alignment slabs of the windows are padding, not data)
    in_bytes = len(call.group_inputs) * pts * call.itemsize
    in_bytes += sum(grid[call.coeff_axis[c]] * call.itemsize
                    for c in call.group_coeffs)
    out_bytes = pts * call.itemsize * len(call.group_outputs)
    flops = pts * sum(count_flops(p.ops[i].expr) for i in call.group)
    bound_ms, bound_by = bound(in_bytes, out_bytes, flops)
    return {
        "name": f"stencil3d.build_group_call[{ph['name']} "
                f"{'x'.join(map(str, grid))} {ph['dtype']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil3d.py",
        "replaces": stencil3d.REPLACES,
        "launches": ph["launches"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_per_step": ph["launches"] / (ph["steps"] or 1),
        "block": list(call.block),
        "smem_bytes": call.smem_bytes,
        "gen_flops_per_point": call.flops_per_point(),
        "min_bytes": in_bytes + out_bytes,
    }


def stream_row(ph, torch, stream3d) -> dict:
    """Every sweep kernel of the path against its plain version on the
    arguments the path gives it (captured from one more run), and its
    times per step: each call's time times its launches in the path, over
    the path's steps."""
    from repro_torch.core.ir import count_flops

    p, ex, grid = ph["p"], ph["ex"], ph["grid"]
    captured = {}
    launch = stream3d.StreamCall.__call__

    def capture(call, padded, svec=None, pc=None, origin=None,
                input_pad=None):
        n, args = captured.get(id(call), (0, None))
        if args is None:
            args = ({f: t.clone() for f, t in padded.items()}, svec,
                    {c: t.clone() for c, t in (pc or {}).items()}, origin,
                    input_pad)
        captured[id(call)] = (n + 1, args)
        return launch(call, padded, svec, pc, origin, input_pad)

    stream3d.StreamCall.__call__ = capture
    try:
        ex(*ph["inputs"])
    finally:
        stream3d.StreamCall.__call__ = launch
    torch.cuda.synchronize()
    steps = ph["steps"] or 1
    pts = int(grid[0] * grid[1] * grid[2])
    err = rel = ms = plain_ms = in_bytes = out_bytes = flops = 0.0
    calls = []
    for call in ex.kernels:
        n, (padded, svec, pc, origin, ipad) = captured[id(call)]

        def kernel(call=call, padded=padded, svec=svec, pc=pc,
                   origin=origin, ipad=ipad):
            return call(padded, svec, pc, origin, ipad)

        got = kernel()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = stream3d.stream_call_reference(call, padded, svec, pc, origin,
                                              ipad)
        e1.record()
        e1.synchronize()
        c_plain = e0.elapsed_time(e1)
        c_err = max(float((got[k].float() - want[k].float()).abs().max())
                    for k in want)
        c_rel = max(rel_err(got[k], want[k]) for k in want)
        del got, want
        c_ms = time_ms(kernel, inner=10)
        # each region input's grid points read once and each stored field
        # written once a sweep; operations: every op and update a stage
        c_in = (len(call.group_inputs) * pts * call.itemsize
                + sum(grid[call.coeff_axis[c]] * call.itemsize
                      for c in call.group_coeffs))
        c_out = len(call.group_outputs) * pts * call.itemsize
        c_flops = pts * call.T * (
            sum(count_flops(op.expr) for op in call.ops)
            + sum(count_flops(e) for e in (call.update_exprs or {}).values()))
        err, rel = max(err, c_err), max(rel, c_rel)
        ms += c_ms * n / steps
        plain_ms += c_plain * n / steps
        in_bytes += c_in * n / steps
        out_bytes += c_out * n / steps
        flops += c_flops * n / steps
        cta = call.cta
        calls.append({"region": list(call.region.ops), "time_tile": call.T,
                      "plane_tile": call.P, "launches_per_run": n,
                      "ms": c_ms, "plain_ms": c_plain, "max_abs_err": c_err,
                      "max_rel_err": c_rel, "tile": list(cta.tile),
                      "threads": list(cta.threads), "chunk": cta.chunk,
                      "n_chunks": cta.n_chunks, "warmup": cta.warmup,
                      "ctas": cta.ctas, "smem_bytes": call.smem_bytes})
        log(f"{ph['name']} region {list(call.region.ops)} T={call.T} "
            f"P={call.P}: kernel {c_ms:.4f} ms x{n}, plain {c_plain:.1f} ms,"
            f" max abs err {c_err:.3e}, max rel err {c_rel:.3e}; tile "
            f"{cta.tile}, chunk {cta.chunk} (+{cta.warmup}), {cta.ctas} "
            f"CTAs, {call.smem_bytes} B")
    if rel > ph["tol"]:
        raise SystemExit(f"{ph['name']}: a sweep kernel disagrees with its "
                         "plain version")
    bound_ms, bound_by = bound(in_bytes, out_bytes, flops)
    return {
        "name": f"stream3d.build_stream_call[{ph['name']} "
                f"{'x'.join(map(str, grid))} {ph['dtype']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stream3d.py",
        "replaces": stream3d.REPLACES,
        "launches": ph["launches"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_per_step": ph["launches"] / steps,
        "max_rel_err": rel,
        "min_bytes_per_step": in_bytes + out_bytes,
        "calls": calls,
    }


if __name__ == "__main__":
    sys.exit(main())
