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

LM serving (the hand-written CUDA sliding-window attention kernels:
``swa_mma.cu`` on the tensor cores for bfloat16, ``swa.cu`` for float32):

7. H2O-Danube-1.8B at full width and depth (24 layers, d 2560, 32 heads
   over 8 KV heads, head dim 80, window 4096, bfloat16), random weights
   from ``--seed``: ``ServeEngine.generate`` on two prompts of 8192 tokens,
   16 greedy new tokens.  The prefill launches the bf16 kernel once a
   layer (24), the decode steps never.  Layer 0's q, k and v are captured
   and the kernel held against ``swa_plain`` on them (bf16 at 2e-2, and
   the float32 kernel on the same values cast up at 2e-5); at a depth of 4
   layers the last-position logits of an 8192-token prefill (the kernel)
   are held against a 7168-token prefill and 1024 teacher-forced decode
   steps (the ring cache, no kernel) at 2e-2; the kernels are also held
   against ``swa_plain`` at head dims 40/64/80/128/256 with GQA, ragged
   last tiles and a window >= S in both dtypes.
   ``torch.nn.functional.scaled_dot_product_attention`` with the band mask
   is timed on the same inputs as the library yardstick, in turns with the
   kernel (kernel, SDPA, kernel, SDPA, ...), in both dtypes.  The float32
   kernel is off the serving path; its row (0 launches on the path) keeps
   its time.

Every stencil path is compared with the same compile on
``backend="torch_fused"`` on the card, and each stream path with the block
path of the same program, boundary, grid and steps where there is one.
Each block path's first group kernel, and every sweep kernel of a stream
path (a chain's remainder included) on the inputs the path gives it, is
held against its plain PyTorch version; small grids are compared with the
CPU oracle.  Every tolerance is relative to each output's own max abs:
1e-5 for a float32 single step, 1e-4 for fused loops, and 2e-2 (a few
bfloat16 ulps) for bfloat16.  Every launch count is zeroed just before each
path and read just after.  Kernel and end-to-end times come from CUDA
events (warm-up, then the median of 5; the LM prefill and decode the
median of 3); a stream path's kernel, plain-version and bound times are
per time step (a chained sweep's divided by its depth), and its plain
version is timed in the one run that checks it.  One prefill and one
decode step also run under ``torch.profiler`` for their device time, idle
share and kernel launches.

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
import re
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

LM_ARCH = "h2o_danube_1_8b"
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8192, 16
LM_E2E_DEPTH, LM_E2E_SPLIT = 4, 7168     # prefill 7168, decode 1024
SWA_HEAD_DIMS = (40, 64, 80, 128, 256)
# (B, S, H, KV, D, window): the head dims, GQA, a window >= S, a last query
# tile that is not full, a head dim that is not a multiple of 16, D 256
# with a ragged last tile
SWA_SHAPES = [(2, 256, 4, 4, 64, 64), (1, 256, 32, 8, 80, 96),
              (2, 512, 8, 2, 128, 256), (1, 128, 4, 4, 256, 512),
              (2, 200, 4, 1, 80, 4096), (1, 192, 8, 2, 40, 100),
              (1, 200, 4, 2, 256, 96)]


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


def time_in_turns(fns, reps=5, warmup=2):
    """Median CUDA-event time of one call of each of ``fns``, the calls
    made in turns (a, b, a, b, ...) so that all see the same clocks."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    ts = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(ts, fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t.append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in ts]


def ptxas_stats(report: str) -> dict:
    """Registers and spill bytes of the kernel in a ``-Xptxas -v`` log."""
    regs = re.findall(r"Used (\d+) registers", report)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        report)
    return {"registers": int(regs[-1]) if regs else None,
            "spill_stores": int(spills[-1][0]) if spills else None,
            "spill_loads": int(spills[-1][1]) if spills else None}


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
    from repro_torch.configs import get_config
    from repro_torch.core import TileDemotionWarning
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import build, stencil3d, stream3d, swa

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
    swa_sources = [swa.kernel_source(getattr(torch, dt), d)
                   for dt in ("float32", "bfloat16") for d in SWA_HEAD_DIMS]
    tags = ["stencil"] * len(sources) + ["swa"] * len(swa_sources)
    build.build_many(sources + swa_sources, tag=tags)
    log(f"built {len(set(sources + swa_sources))} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, tag in dict.fromkeys(zip(sources + swa_sources, tags)):
        regs = [ln.strip() for ln in build.ptxas_report(src, tag).splitlines()
                if "registers" in ln or "spill" in ln]
        log("ptxas:", " | ".join(regs))
    swa_ptxas = []
    for dt in (torch.bfloat16, torch.float32):
        for d in SWA_HEAD_DIMS:
            st = ptxas_stats(build.ptxas_report(swa.kernel_source(dt, d),
                                                "swa"))
            st.update(dtype=str(dt).removeprefix("torch."), d=d,
                      source=str(swa.SOURCES[dt].relative_to(ROOT)),
                      smem_bytes=swa.smem_bytes(dt, d))
            swa_ptxas.append(st)
            log(f"ptxas swa {st['dtype']} D {d} ({st['source']}): "
                f"{st['registers']} registers, spill stores "
                f"{st['spill_stores']} B, spill loads {st['spill_loads']} B,"
                f" {st['smem_bytes']} B of dynamic shared memory a CTA")
            # the served library (the LM's head dim) keeps all in registers
            if dt == torch.bfloat16 and d == get_config(LM_ARCH).d_head \
                    and (st["spill_stores"] or st["spill_loads"]):
                raise SystemExit(f"ptxas spills in the bf16 SWA library at "
                                 f"D {d}")

    # ------------------------------------------- main path, counted launches
    inputs = {}
    for ph in paths:
        ikey = (ph["p"].name, ph["grid"], ph["dtype"])
        if ikey not in inputs:
            f, s, c = make_inputs(ph["p"], ph["grid"], args.seed)
            inputs[ikey] = inputs_from_numpy(f, s, c, "cuda", ph["dtype"])
        ph["inputs"] = inputs[ikey]
    for ph in paths:
        stencil3d.launches = stream3d.launches = swa.launches = 0
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
    path_rows = [{k: ph.get(k) for k in (
        "name", "schedule", "grid", "dtype", "boundary", "steps", "time_tile",
        "plane_tile", "eff", "launches", "e2e_err", "block_err")}
        for ph in paths]
    del paths, inputs, plain_ex, ph
    torch.cuda.empty_cache()

    # --------------------------------------------------- LM serving path
    lm_rows, lm = lm_phase(args.seed, torch, swa)
    rows += lm_rows
    lm["swa_ptxas"] = swa_ptxas

    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": rows, "paths": path_rows, "lm": lm}
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


def device_profile(fn, torch) -> dict:
    """One run of ``fn`` under ``torch.profiler``: host ms (to the final
    synchronise), device ms (the kernels' time summed: one stream, so
    busy time), the idle share, kernel launches, and device ms by kernel
    class (the SWA kernel, matrix products, the rest)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by = {"swa": 0.0, "matmul": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        cls = ("swa" if "swa_kernel" in name else "matmul"
               if any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90"))
               else "other")
        by[cls] += us / 1e3
        launches += e.count
    dev = sum(by.values())
    return {"host_ms": host_ms, "device_ms": dev,
            "idle_share": max(0.0, 1.0 - dev / host_ms),
            "kernel_launches": launches, "device_ms_by": by}


def swa_flops(B, S, H, D, w):
    """4·D operations for each (query, key) pair of the band,
    ``sum_i min(i+1, w)`` a row."""
    return 4 * D * sum(min(i + 1, w) for i in range(S)) * B * H


def swa_bound(B, S, H, KV, D, w, dtype):
    """(bound ms, what bounds it): q, k, v and o moved once over 3.35 TB/s,
    against the band's operations over the peak for the dtype (data sheet,
    700 W): bf16 on the tensor cores' 989 TFLOP/s, float32 on the CUDA
    cores' 67 TFLOP/s."""
    import torch

    from repro_torch import hw

    itemsize = 2 if dtype == torch.bfloat16 else 4
    peak = (hw.H100.peak_bf16_flops if dtype == torch.bfloat16
            else hw.H100.peak_f32_flops)
    t_bytes = B * S * (2 * H + 2 * KV) * D * itemsize / hw.H100.hbm_bandwidth
    t_ops = swa_flops(B, S, H, D, w) / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lm_phase(seed, torch, swa):
    """H2O-Danube-1.8B served at full width and depth through
    ``ServeEngine.generate``; the SWA kernels (bf16 and float32) against
    their plain version on the inputs layer 0 gives the bf16 one and at the
    test shapes; prefill against decode at depth 4; times.  Returns (the
    kernels' rows, bf16 then float32; the LM record)."""
    import dataclasses

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels import stencil3d, stream3d
    from repro_torch.models import (ServeEngine, cast_params, decode_step,
                                    init_lm, lm_serve, prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    B, S, new = LM_BATCH, LM_PROMPT, LM_NEW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen)
    eng = ServeEngine(cfg, params, batch=B, max_len=S + new)
    del params
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_params() / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: counts zeroed just before, read just after; the
    # prefill's and the decode steps' launches apart, and layer 0's
    # kernel inputs captured
    counts = {"prefill": [], "decode": []}
    captured = []
    launch = swa.swa_cuda

    by_dtype = {torch.bfloat16: 0, torch.float32: 0}

    def capture(q, k, v, *, window):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), window))
        before = swa.launches
        out = launch(q, k, v, window=window)
        by_dtype[q.dtype] += swa.launches - before
        return out

    def counted(name, fn):
        def run(*a, **kw):
            before = swa.launches
            out = fn(*a, **kw)
            counts[name].append(swa.launches - before)
            return out
        return run

    patched = [(swa, "swa_cuda", capture),
               (lm_serve, "prefill", counted("prefill", lm_serve.prefill)),
               (lm_serve, "decode_step",
                counted("decode", lm_serve.decode_step))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    for m, n, f in patched:
        setattr(m, n, f)
    try:
        stencil3d.launches = stream3d.launches = swa.launches = 0
        t0 = time.perf_counter()
        ids = eng.generate(prompts.cpu().numpy(), new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = swa.launches
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    log(f"generate: ids {ids.shape}, {gen_s:.3f} s; SWA launches {launches}"
        f" (prefill {counts['prefill']}, decode steps "
        f"{sum(counts['decode'])} over {len(counts['decode'])}; bf16 "
        f"{by_dtype[torch.bfloat16]}, float32 {by_dtype[torch.float32]})")
    if ids.shape != (B, new) or not ((ids >= 0) & (ids < cfg.vocab)).all():
        raise SystemExit(f"generate returned bad ids {ids.shape}")
    if counts["prefill"] != [cfg.n_layers] or any(counts["decode"]) \
            or launches != cfg.n_layers \
            or by_dtype[torch.bfloat16] != cfg.n_layers:
        raise SystemExit("the SWA kernel did not run once a layer in the "
                         "prefill and never in decode")
    if eng.stats.prefill_tokens != B * S:
        raise SystemExit(f"stats {eng.stats}")

    # the kernels against their plain version on layer 0's inputs (float32:
    # the same values cast up)
    q, k, v, w = captured[0]
    H, KV, D = q.shape[2], k.shape[2], q.shape[3]
    q32, k32, v32 = q.float(), k.float(), v.float()
    got = swa.swa_cuda(q, k, v, window=w)
    got32 = swa.swa_cuda(q32, k32, v32, window=w)
    plain_ms, want = {}, {}
    for dt, args in ((torch.bfloat16, (q, k, v)), (torch.float32,
                                                    (q32, k32, v32))):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want[dt] = swa.swa_plain(*args, window=w)
        e1.record()
        e1.synchronize()
        plain_ms[dt] = e0.elapsed_time(e1)
    err = float((got.float() - want[torch.bfloat16].float()).abs().max())
    err32 = float((got32 - want[torch.float32]).abs().max())
    rel = rel_err(got, want[torch.bfloat16])
    rel32 = rel_err(got32, want[torch.float32])
    log(f"swa layer 0 {tuple(q.shape)} KV {KV} w {w}: kernel vs plain max "
        f"abs err {err:.3e}, max rel err {rel:.3e} (bf16, tol 2e-2); "
        f"float32 {err32:.3e} abs, {rel32:.3e} rel (tol 2e-5)")
    if rel > 2e-2 or rel32 > 2e-5 or not bool(torch.isfinite(got).all()) \
            or not bool(torch.isfinite(got32).all()):
        raise SystemExit("the SWA kernel disagrees with its plain version")
    del got, got32, want
    # each kernel in turns with the library yardstick, SDPA with the band
    # mask on the same inputs (KV heads repeated, (B, H, S, D) views)
    G = H // KV
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    flops = swa_flops(B, S, H, D, w)
    timed = {}
    for dt, (qq, kk, vv) in ((torch.bfloat16, (q, k, v)),
                             (torch.float32, (q32, k32, v32))):
        qt = qq.transpose(1, 2)
        kt = kk.repeat_interleave(G, 2).transpose(1, 2)
        vt = vv.repeat_interleave(G, 2).transpose(1, 2)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ms, library_ms = time_in_turns([
                lambda: swa.swa_cuda(qq, kk, vv, window=w),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=band)])
        del qt, kt, vt
        bound_ms, bound_by = swa_bound(B, S, H, KV, D, w, dt)
        timed[dt] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, tflops=flops / ms / 1e9,
                         bound_share=bound_ms / ms)
        log(f"swa kernel {dt}: {ms:.4f} ms a call ({flops / ms / 1e9:.1f} "
            f"TFLOP/s on the band, {bound_ms / ms:.1%} of the bound "
            f"{bound_ms:.4f} ms by {bound_by}), plain {plain_ms[dt]:.3f} ms,"
            f" SDPA with the band mask {library_ms:.4f} ms (medians, in "
            f"turns); {by_dtype[dt]} launches a prefill")
    del band, q32, k32, v32

    # end-to-end times of the serving path
    toks = prompts
    prefill_ms = time_ms(lambda: prefill(cfg, eng.params, toks, S + new),
                         reps=3, warmup=1)
    _, cache = prefill(cfg, eng.params, toks, S + new)
    tok = toks[:, -1]
    step = {"pos": S}

    def one_step():
        decode_step(cfg, eng.params, cache, tok, step["pos"])
        step["pos"] += 1

    decode_ms = time_ms(one_step, inner=4, reps=3, warmup=1)
    prof = {"prefill": device_profile(
        lambda: prefill(cfg, eng.params, toks, S + new), torch),
        "decode_step": device_profile(one_step, torch)}
    del cache
    log(f"prefill {B}x{S}: {prefill_ms:.2f} ms ({B * S / prefill_ms * 1e3:.0f}"
        f" tokens/s); decode {decode_ms:.3f} ms a step "
        f"({B / decode_ms * 1e3:.1f} tokens/s); generate {new} tokens "
        f"{gen_s * 1e3:.1f} ms")
    for k, pr in prof.items():
        log(f"profile {k}: host {pr['host_ms']:.2f} ms, device "
            f"{pr['device_ms']:.2f} ms (idle {pr['idle_share']:.1%}), "
            f"{pr['kernel_launches']} kernel launches; device ms: "
            + ", ".join(f"{c} {v:.2f}" for c, v in pr["device_ms_by"].items()))

    # prefill (the kernel) against prefill + teacher-forced decode (the
    # ring cache) at a depth of LM_E2E_DEPTH, full width
    cfg4 = dataclasses.replace(cfg, n_layers=LM_E2E_DEPTH)
    p4 = cast_params(init_lm(cfg4, gen), torch.bfloat16)
    full, _ = prefill(cfg4, p4, toks, S)
    swa.launches = 0
    part, cache = prefill(cfg4, p4, toks[:, :LM_E2E_SPLIT], S)
    pre_launches = swa.launches
    for t in range(LM_E2E_SPLIT, S):
        part, cache = decode_step(cfg4, p4, cache, toks[:, t], t)
    torch.cuda.synchronize()
    dec_launches = swa.launches - pre_launches
    e2e = rel_err(part, full)
    log(f"depth {LM_E2E_DEPTH}: prefill {S} vs prefill {LM_E2E_SPLIT} + "
        f"{S - LM_E2E_SPLIT} decode steps, last-position logits max rel err "
        f"{e2e:.3e} (tol 2e-2); kernel launches {pre_launches} + "
        f"{dec_launches}")
    if e2e > 2e-2 or pre_launches != LM_E2E_DEPTH or dec_launches \
            or not bool(torch.isfinite(full).all()):
        raise SystemExit("prefill and decode disagree at depth "
                         f"{LM_E2E_DEPTH}")
    del p4, cache

    # the kernel at the test shapes
    shapes = []
    rng = torch.Generator(device="cuda").manual_seed(seed + 1)
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        for (b, s, h, kv, d, ww) in SWA_SHAPES:
            qq, kk, vv = (torch.randn((b, s, hh, d), generator=rng,
                                      device="cuda").to(getattr(torch, dt))
                          for hh in (h, kv, kv))
            r = rel_err(swa.swa_cuda(qq, kk, vv, window=ww),
                        swa.swa_plain(qq, kk, vv, window=ww,
                                      q_block=128 if s % 128 == 0 else s))
            shapes.append({"shape": [b, s, h, kv, d], "window": ww,
                           "dtype": dt, "max_rel_err": r})
            if r > tol:
                raise SystemExit(f"swa kernel {dt} {(b, s, h, kv, d, ww)}: "
                                 f"max rel err {r:.3e} > {tol}")
    log(f"swa kernel at {len(shapes)} test shapes: worst max rel err "
        f"{max(x['max_rel_err'] for x in shapes):.3e}")

    rows = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        t = timed[dt]
        rows.append({
            "name": f"swa.swa_cuda[{cfg.name} prefill B{B} S{S} H{H} KV{KV} "
                    f"D{D} w{w} {tag}]",
            "route": "cuda",
            "source": str(swa.SOURCES[dt].relative_to(ROOT)),
            "replaces": swa.REPLACES,
            "launches": by_dtype[dt],
            "max_abs_err": err if dt == torch.bfloat16 else err32,
            "ms": t["ms"],
            "plain_ms": plain_ms[dt],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "max_rel_err": rel if dt == torch.bfloat16 else rel32,
            "tflops": t["tflops"],
            "bound_share": t["bound_share"],
            "on_serving_path": by_dtype[dt] > 0,
            "smem_bytes": swa.smem_bytes(dt, D),
        })
    record = {"arch": LM_ARCH, "batch": B, "prompt": S, "new_tokens": new,
              "generate_s": gen_s, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_ms,
              "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
              "decode_tokens_per_s": B / decode_ms * 1e3,
              "launches_prefill": counts["prefill"],
              "launches_decode": sum(counts["decode"]),
              "profile": prof,
              "e2e_depth": LM_E2E_DEPTH, "e2e_max_rel_err": e2e,
              "swa_shapes": shapes}
    return rows, record


if __name__ == "__main__":
    sys.exit(main())
