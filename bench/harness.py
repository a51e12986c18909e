"""One run of one cell: set-up, the measured window, the profiled stretch
(``--trace 1``), the reference check, and the result's line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (``bench/configs/``) and its
traffic mix (``bench/traffic/<traffic>.json``); its limits are
``bench/limits/<cell>.json``; each metric is read by
``bench/metrics/<metric>.py``'s ``read(run)``, which returns a number or
None where it finds nothing to read. The configuration names the program
(an app of ``repro_torch.apps`` and its update rule) and its plain
reference under ``bench/reference/``.

Traffic: a closed loop with one caller. Each call is one compiled
executable's call that advances the traffic's ``steps`` steps from the
same seeded inputs, followed by a synchronise of every card of the cell.

A configuration with a ``mesh`` (``{"shape", "axis_names", "mesh_axes"}``)
is compiled over ``cuda:0 .. n-1`` and asks for ``n`` chips. The program
takes the global inputs on the mesh's first card and gathers its result
there, so that card holds two grids besides its shard: the compared rows
are parked on the other cards after the window, and the reference runs in
slabs on them (``bench/slabs.py``). Energy, memory and the least time are
taken over all the cell's cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

from . import compare, devtrace, inputs, roofline, slabs, spans as pspans

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the run's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fixed_caches(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files;
    raises where its configuration's mesh is not of its chips' size."""
    bm = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r}; known: "
                         + ", ".join(sorted(cells)))
    entry = cells[name]
    cfg = {c["name"]: c for c in bm["configs"]}[entry["config"]]

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    config = load_json(root / cfg["file"])
    if mesh_size(config) != int(entry["chips"]):
        raise ValueError(f"workload {name!r} asks for {entry['chips']} "
                         f"chip(s); its mesh has {mesh_size(config)}")
    return Cell(
        name=name, root=root, entry=entry, config=config,
        traffic=load_json(root / "bench" / "traffic"
                          / f"{entry['traffic']}.json"),
        limits=load_json(root / "bench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bm["end_to_end"] if here(m)],
        per_layer=[m for m in bm["per_layer"] if here(m)])


def mesh_size(config: dict) -> int:
    """The devices the configuration's mesh takes (1 without a mesh)."""
    return math.prod(config["mesh"]["shape"]) if "mesh" in config else 1


def reader(root: Path, metric: str):
    """``read(run)`` of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(root: Path, module: str):
    path = root / "bench" / "reference" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_program(root: Path):
    """``repro_torch`` from the checkout's ``src/``, and nowhere else."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(
            Path(src).resolve()):
        raise RuntimeError(f"repro_torch was imported from "
                           f"{repro_torch.__file__}, not from {src}")
    return repro_torch


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the metric readers read. ``trace`` (``--trace 1`` only) is
    :func:`devtrace.summarise`'s record, the profiled stretch's raw
    events under ``"raw"``."""
    cell: Cell
    points: int
    steps_per_call: int
    least_time_s: float
    setup_s: float
    spans: dict
    call_s: list
    window_s: float
    energy_j: float | None
    window_peak_bytes: int
    trace: dict | None = None

    @property
    def point_steps(self) -> float:
        return float(self.points) * self.steps_per_call * len(self.call_s)


def compile_cell(cell: Cell, grid, device):
    """The cell's compiled executable, as a modeller would compile it: on
    ``device`` (None: the card), or over the configuration's mesh of
    ``cuda:0 .. n-1`` (on the CPU, ``device`` repeated)."""
    rt = import_program(cell.root)
    from repro_torch import apps
    cfg, tr = cell.config, cell.traffic
    program = getattr(apps, cfg["program"])(cfg["boundary"])
    upd = cfg["update"]
    update = getattr(apps, upd["rule"])(*upd.get("args", ()))
    layout = {}
    if "mesh" in cfg:
        from repro_torch.dist import make_auto_mesh
        m = cfg["mesh"]
        n = mesh_size(cfg)
        layout = dict(mesh=make_auto_mesh(
            m["shape"], m["axis_names"],
            devices=None if device is None else [device] * n),
            mesh_axes=tuple(m["mesh_axes"]))
        device = None
    ex = rt.compile_program(program, grid, steps=int(tr["steps"]),
                            update=update, dtype=cfg["dtype"],
                            schedule=tr["schedule"],
                            time_tile=tr.get("time_tile"),
                            strategy=tr.get("strategy", "auto"),
                            device=device, **layout)
    eff = ex.plan.stream.time_tile if ex.plan.stream is not None else 1
    if int(eff) != int(tr.get("time_tile") or 1):
        raise RuntimeError(f"time_tile {tr.get('time_tile')} ran as {eff}")
    return ex


def program_spans(config: dict):
    """What makes the program's spans ranges of the profiled stretch: the
    one-card orchestrator marks them with no tracer installed; the mesh
    orchestrator opens its ``distribute.exchange`` spans only for an
    installed tracer, so a mesh cell's stretch installs one."""
    if "mesh" not in config:
        return contextlib.nullcontext()
    from repro_torch.obs.trace import Tracer
    return Tracer().active()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t0: float, device="cuda", grid=None, power=None,
             wrap=None) -> tuple:
    """One run of ``cell``; returns ``(result, checks)``.

    ``grid`` overrides the configuration's (tests run small), ``power``
    is a started-on-demand :class:`power.Cards` or None (no energy
    reading), and ``wrap(ex)`` replaces the compiled executable (the tests
    plant faults with it). On the card the run uses ``cuda:0 .. chips-1``;
    on the CPU, ``device`` stands for each of them."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    chips = int(cell.entry["chips"])
    cards = ([torch.device("cuda", i) for i in range(chips)] if on_card
             else [dev] * chips)

    def sync():
        if on_card:
            for d in cards:
                torch.cuda.synchronize(d)

    def peak_bytes():
        return max(torch.cuda.max_memory_allocated(d) for d in cards) \
            if on_card else 0

    if tr.get("loop") != "closed" or int(tr.get("callers", 0)) != 1:
        raise ValueError(f"traffic {cell.entry['traffic']!r}: the harness "
                         "drives a closed loop with one caller")
    grid = tuple(int(g) for g in (grid or cfg["grid"]))
    steps = int(tr["steps"])
    writes = cfg["writes"]

    spans = {"before_inputs": time.perf_counter() - t0}
    a = time.perf_counter()
    fields, scalars, coeffs = inputs.make(cfg, grid, seed, dev)
    sync()
    spans["inputs"] = time.perf_counter() - a
    a = time.perf_counter()
    ex = compile_cell(cell, grid, device if not on_card else None)
    spans["compile"] = time.perf_counter() - a
    if wrap is not None:
        ex = wrap(ex)

    def call():
        return ex(fields, scalars, coeffs)

    if power is not None:
        power.start()
    try:
        a = time.perf_counter()
        for _ in range(int(tr["warmup_calls"])):
            call()
            sync()
        if power is not None:
            power.wait_for_samples()
        spans["warmup"] = time.perf_counter() - a
        setup_peak = peak_bytes()
        if on_card:
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
        call_s, digests = [], []
        t_open = time.perf_counter()
        setup_s = t_open - t0
        print("set-up " + " ".join(f"{k}={v:.3f}" for k, v in spans.items())
              + f" total={setup_s:.3f} s", file=sys.stderr, flush=True)
        close = t_open + float(seconds)
        while True:
            a = time.perf_counter()
            out = call()
            sync()
            b = time.perf_counter()
            call_s.append(b - a)
            digests.append(compare.digest(torch, out, writes))
            sync()
            if b >= close:
                break
            del out
        t_close = b
        energy = power.energy_j(t_open, t_close) if power else None
    finally:
        if power is not None:
            power.stop()
    window_peak = peak_bytes()

    run = Run(cell=cell, points=math.prod(grid), steps_per_call=steps,
              least_time_s=roofline.least_time(cfg, grid, steps, chips)[0],
              setup_s=setup_s,
              spans=spans, call_s=call_s, window_s=t_close - t_open,
              energy_j=energy, window_peak_bytes=window_peak)
    if "mesh" in cfg:
        # the mesh's first card holds the inputs and the gathered result:
        # the compared rows wait on the other cards
        ref_cards = cards[1:] or cards
        plan = slabs.plan(cfg, grid, steps, ref_cards)
        got = slabs.park(out, writes, plan)
        del out
    breakdown = None
    if trace:
        moved = pspans.exchanged_bytes()
        with program_spans(cfg):
            raw = devtrace.profile_calls(torch, call, int(tr["trace_calls"]),
                                         on_card, sync)
        run.trace = devtrace.summarise(
            raw, devtrace.generated_matcher(
                [k.entry for k in getattr(ex, "kernels", [])]),
            torch._C._demangle, chips)
        if moved is not None:
            run.trace["exchanged_bytes"] = pspans.exchanged_bytes() - moved
        breakdown = {"device_ops": run.trace["top"],
                     "idle_gaps": run.trace["idle_gaps"]}
    peak = max(setup_peak, window_peak, peak_bytes())
    if on_card:
        print("memory peak by card " + " ".join(
            f"{d}={torch.cuda.max_memory_allocated(d)}" for d in cards)
            + f"; window {window_peak}, set-up {setup_peak}; reserved "
            + " ".join(f"{d}={torch.cuda.max_memory_reserved(d)}"
                       for d in cards), file=sys.stderr, flush=True)
    if trace:
        print("busy by card " + " ".join(
            f"{c}={v!r}" for c, v in run.trace["busy_by_card"].items())
            + f" of {run.trace['window_s']!r} s", file=sys.stderr,
            flush=True)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(cell.root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs
    del ex, call
    last = digests[-1].cpu()
    calls_off = sum(int(not torch.equal(d.cpu(), last)) for d in digests)
    ref = reference(cell.root, cfg["reference"]["module"])
    if "mesh" in cfg:
        if on_card:
            for d in cards:
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
        res = slabs.run(ref, cfg, fields, scalars, coeffs, steps, plan)
        parts = slabs.errors(res, writes, lambda a, b, _: got[(a, b)])
        del got, res
    else:
        got = {f: out[f] for f in writes}
        del out
        if on_card:
            torch.cuda.empty_cache()
        want = ref.run(cfg["reference"]["scheme"], fields, scalars, coeffs,
                       steps, dtype=torch.float32,
                       **cfg["reference"].get("args", {}))
        parts = {f: [compare.error_parts(got[f], want[f])] for f in writes}
        del got, want
    rows = compare.checks(parts, writes, cell.limits, calls_off)
    del parts

    result = {
        "correct": compare.passed(rows),
        "attempted": len(call_s),
        "failed": calls_off,
        "metrics": metrics,
        "device": device_record(torch, on_card, chips, peak,
                                run.trace if trace else None),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result, rows


def device_record(torch, on_card: bool, chips: int, peak: int, tr) -> dict:
    rec = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        rec["busy_s"] = tr["busy_s"]
        rec["window_s"] = tr["window_s"]
    return rec
