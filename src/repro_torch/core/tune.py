"""Measured search over the DataflowPlan space (the port of
``repro.core.tune``).

The tooling, not the programmer, picks the dataflow structure:
:func:`~repro_torch.core.schedule.auto_plan` is the one-shot heuristic
seed, and this module closes the loop on the card:

1. **generate** candidates over the plan knobs — fuse strategy
   (``auto`` / ``fused`` / ``per_field``), the block kernel's tile (the
   top of the planner's own ranked list,
   :func:`~repro_torch.core.schedule.feasible_blocks`, each with its
   ``sweep_chunk``-derived chunk), ``carry_write`` style, and the stream
   schedule over ``time_tile`` x ``plane_tile``;
2. **prune** with the static models — :func:`~repro_torch.core.schedule.
   smem_cost` drops plans whose CTA does not fit the shared memory one CTA
   may use, and the H100 plan model
   (:func:`~repro_torch.analysis.stencil_roofline.model_plan`) ranks the
   rest, so only the ``max_measured`` most promising pay for a run;
3. **build** every survivor's generated CUDA sources in one
   :func:`~repro_torch.kernels.build.build_many` call (``nvcc`` on all of
   them at once), then **measure** the survivors: warm-up, then best-of-k
   with CUDA events around the whole executor call on the card
   (``time.perf_counter`` on the CPU), single step and, given an update
   rule, the fused ``steps=N`` loop;
4. **persist** the winner in a JSON plan cache keyed by (program
   fingerprint, grid, backend, device, torch and CUDA versions, nvcc
   flags, dtype, mode, mesh topology), so
   ``compile_program(..., strategy="tuned")`` is a pure cache hit — zero timed runs — after the first tune.

The ``auto_plan`` seed is always measured as the baseline candidate, so the
tuned plan is never slower than the heuristic on the tuner's own
measurements.  A candidate whose build or launch fails fails the tune:
nothing is caught and skipped.

The timer is injectable (``TuneConfig.timer``) so tests can drive the
search with fake timings: the same measurements give the same winner.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from .. import hw
from ..kernels import build
from ..obs.achieved import best_of
from ..obs.events import CacheHit, CacheMiss, PlanChosen
from ..obs.metrics import MetricsRegistry, global_metrics
from ..obs.trace import current_tracer
from .ir import Program
from .schedule import (PLAN_SCHEMA_VERSION, DataflowPlan, auto_plan,
                       feasible_blocks, mesh_fingerprint, normalize_mesh_axes,
                       plan_from_dict, plan_to_dict, program_fingerprint,
                       shard_local_grid, smem_cost)

__all__ = [
    "TuneConfig", "PlanCache", "TuneResult", "cache_key", "device_name",
    "tune_plan", "get_tuned_plan", "default_cache_path",
    "make_serve_record", "read_serve_record",
]

#: Environment variable overriding the default plan-cache location.
PLAN_CACHE_ENV = "REPRO_PLAN_CACHE"

#: On-disk plan-cache schema version (the reference's document layout).  A
#: cache written by another version is a **miss**, and the next store
#: rewrites the file at this version.
CACHE_SCHEMA_VERSION = 4

#: block tiles a fuse strategy contributes: the first of the planner's
#: ranked list (:func:`~repro_torch.core.schedule.feasible_blocks`)
PLANNER_TILES = 4


def default_cache_path() -> str:
    """``$REPRO_PLAN_CACHE``, else ``build/plan_cache.json`` at the root
    of the checkout, beside the kernel build cache."""
    env = os.environ.get(PLAN_CACHE_ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parents[3] / "build"
               / "plan_cache.json")


@dataclasses.dataclass
class TuneConfig:
    """Knobs of one tuning run (the defaults are CI-smoke sized)."""

    steps: int = 3              # fused-loop depth measured per candidate
    warmup: int = 1             # untimed calls first (kernel build + load)
    repeats: int = 3            # best-of-k timed calls
    max_measured: int = 8       # model-ranked candidates that pay for a run
    smem_budget: int = hw.H100.smem_per_block
    strategies: tuple = ("auto", "fused", "per_field")
    carry_writes: tuple = ("repad", "inplace")
    # chain depths tried for stream candidates (fused-loop mode only: a
    # single step has no update rule to chain); depths legalised to the
    # same effective chain dedup to one run
    time_tiles: tuple = (1, 2, 4)
    # sweep widths tried for stream candidates (both modes); widths
    # legalised to the same effective P dedup to one run
    plane_tiles: tuple = (1, 2, 4)
    dtypes: tuple | None = None   # None = the dtype compile_program asked for
    seed: int = 0               # synthetic measurement data
    # the cache key identifies the problem, not the search effort: set
    # force_retune to bypass the lookup and overwrite the entry
    force_retune: bool = False
    # timer(fn) -> seconds; None = warm-up + best-of-k on the device's
    # clock (obs.achieved.best_of).  Tests inject deterministic fakes.
    timer: Callable | None = None


class PlanCache:
    """Persistent JSON store of tuned plans.

    ``path=None`` keeps the cache in memory only (tests); the default is
    :func:`default_cache_path`.  File format: ``{"version":
    CACHE_SCHEMA_VERSION, "entries": {cache_key: record}}``, a record
    holding the serialised plan, its ``carry_write`` style and the
    tuning measurements (see :func:`tune_plan`).  A file of another
    schema version, or one that does not parse, loads as empty.

    Every ``lookup`` counts itself into the cache's own registry
    (``cache.metrics``: ``hits``/``misses``) and into the process-wide one
    (``plan_cache.hits``/``plan_cache.misses``).
    """

    def __init__(self, path: str | None = "auto"):
        self.path = default_cache_path() if path == "auto" else path
        self._mem: dict = {}
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()

    @property
    def hits(self) -> int:
        return self.metrics.counter("hits").value

    @property
    def misses(self) -> int:
        return self.metrics.counter("misses").value

    def _load(self) -> dict:
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    doc = json.load(f)
                if (doc.get("version") == CACHE_SCHEMA_VERSION
                        and isinstance(doc.get("entries"), dict)):
                    return doc
            except (json.JSONDecodeError, OSError):
                pass
        return {"version": CACHE_SCHEMA_VERSION, "entries": {}}

    def lookup(self, key: str) -> dict | None:
        with self._lock:
            rec = self._mem.get(key)
        if rec is None:
            rec = self._load()["entries"].get(key)
        name = "hits" if rec is not None else "misses"
        self.metrics.counter(name).inc()
        global_metrics().counter(f"plan_cache.{name}").inc()
        return rec

    def store(self, key: str, record: dict) -> None:
        """Persist ``record`` under ``key``, safe under concurrent writers:
        an advisory ``flock`` on ``<path>.lock`` serialises writers (across
        objects and processes); each re-reads the file under the lock,
        layers its own entries on top, writes a temp file of its own and
        ``os.replace``s it in, so readers never see a torn file and no
        store loses another writer's entries."""
        with self._lock:
            self._mem[key] = record
            if not self.path:
                return
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with self._file_lock():
                doc = self._load()
                doc["entries"].update(self._mem)
                tmp = (f"{self.path}.{os.getpid()}."
                       f"{uuid.uuid4().hex[:8]}.tmp")
                try:
                    with open(tmp, "w") as f:
                        json.dump(doc, f, indent=2)
                    os.replace(tmp, self.path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)

    @contextlib.contextmanager
    def _file_lock(self):
        try:
            import fcntl
        except ImportError:  # non-POSIX: best-effort merge-on-write
            yield
            return
        with open(f"{self.path}.lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)


def device_name(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _mesh_tag(mesh, mesh_axes) -> str:
    """Stable encoding of the mesh topology a plan was tuned under (the
    shared :func:`~repro_torch.core.schedule.mesh_fingerprint`):
    topologies of the same device count (2x4 vs 4x2, or different grid-axis
    assignments) shard different local blocks and move different halos —
    their tuned plans must not serve each other."""
    return mesh_fingerprint(mesh, mesh_axes)


def cache_key(p: Program, grid: Sequence[int], backend: str,
              device: str, dtype: str = "float32",
              mode: str = "loop", mesh=None, mesh_axes=None) -> str:
    """Tuned plans transfer only between identical search problems: the
    program's semantics (boundaries included, via the fingerprint), grid,
    backend, the device's name (:func:`device_name`), the torch and CUDA
    versions and the nvcc flags the kernels build with, the requested
    dtype, the mode (``"loop"``: ranked by the fused ``steps=N``
    measurement; ``"single"``: single step only) and the mesh topology —
    a single-step winner must not serve a fused compile, nor a 2x2 winner
    a 4x1 mesh."""
    return "|".join([
        program_fingerprint(p),
        "grid=" + "x".join(str(int(g)) for g in grid),
        f"backend={backend}",
        f"device={device}",
        *build.toolchain(),
        f"dtype={dtype}",
        f"mode={mode}",
        f"mesh={_mesh_tag(mesh, mesh_axes)}",
    ])


@dataclasses.dataclass
class _Candidate:
    plan: DataflowPlan
    carry_write: str
    label: str
    modeled_s: float = float("inf")
    us_single: float | None = None
    us_fused: float | None = None
    # modeled over measured time, in the mode the candidate is ranked by
    roofline_fraction: float | None = None

    def score(self) -> float:
        if self.us_fused is not None:
            return self.us_fused
        return self.us_single if self.us_single is not None else float("inf")


@dataclasses.dataclass
class TuneResult:
    plan: DataflowPlan
    carry_write: str
    key: str
    record: dict
    cache_hit: bool
    # every measured candidate, winner first, by score (empty on a hit)
    measured: list = dataclasses.field(default_factory=list)

    @property
    def baseline(self) -> _Candidate | None:
        """The measured ``auto_plan`` seed itself (exact label: the
        ``auto_plan/cw=...`` variants are other candidates)."""
        for c in self.measured:
            if c.label == "auto_plan":
                return c
        return None


# --------------------------------------------------------------------------
# candidate generation
# --------------------------------------------------------------------------

def _behaviour_key(plan: DataflowPlan, carry_write: str, backend: str,
                   with_loop: bool):
    """Two candidates with the same key lower to the same executable."""
    cw = carry_write if with_loop else None
    if backend != "cuda":
        # the torch lowerings ignore groups, tile and dtype
        return (cw,)
    if plan.schedule == "stream":
        # the legalised regions and the effective tiles decide the kernels;
        # the chain depth only in fused-loop mode (a single step never
        # chains)
        eff = plan.stream if plan.stream is not None else plan
        regions = (plan.stream.regions if plan.stream is not None
                   else tuple(tuple(g) for g in plan.groups))
        return ("stream", regions, plan.dtype, cw,
                int(eff.time_tile) if with_loop else 1, int(eff.plane_tile))
    return (tuple(tuple(g) for g in plan.groups), tuple(plan.block),
            plan.dtype, cw)


def _candidates(p: Program, grid, backend: str, dtype: str,
                cfg: TuneConfig, with_loop: bool) -> list:
    out: list[_Candidate] = []
    seen: set = set()

    def add(plan, cw, label):
        k = _behaviour_key(plan, cw, backend, with_loop)
        if k in seen:
            return
        seen.add(k)
        out.append(_Candidate(plan=plan, carry_write=cw, label=label))

    carry_writes = cfg.carry_writes if with_loop else ("repad",)
    steps = cfg.steps if with_loop else None
    # the heuristic seed is always candidate 0: the tuned plan can only
    # keep or beat it on the tuner's own measurements
    base = auto_plan(p, grid, backend=backend, dtype=dtype,
                     smem_budget=cfg.smem_budget, steps=steps)
    add(base, "repad", "auto_plan")
    for cw in carry_writes:
        add(base, cw, f"auto_plan/cw={cw}")
    for strat, dt in itertools.product(cfg.strategies, cfg.dtypes or (dtype,)):
        dtag = f"/dtype={dt}" if dt != "float32" else ""
        plan0 = auto_plan(p, grid, backend=backend, dtype=dt, strategy=strat,
                          smem_budget=cfg.smem_budget, steps=steps)
        blocks = feasible_blocks(p, plan0.groups, grid, dt,
                                 cfg.smem_budget)[:PLANNER_TILES]
        for blk, cw in itertools.product(blocks, carry_writes):
            plan = dataclasses.replace(plan0, block=tuple(blk),
                                       groups=[list(g) for g in plan0.groups])
            add(plan, cw, f"{strat}/block={'x'.join(map(str, blk))}/cw={cw}"
                          + dtag)
        # the stream schedule: one sweep candidate per strategy x chain
        # depth (fused-loop mode only) x sweep width
        if backend == "cuda" and p.ndim >= 2:
            tiles = tuple(cfg.time_tiles) if with_loop else (1,)
            for tt, pt in itertools.product(tiles, cfg.plane_tiles or (1,)):
                plan_s = auto_plan(p, grid, backend=backend, dtype=dt,
                                   strategy=strat,
                                   smem_budget=cfg.smem_budget, steps=steps,
                                   schedule="stream", time_tile=int(tt),
                                   plane_tile=int(pt))
                tag = f"/T={int(tt)}" if int(tt) > 1 else ""
                tag += f"/P={int(pt)}" if int(pt) > 1 else ""
                for cw in carry_writes:
                    add(plan_s, cw, f"stream/{strat}{tag}/cw={cw}" + dtag)
    return out


def _fits(p: Program, plan: DataflowPlan, grid, budget: int) -> bool:
    """Whether the plan's largest CTA fits ``budget`` bytes of shared
    memory (the torch backends have no CTA)."""
    if plan.backend != "cuda":
        return True
    try:
        return smem_cost(p, plan, grid) <= budget
    except ValueError:          # no sweep tile of some region fits
        return False


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def _synth_data(p: Program, grid, seed: int, device, dtype: str):
    """Seeded synthetic inputs on ``device`` (fields and coefficients in
    the plan's dtype), made once per tune."""
    from .lower_kernel import DTYPES
    rng = np.random.default_rng(seed)
    grid = tuple(int(g) for g in grid)
    tdt = DTYPES[dtype]

    def put(a):
        return torch.as_tensor(a, device=device).to(tdt)

    fields = {f: put(rng.standard_normal(size=grid, dtype=np.float32) * 0.1)
              for f in p.input_fields()}
    scalars = {s: 0.05 for s in p.scalars}
    coeffs = {c: put(np.abs(rng.standard_normal(size=(grid[ax],),
                                                dtype=np.float32)) + 0.5)
              for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


def _roofline_fraction(cand: _Candidate, steps: int | None) -> float | None:
    """Modeled over measured time for the mode the candidate is ranked by
    (fused ``steps=N`` when measured, else single step); ``None`` when it
    was never measured."""
    meas_us = cand.us_fused if cand.us_fused is not None else cand.us_single
    if meas_us is None or meas_us <= 0:
        return None
    if not (cand.modeled_s > 0) or cand.modeled_s == float("inf"):
        return None
    mult = (steps or 1) if cand.us_fused is not None else 1
    return (cand.modeled_s * 1e6 * mult) / meas_us


def _executables(p, grid, cand: _Candidate, update, cfg: TuneConfig,
                 device, mesh=None, mesh_axes=None) -> list:
    """The candidate's single-step executable and, given ``update``, its
    fused ``steps=N`` one (over ``mesh``: the real sharded executables,
    halo exchange included)."""
    from .pipeline import CompileOptions, compile_program  # pipeline imports tune
    opts = CompileOptions(backend=cand.plan.backend, plan=cand.plan,
                          device=None if mesh is not None else device,
                          mesh=mesh, mesh_axes=mesh_axes)
    exes = [compile_program(p, grid, options=opts)]
    if update is not None:
        exes.append(compile_program(p, grid, options=dataclasses.replace(
            opts, steps=cfg.steps, update=update,
            carry_write=cand.carry_write)))
    return exes


# --------------------------------------------------------------------------
# the tuning loop
# --------------------------------------------------------------------------

def tune_plan(p: Program, grid, *, backend: str = "cuda",
              dtype: str = "float32", update=None,
              config: TuneConfig | None = None,
              cache: PlanCache | None = None, device=None,
              mesh=None, mesh_axes=None) -> TuneResult:
    """Search the plan space by measurement on ``device`` (the card by
    default) and persist the winner.

    Generates candidates, prunes by shared memory and ranks by the H100
    plan model, builds the survivors' kernels in one ``build_many``,
    measures them (single step always; fused ``steps=N`` when ``update``
    is given, which is then what the winner is ranked by), and stores the
    winning record under :func:`cache_key`.  The record also keeps the
    tune's seconds and the share of them ``nvcc`` took.

    With ``mesh``/``mesh_axes`` the search tunes a *sharded* plan:
    candidates are generated, pruned and priced on the per-shard local
    grid, every measurement runs the real sharded executable (halo
    exchange included) on the mesh's devices, and the cache key carries
    the mesh topology.
    """
    # deferred: repro_torch.analysis imports core modules, and this module
    # loads with the core package
    from ..analysis.stencil_roofline import model_plan
    t_start = time.perf_counter()
    cfg = config or TuneConfig()
    cache = PlanCache() if cache is None else cache
    grid = tuple(int(g) for g in grid)
    dev, mesh_axes, plan_grid = _tune_target(p, grid, device, mesh,
                                             mesh_axes)
    timer0 = cfg.timer or (
        lambda fn: best_of(fn, dev, cfg.warmup, cfg.repeats))

    def timer(fn):
        # every timing is counted process-wide: cache-hit checks assert a
        # zero delta here
        global_metrics().counter("tune.timed_runs").inc()
        return timer0(fn)

    with_loop = update is not None
    tracer = current_tracer()
    global_metrics().counter("tune.runs").inc()

    cands = _candidates(p, plan_grid, backend, dtype, cfg, with_loop)
    baseline, rest = cands[0], cands[1:]
    # prune by shared memory, then rank by the model; the baseline pays
    # for neither filter
    feasible = [c for c in rest
                if _fits(p, c.plan, plan_grid, cfg.smem_budget)]
    for c in [baseline] + feasible:
        c.modeled_s = model_plan(p, c.plan, plan_grid)
    feasible.sort(key=lambda c: c.modeled_s)
    survivors = [baseline] + feasible[:max(0, cfg.max_measured - 1)]

    exes = [_executables(p, grid, c, update, cfg, dev, mesh, mesh_axes)
            for c in survivors]
    build_s = 0.0
    if dev.type == "cuda":
        # every survivor's kernels at once, before the first timing
        sources = [k.module.source for e in exes for ex in e
                   for k in ex.kernels if k.module is not None]
        t0 = time.perf_counter()
        build.build_many(sources)
        build_s = time.perf_counter() - t0

    fields, scalars, coeffs = _synth_data(p, grid, cfg.seed, dev, dtype)
    with tracer.span("tune", program=p.name, backend=backend,
                     mode="loop" if with_loop else "single",
                     candidates=len(cands), measured=len(survivors)):
        for c, e in zip(survivors, exes):
            with tracer.span("tune.candidate", program=p.name,
                             label=c.label) as csp:
                c.us_single = timer(
                    lambda ex=e[0]: ex(fields, scalars, coeffs)) * 1e6
                if len(e) > 1:
                    c.us_fused = timer(
                        lambda ex=e[1]: ex(fields, scalars, coeffs)) * 1e6
                c.roofline_fraction = _roofline_fraction(
                    c, cfg.steps if with_loop else None)
                csp.set(modeled_us=c.modeled_s * 1e6,
                        us_single=c.us_single, us_fused=c.us_fused,
                        roofline_fraction=c.roofline_fraction)
    del exes, fields, scalars, coeffs

    order = sorted(range(len(survivors)),
                   key=lambda i: (survivors[i].score(), i))
    winner = survivors[order[0]]
    eff = winner.plan.stream if winner.plan.stream is not None \
        else winner.plan
    key = cache_key(p, grid, backend, device_name(dev), dtype,
                    "loop" if with_loop else "single", mesh=mesh,
                    mesh_axes=mesh_axes)
    record = {
        "plan": plan_to_dict(winner.plan),
        "carry_write": winner.carry_write,
        "label": winner.label,
        # effective chain depth and sweep width of the winner (1 = none)
        "time_tile": int(eff.time_tile),
        "plane_tile": int(eff.plane_tile),
        "us_single": winner.us_single,
        "us_fused": winner.us_fused,
        "baseline_us_single": baseline.us_single,
        "baseline_us_fused": baseline.us_fused,
        "modeled_us": winner.modeled_s * 1e6,
        # modeled over measured time for the winner (repro_torch.obs.
        # achieved); on the CPU the model still prices the card
        "roofline_fraction": winner.roofline_fraction,
        "mesh": _mesh_tag(mesh, mesh_axes),
        "steps": cfg.steps if with_loop else None,
        "candidates": len(cands),
        "measured": len(survivors),
        "fingerprint": program_fingerprint(p),
        "device": device_name(dev),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "tune_seconds": time.perf_counter() - t_start,
        "build_seconds": build_s,
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    cache.store(key, record)
    if tracer.enabled:
        tracer.emit(PlanChosen(
            program=p.name, backend=backend,
            schedule=winner.plan.schedule, strategy="tuned",
            label=winner.label, time_tile=record["time_tile"],
            plane_tile=record["plane_tile"], modeled_us=record["modeled_us"],
            measured_us=winner.score(),
            roofline_fraction=record["roofline_fraction"]))
    return TuneResult(plan=winner.plan, carry_write=winner.carry_write,
                      key=key, record=record, cache_hit=False,
                      measured=[survivors[i] for i in order])


def get_tuned_plan(p: Program, grid, *, backend: str = "cuda",
                   dtype: str = "float32", update=None,
                   config: TuneConfig | None = None,
                   cache: PlanCache | None = None,
                   device=None, mesh=None, mesh_axes=None) -> TuneResult:
    """Cache-first entry point behind ``compile_program(strategy="tuned")``.

    A hit deserialises the stored plan and performs **zero** timed runs; a
    miss runs :func:`tune_plan` and persists the winner.  The key does not
    encode the search effort: pass a config with ``force_retune=True`` to
    search again (and overwrite the entry) with other knobs.
    """
    grid = tuple(int(g) for g in grid)
    dev, mesh_axes, _ = _tune_target(p, grid, device, mesh, mesh_axes)
    cache = PlanCache() if cache is None else cache
    key = cache_key(p, grid, backend, device_name(dev), dtype,
                    "loop" if update is not None else "single", mesh=mesh,
                    mesh_axes=mesh_axes)
    rec = None if (config is not None and config.force_retune) \
        else cache.lookup(key)
    tracer = current_tracer()
    if rec is not None:
        if tracer.enabled:
            tracer.emit(CacheHit(cache="tuned_plan", key=key))
        return TuneResult(plan=plan_from_dict(rec["plan"]),
                          carry_write=rec.get("carry_write", "repad"),
                          key=key, record=rec, cache_hit=True)
    if tracer.enabled:
        tracer.emit(CacheMiss(cache="tuned_plan", key=key))
    return tune_plan(p, grid, backend=backend, dtype=dtype, update=update,
                     config=config, cache=cache, device=dev, mesh=mesh,
                     mesh_axes=mesh_axes)


def _tune_target(p: Program, grid: tuple, device, mesh, mesh_axes) -> tuple:
    """``(device, mesh_axes, plan_grid)`` of a search: the device (the
    mesh's first, under a mesh), the normalised mesh axes, and the grid
    candidates are priced on (the shard-local one under a mesh)."""
    from .pipeline import mesh_device, resolve_device
    if mesh is None:
        return resolve_device(device), mesh_axes, grid
    if mesh_axes is None:
        mesh_axes = tuple(mesh.axis_names)
    mesh_axes = normalize_mesh_axes(mesh_axes, p.ndim)
    return (mesh_device(mesh, device), mesh_axes,
            shard_local_grid(grid, mesh, mesh_axes))


# --------------------------------------------------------------------------
# Serving-layer executor records (the stencil serving engine's slice of the
# plan cache)
# --------------------------------------------------------------------------

def make_serve_record(plan: DataflowPlan, carry_write: str,
                      bucket: Sequence[int], steps: int | None) -> dict:
    """Executor record a serving engine persists per compiled bucket: the
    plan the executable was built from, and enough besides that a fresh
    process rebuilds the same executable without planning or tuning.
    Schema-stamped like tuned-plan records (:func:`read_serve_record`)."""
    return {
        "kind": "serve_executor",
        "schema": PLAN_SCHEMA_VERSION,
        "plan": plan_to_dict(plan),
        "carry_write": carry_write,
        "bucket": [int(b) for b in bucket],
        "steps": None if steps is None else int(steps),
        "torch_version": torch.__version__,
        "stored_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def read_serve_record(rec: dict | None):
    """Decode a serving executor record: ``(plan, carry_write)``, or
    ``None`` when the record is absent, malformed, or of another
    ``PLAN_SCHEMA_VERSION`` (a clean miss, never a misdecoded plan)."""
    if not isinstance(rec, dict) or rec.get("kind") != "serve_executor":
        return None
    if rec.get("schema") != PLAN_SCHEMA_VERSION:
        return None
    try:
        plan = plan_from_dict(rec["plan"])
    except (KeyError, TypeError, ValueError):
        return None
    return plan, rec.get("carry_write", "repad")
