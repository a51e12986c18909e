"""StencilEngine — batched, cached, concurrent stencil execution on the
card (the port of ``repro.serve.engine``).

The serving layer turns the compile pipeline into a long-lived service:
requests (program, fields, steps, boundary) arrive on a bounded queue, a
single worker thread micro-batches them, and each distinct *bucket*
(program fingerprint x quantised grid bucket x backend/compile options x
update rule) is compiled exactly once — warm requests build no kernel.

Three layers of reuse, coarsest first:

1. **executor table** (in-memory): ``bucket key -> _BucketExecutor``
   holding the compiled executable and its batched form
   (:func:`~repro_torch.core.pipeline.batched_executable`, the reference's
   ``jax.jit(jax.vmap(...))``): with ``backend="cuda"`` each generated
   kernel launches once a step for the whole batch.  A hot request is a
   dict lookup.
2. **plan records** (:class:`~repro_torch.core.tune.PlanCache`): on an
   executor build the engine consults the persistent cache for a serving
   record (:func:`~repro_torch.core.tune.read_serve_record`) and rebuilds
   from the stored plan without re-planning; a build that had to plan
   stores its record so the *next process* skips the work.  Stale-schema
   records miss cleanly.
3. **shape buckets** (:mod:`repro_torch.serve.bucket`): request grids
   round up to quantised buckets and grid sizes enter the executable as
   scalars, so mixed request shapes share executors and batch together.

Threading model: ``submit`` may be called from any thread (it only
validates, keys, and enqueues); all device work happens on the one worker
thread, which launches on its own current stream of the engine's device
and waits for a batch to finish before it answers, so executors and stats
need no locking of their own.  Answers are tensors on the engine's device.

``mesh=`` with ``mesh_axes=`` serves every bucket through the
distributed executor (:mod:`repro_torch.core.distribute`): executors are
keyed by the mesh topology, answers gather on the mesh's first device, a
fused loop's bucket refresh masks in global coordinates through each
shard's origin, and fused serving of periodic fields under a sharded mesh
is refused, as in the reference (the refresh's torus gather has no
shard-local form).

Where it differs from the reference: ``backend="cuda"`` is the default;
``device=None`` means the card and raises without one (``device="cpu"``
runs the kernels' plain versions, for the tests); there is no
``interpret``; and a batch whose launch fails fails its requests — it is
never retried unrolled nor moved to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Mapping

import numpy as np
import torch

from .. import hw
from ..core.ir import Program
from ..core.lower_kernel import DTYPES
from ..core.pipeline import (CompileOptions, mesh_device,
                             batched_executable, compile_program,
                             resolve_device)
from ..core.schedule import (BucketSpec, bucket_fingerprint, bucket_for,
                             normalize_mesh_axes)
from ..core.tune import PlanCache, make_serve_record, read_serve_record
from ..obs.events import CacheHit, CacheMiss, ExecutorEvicted
from ..obs.trace import current_tracer, resolve_tracer
from .bucket import embed_request, serving_program, wrap_update
from .stats import ServeStats


@dataclasses.dataclass
class StencilRequest:
    """One unit of serving work.

    ``fields`` are real-grid arrays (the grid is their common shape);
    ``steps`` + ``update`` select the fused time loop (result = final
    fields), both None selects a single application (result = program
    outputs).  ``update_key`` names the update rule for executor keying —
    required whenever two *different* rules share a qualname (lambdas,
    closures built per call); it defaults to the rule's qualified name.
    ``boundary`` overrides the program's declarations as in
    ``compile_program``.  ``timeout`` (seconds) expires the request if it
    is still queued when the deadline passes.
    """

    program: Program
    fields: Mapping
    scalars: Mapping | None = None
    coeffs: Mapping | None = None
    steps: int | None = None
    update: Callable | None = None
    update_key: str | None = None
    boundary: object = None
    timeout: float | None = None

    def grid(self) -> tuple:
        shapes = {tuple(np.shape(v)) for v in self.fields.values()}
        if len(shapes) != 1:
            raise ValueError(f"request fields disagree on grid: {shapes}")
        return next(iter(shapes))


@dataclasses.dataclass
class ServeResult:
    outputs: dict                 # real-grid tensors on the engine's device
    bucket: BucketSpec
    key: str
    latency_ms: float
    batch_size: int               # real requests in the executed batch


@dataclasses.dataclass
class _Item:
    req: StencilRequest
    program: Program              # serving program (boundary applied)
    spec: BucketSpec
    key: str
    future: Future
    submitted: float
    deadline: float | None


@dataclasses.dataclass
class _BucketExecutor:
    """One compiled bucket: the batched executable, the plan it was built
    from and the kernels it launches."""

    program: Program
    spec: BucketSpec
    steps: int | None
    batched: Callable
    plan: object
    carry_write: str
    kernels: list


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class StencilEngine:
    """Async serving front over the compile pipeline.

    ``submit`` returns a :class:`concurrent.futures.Future` resolving to a
    :class:`ServeResult`; ``run`` is the synchronous one-request helper.
    ``autostart=False`` leaves the worker thread unstarted (requests queue
    up; call :meth:`start` to begin draining — used by the bounded-queue
    tests and by callers that want to pre-fill a batch).

    Compile knobs may arrive loose (``backend=``, ``schedule=``,
    ``time_tile=``, ``device=``, ...) or bundled in an
    ``options=CompileOptions(...)``; the options object seeds any knob the
    caller left at its engine default, and a knob set both ways with
    different values is an error.  ``max_executors=`` puts an LRU cap on
    the executor table: lookups refresh recency, an insert over the cap
    evicts the coldest executor (and the kernels it holds), counted in
    ``stats.evictions``.  ``lane=`` is the bucket quantum of the
    contiguous axis (:data:`hw.BUCKET_LANE` by default).
    """

    #: compile knobs the engine shares with :class:`CompileOptions`; an
    #: ``options=`` object seeds these, loose kwargs override (a loose
    #: kwarg moved off its engine default that *disagrees* with the
    #: options value is an error, mirroring ``compile_program``).
    _OPTION_KNOBS = (("backend", "cuda"), ("schedule", None),
                     ("strategy", "auto"), ("dtype", "float32"),
                     ("mesh", None), ("mesh_axes", None),
                     ("time_tile", None), ("plane_tile", None),
                     ("device", None))

    def __init__(self, *, backend: str = "cuda",
                 schedule: str | None = None, strategy: str = "auto",
                 dtype: str = "float32", mesh=None,
                 mesh_axes: tuple | None = None, time_tile: int | None = None,
                 plane_tile: int | None = None, device=None,
                 options: CompileOptions | None = None, max_batch: int = 8,
                 window_s: float = 0.002, queue_depth: int = 64,
                 max_executors: int | None = None,
                 plan_cache: PlanCache | None = None,
                 lane: int = hw.BUCKET_LANE, autostart: bool = True,
                 tracer=None):
        loose = dict(backend=backend, schedule=schedule, strategy=strategy,
                     dtype=dtype, mesh=mesh, mesh_axes=mesh_axes,
                     time_tile=time_tile, plane_tile=plane_tile,
                     device=device)
        co_defaults = {f.name: f.default
                       for f in dataclasses.fields(CompileOptions)}
        for name, default in self._OPTION_KNOBS:
            val = loose[name]
            if options is not None:
                oval = getattr(options, name)
                if val == default:
                    val = oval      # options seeds every untouched knob
                elif oval != co_defaults[name] and oval != val:
                    raise ValueError(
                        f"{name} passed both ways with different values: "
                        f"engine {name}={val!r} vs options.{name}={oval!r}")
            setattr(self, name, val)
        if self.mesh is not None and self.mesh_axes is None:
            raise ValueError("mesh= requires mesh_axes= (one entry per grid "
                             "axis; None leaves an axis unsharded)")
        if self.mesh is not None:
            # the mesh decides where the executors run; answers gather on
            # its first device
            self.device = mesh_device(self.mesh, self.device)
        else:
            self.device = resolve_device(self.device)
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.max_executors = (None if max_executors is None
                              else int(max_executors))
        if self.max_executors is not None and self.max_executors < 1:
            raise ValueError("max_executors must be >= 1 (or None for "
                             "unbounded)")
        self.plan_cache = plan_cache
        self.lane = int(lane)
        # the engine's tracer is captured at construction (worker threads
        # can't see the submitting thread's ambient tracer): ``tracer=``
        # pins one, ``tracer=True`` installs a fresh recording tracer,
        # None inherits whatever is ambient *now* (usually the no-op)
        self.tracer = (current_tracer() if tracer is None
                       else resolve_tracer(tracer))
        self.stats = ServeStats()
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        # LRU over compiled buckets: hits refresh recency, inserts evict
        # the coldest entry once over ``max_executors`` (dropping its
        # kernels with it)
        self._executors: collections.OrderedDict = collections.OrderedDict()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tdtype = DTYPES[self.dtype]
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker,
                                            name="stencil-serve", daemon=True)
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=30)
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            it.future.set_exception(RuntimeError("engine closed"))
            self.stats.failed += 1

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # request front
    # ------------------------------------------------------------------
    def describe(self, req: StencilRequest):
        """Validate a request and resolve its serving identity:
        ``(serving_program, BucketSpec, executor key)`` — exactly what the
        worker will compile and cache under.  Useful for pre-warming and
        for tests poking at the plan cache."""
        if (req.steps is None) != (req.update is None):
            raise ValueError("steps and update go together: both set "
                             "(fused loop) or both None (single apply)")
        p = req.program
        if req.boundary is not None:
            p = p.with_boundary(req.boundary)
        if req.steps is not None and self.mesh is not None:
            ma = normalize_mesh_axes(self.mesh_axes, p.ndim)
            if any(a is not None and int(self.mesh.shape[a]) > 1
                   for a in ma):
                per = sorted(f for f in p.input_fields()
                             if p.boundaries().get(f) == "periodic")
                if per:
                    raise ValueError(
                        f"fused serving of periodic fields {per} under "
                        "mesh= is not supported: the bucket refresh is a "
                        "global torus gather with no shard-local form; "
                        "serve them unsharded or use boundary='zero'")
        sp = serving_program(p)
        missing = set(sp.input_fields()) - set(req.fields)
        if missing:
            raise ValueError(f"request missing input fields {sorted(missing)}")
        missing = set(p.scalars) - set(req.scalars or {})
        if missing:
            raise ValueError(f"request missing scalars {sorted(missing)}")
        spec = bucket_for(sp, req.grid(), lane=self.lane)
        ukey = req.update_key
        if ukey is None:
            ukey = ("none" if req.update is None else
                    f"{req.update.__module__}.{req.update.__qualname__}")
        key = "|".join([
            bucket_fingerprint(sp, spec.bucket, backend=self.backend,
                               dtype=self.dtype, schedule=self.schedule,
                               steps=req.steps, mesh=self.mesh,
                               mesh_axes=self.mesh_axes,
                               plane_tile=self.plane_tile),
            f"time_tile={self.time_tile or 'plan'}",
            f"update={ukey}",
        ])
        return sp, spec, key

    def submit(self, req: StencilRequest) -> Future:
        """Validate, key, and enqueue; raises ``queue.Full`` when the
        bounded queue is at depth (backpressure, not silent dropping)."""
        sp, spec, key = self.describe(req)
        now = time.monotonic()
        item = _Item(req=req, program=sp, spec=spec, key=key,
                     future=Future(), submitted=now,
                     deadline=None if req.timeout is None
                     else now + req.timeout)
        self._q.put_nowait(item)
        self.stats.submitted += 1
        return item.future

    def run(self, req: StencilRequest, timeout: float | None = None
            ) -> ServeResult:
        return self.submit(req).result(timeout)

    def map(self, reqs, timeout: float | None = None) -> list:
        futs = [self.submit(r) for r in reqs]
        return [f.result(timeout) for f in futs]

    # ------------------------------------------------------------------
    # worker: micro-batching loop
    # ------------------------------------------------------------------
    def _worker(self) -> None:
        # install the engine's tracer as this thread's ambient tracer so
        # every compile_program / tuner emission from the worker lands in
        # the same trace as the serve spans; launch on the engine's card
        with self.tracer.active():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._worker_loop()
            else:
                self._worker_loop()

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.monotonic()
            # micro-batch window: wait briefly for same-bucket company
            while len(batch) < self.max_batch:
                left = self.window_s - (time.monotonic() - t0)
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            groups: dict = {}
            for it in batch:
                groups.setdefault(it.key, []).append(it)
            for key, items in groups.items():
                self._process_group(key, items)

    def _process_group(self, key: str, items: list) -> None:
        now = time.monotonic()
        live = []
        for it in items:
            if it.deadline is not None and now > it.deadline:
                self.stats.timeouts += 1
                it.future.set_exception(
                    TimeoutError(f"request expired after {it.req.timeout}s "
                                 "in queue"))
            else:
                live.append(it)
        if not live:
            return
        tracer = self.tracer
        try:
            if key in self._executors:
                self.stats.exec_hits += len(live)
                if tracer.enabled:
                    tracer.emit(CacheHit(cache="executor", key=key))
                self._executors.move_to_end(key)      # refresh LRU recency
                ex = self._executors[key]
            else:
                self.stats.exec_misses += len(live)
                if tracer.enabled:
                    tracer.emit(CacheMiss(cache="executor", key=key))
                ex = self._build_executor(key, live[0])
                self._executors[key] = ex
                while (self.max_executors is not None
                       and len(self._executors) > self.max_executors):
                    cold, _ = self._executors.popitem(last=False)
                    self.stats.evictions += 1
                    if tracer.enabled:
                        tracer.emit(ExecutorEvicted(
                            key=cold, resident=len(self._executors)))
        except Exception as e:  # compile/planning failure fails the group
            for it in live:
                self.stats.failed += 1
                it.future.set_exception(e)
            return
        for i in range(0, len(live), self.max_batch):
            self._run_batch(ex, live[i:i + self.max_batch])

    # ------------------------------------------------------------------
    # executor build (plan-record reuse lives here)
    # ------------------------------------------------------------------
    def _build_executor(self, key: str, item: _Item) -> _BucketExecutor:
        sp, spec, req = item.program, item.spec, item.req
        tracer = self.tracer
        with tracer.span("serve.build_executor", program=sp.name,
                         bucket="x".join(str(b) for b in item.spec.bucket),
                         steps=req.steps) as bsp:
            plan = carry_write = None
            record_hit = False
            if self.plan_cache is not None:
                dec = read_serve_record(self.plan_cache.lookup(key))
                if dec is not None:
                    plan, carry_write = dec
                    record_hit = True
                    self.stats.plan_hits += 1
                    if tracer.enabled:
                        tracer.emit(CacheHit(cache="serve_record", key=key))
                else:
                    self.stats.plan_misses += 1
                    if tracer.enabled:
                        tracer.emit(CacheMiss(cache="serve_record", key=key))
            update = (None if req.update is None
                      else wrap_update(sp, spec, req.update))
            ex = compile_program(
                sp, spec.bucket, options=CompileOptions(
                    backend=self.backend, plan=plan, dtype=self.dtype,
                    strategy=self.strategy, steps=req.steps, update=update,
                    carry_write=carry_write, schedule=self.schedule,
                    time_tile=self.time_tile, plane_tile=self.plane_tile,
                    plan_cache=self.plan_cache, device=self.device,
                    mesh=self.mesh, mesh_axes=self.mesh_axes))
            self.stats.compiles += 1
            # each translation unit the compile bound is one kernel build
            self.stats.traces += len({id(c.module) for c in ex.kernels
                                      if c.module is not None})
            bsp.set(record_hit=record_hit, schedule=ex.plan.schedule)
        cw = ex.time_spec.carry_write if ex.time_spec is not None else "repad"
        if self.plan_cache is not None and not record_hit:
            self.plan_cache.store(
                key, make_serve_record(ex.plan, cw, spec.bucket, req.steps))
        return _BucketExecutor(program=sp, spec=spec, steps=req.steps,
                               batched=batched_executable(ex), plan=ex.plan,
                               carry_write=cw, kernels=list(ex.kernels))

    # ------------------------------------------------------------------
    # batch execution
    # ------------------------------------------------------------------
    def _run_batch(self, ex: _BucketExecutor, items: list) -> None:
        with self.tracer.span("serve.batch", program=ex.program.name,
                              n=len(items)) as sp:
            self._run_batch_traced(ex, items, sp)

    def _run_batch_traced(self, ex: _BucketExecutor, items: list, sp) -> None:
        t0 = time.monotonic()
        dev = self.device
        try:
            n = len(items)
            pad = _pow2_at_least(n)
            fields, scalars, coeffs = self._stack(ex.program, items, pad)
            out = ex.batched(fields, scalars, coeffs)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            self.stats.batches += 1
            self.stats.batched_requests += n
            self.stats.padded_slots += pad - n
            sp.set(padded=pad - n)
            done = time.monotonic()
            self.stats.wall_s += done - t0
            for i, it in enumerate(items):
                res = ServeResult(
                    outputs={k: v[i][it.spec.interior()].clone()
                             for k, v in out.items()},
                    bucket=it.spec, key=it.key,
                    latency_ms=(done - it.submitted) * 1e3, batch_size=n)
                self.stats.completed += 1
                self.stats.record_latency(res.latency_ms)
                it.future.set_result(res)
        except Exception as e:
            for it in items:
                if not it.future.done():
                    self.stats.failed += 1
                    it.future.set_exception(e)

    def _stack(self, sp: Program, items: list, pad: int) -> tuple:
        """Embed each item's arrays into its bucket on the host and stack
        them on the engine's device: ``pad`` slots, slot 0 replicated into
        the slots past the real requests.  Returns (fields ``(pad,
        *bucket)``, scalars ``(pad,)``, coefficients ``(pad, n)``)."""
        dev, n = self.device, len(items)
        embedded = [embed_request(sp, it.spec, it.req.fields, it.req.scalars,
                                  it.req.coeffs) for it in items]

        def rows(leaves):
            arr = np.stack([np.asarray(x, dtype=np.float32) for x in leaves])
            if pad > n:  # replicate slot 0 into the filler slots
                arr = np.concatenate([arr, np.repeat(arr[:1], pad - n,
                                                     axis=0)])
            return arr

        def on_card(leaves):
            return torch.from_numpy(rows(leaves)).to(device=dev,
                                                     dtype=self._tdtype)

        fields = {f: on_card([e[0][f] for e in embedded])
                  for f in embedded[0][0]}
        names = list(embedded[0][1])
        svals = torch.from_numpy(np.ascontiguousarray(rows(
            [[np.float32(e[1][s]) for s in names] for e in embedded]).T)
        ).to(dev)
        scalars = {s: svals[i] for i, s in enumerate(names)}
        coeffs = {c: on_card([e[2][c] for e in embedded])
                  for c in embedded[0][2]}
        return fields, scalars, coeffs

    # ------------------------------------------------------------------
    # inspection (the card-side checks drive a bucket's batch directly)
    # ------------------------------------------------------------------
    def executor(self, key: str) -> _BucketExecutor | None:
        """The compiled executor of ``key``, if the table holds it."""
        return self._executors.get(key)

    def batch_inputs(self, reqs) -> tuple:
        """``(key, fields, scalars, coeffs)``: the batched arguments the
        worker would run ``reqs`` with (they must share one bucket), not
        padded to a power of two."""
        items = [self.describe(r) for r in reqs]
        keys = {k for _, _, k in items}
        if len(keys) != 1:
            raise ValueError(f"requests span {len(keys)} executors")
        its = [_Item(req=r, program=sp, spec=spec, key=k, future=Future(),
                     submitted=0.0, deadline=None)
               for r, (sp, spec, k) in zip(reqs, items)]
        return (keys.pop(),) + self._stack(its[0].program, its, len(its))
