"""Device time by the program's own spans, and the program's counters.

While ``torch.profiler`` runs, the port's orchestrator opens a
``record_function`` range for each of its ``stencil.*`` spans
(``stencil.call`` > ``stencil.prologue``, ``stencil.step`` >
``stencil.pad`` / ``stencil.kernel`` / ``stencil.update`` /
``stencil.write_back``), and its mesh orchestrator one for each halo
exchange (``distribute.exchange``). They arrive among the profiled
stretch's host events (``devtrace.profile_calls``'s ``raw["host"]``).
Each device operation is put down to the runtime call that enqueued it
(kernel launches, copies and sets), the one that shares its correlation
id, and that call to the innermost such range open on its thread when it
was made. No operation's time is compared with its call's: the profiler
maps the device's clock onto the host's only to within a millisecond.

A program without these spans (an older one) gives no attribution, and the
readers built on it report nothing. The counters are read from the
program's ``global_metrics()`` in the run's process, and the mesh's
exchanged bytes from its ``distribute`` module; a program without them
gives None too.
"""

from __future__ import annotations

import re
import sys

PREFIX = "stencil."
#: the ranges operations are put down to: the orchestrators' spans
RANGES = (PREFIX, "distribute.")
#: the runtime and driver calls that enqueue one device operation each
ENQUEUE = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel"
                     r"|Memcpy|Memset)")
GENERATED = re.compile(r"(?<![A-Za-z0-9_])g\d+_kernel\b")
KERNEL = "stencil.kernel"
UNATTRIBUTED = "unattributed"


def attribute(raw: dict) -> dict | None:
    """Device nanoseconds and operation counts by the innermost
    ``stencil.*`` or ``distribute.*`` span that launched them: ``{"by_span":
    {name: {"ns", "ops", "generated_ns", "generated_ops"}}, "device_ns",
    "device_ops"}``, summed over the cards, with the operations launched
    outside any such span under ``"unattributed"``, and ``"lost"``, the
    enqueueing calls whose device records the profiler dropped. None where
    the stretch holds no such range or no device operation, or where the
    calls and the operations do not pair: an operation with no call, an
    operation of another kind (copy, set, kernel) than its call, or, where
    the program opens ``stencil.kernel`` spans, a generated kernel
    (``g<i>_kernel``) whose call is not in one."""
    host, device = raw["host"], raw["device"]
    calls = [tid for _, _, name, tid, _ in host if name == "bench.call"]
    if not calls or not device:
        return None
    main = calls[0]
    ranges = sorted((a, b, name) for a, b, name, tid, _ in host
                    if tid == main and name.startswith(RANGES))
    if not ranges:
        return None
    launches = sorted((a, name, corr) for a, _, name, tid, corr in host
                      if tid == main and ENQUEUE.match(name))
    pairs = _pair(launches, sorted(device))
    if pairs is None:
        return None
    lost = len(launches) - len(pairs)
    check_kernels = any(name == KERNEL for _, _, name in ranges)
    by_span: dict = {}
    stack: list = []
    i = 0
    for (t, _, _), (a, b, name, *_) in pairs:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        span = stack[-1][2] if stack else UNATTRIBUTED
        if check_kernels and GENERATED.search(name) and span != KERNEL:
            return None         # a generated kernel out of its span
        rec = by_span.setdefault(span, {"ns": 0, "ops": 0,
                                        "generated_ns": 0,
                                        "generated_ops": 0})
        rec["ns"] += b - a
        rec["ops"] += 1
        if GENERATED.search(name):
            rec["generated_ns"] += b - a
            rec["generated_ops"] += 1
    return {"by_span": by_span,
            "device_ns": sum(r["ns"] for r in by_span.values()),
            "device_ops": len(pairs), "lost": lost}


def _pair(launches, ops) -> list | None:
    """``[(launch, op)]`` in the launches' order, each operation with the
    call of its correlation id, or None where an operation has no such
    call or one of another kind (copy, set, kernel). Calls whose
    operations the profiler dropped (now and then the stretch's first)
    pair with nothing."""
    by_id = {la[2]: la for la in launches}
    if len(by_id) != len(launches) or any(op[4] not in by_id for op in ops):
        return None
    pairs = sorted(((by_id[op[4]], op) for op in ops), key=lambda p: p[0][0])
    if any(_kind(call) != _kind(op[2]) for (_, call, _), op in pairs):
        return None
    return pairs


def _kind(name: str) -> str:
    """A runtime call's or a device operation's kind: a copy, a set or a
    kernel."""
    for kind in ("Memcpy", "Memset"):
        if kind in name:
            return kind
    return "kernel"


def of_run(run) -> dict | None:
    """:func:`attribute` of a ``--trace 1`` run's stretch, made once and
    kept in ``run.trace["spans"]``."""
    tr = run.trace
    if not tr:
        return None
    if "spans" not in tr:
        tr["spans"] = attribute(tr["raw"])
    return tr["spans"]


def device_ms_per_step(run, span: str) -> float | None:
    """Device milliseconds a step launched inside ``span`` on the mean
    card (0 where the program opened no such span)."""
    att = of_run(run)
    if att is None:
        return None
    ns = att["by_span"].get(span, {}).get("ns", 0)
    return ns / 1e6 / (run.trace["calls"] * run.steps_per_call) \
        / run.trace["cards"]


def counters() -> dict | None:
    """The program's ``stencil.*`` counters, summed over every call the
    run's process made; None where the program keeps none."""
    mod = sys.modules.get("repro_torch.obs.metrics")
    if mod is None:
        return None
    snap = mod.global_metrics().snapshot()
    if not snap.get(PREFIX + "steps"):
        return None
    return {k[len(PREFIX):]: v for k, v in snap.items()
            if k.startswith(PREFIX)}


def exchanged_bytes() -> int | None:
    """The bytes of halo slabs the program's mesh orchestrator has moved
    between shards in the run's process; None before it is loaded."""
    mod = sys.modules.get("repro_torch.core.distribute")
    return getattr(mod, "exchanged_bytes", None)
