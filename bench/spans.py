"""Device time by the program's own spans, and the program's counters.

While ``torch.profiler`` runs, the port's orchestrator opens a
``record_function`` range for each of its ``stencil.*`` spans
(``stencil.call`` > ``stencil.prologue``, ``stencil.step`` >
``stencil.pad`` / ``stencil.kernel`` / ``stencil.update`` /
``stencil.write_back``). They arrive among the profiled stretch's host
events (``devtrace.profile_calls``'s ``raw["host"]``). Each device
operation is put down to the runtime call that enqueued it (kernel
launches, copies and sets, in issue order: the program runs on one
stream, which runs them in that order; the raw events carry no
correlation ids), and that call to the innermost ``stencil.*`` range
open on its thread when it was made.

A program without these spans (an older one) gives no attribution, and the
readers built on it report nothing. The counters are read from the
program's ``global_metrics()`` in the run's process; a program without
them gives None too.
"""

from __future__ import annotations

import re
import sys

PREFIX = "stencil."
#: the runtime and driver calls that enqueue one device operation each
ENQUEUE = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel"
                     r"|Memcpy|Memset)")
GENERATED = re.compile(r"(?<![A-Za-z0-9_])g\d+_kernel\b")
KERNEL = "stencil.kernel"
UNATTRIBUTED = "unattributed"


def attribute(raw: dict) -> dict | None:
    """Device nanoseconds and operation counts by the innermost
    ``stencil.*`` span that launched them: ``{"by_span": {name: {"ns",
    "ops", "generated_ns", "generated_ops"}}, "device_ns", "device_ops"}``,
    with the operations launched outside any such span under
    ``"unattributed"``, and ``"lost"``, the enqueueing calls at the
    stretch's start whose device records the profiler dropped. None where
    the stretch holds no ``stencil.*`` range or no device operation, or
    where the calls and the operations do not pair: more operations than
    calls, an operation of another kind (copy, set, kernel) than its call,
    or a generated kernel (``g<i>_kernel``) whose call is not in a
    ``stencil.kernel`` span."""
    host, device = raw["host"], raw["device"]
    calls = [tid for _, _, name, tid in host if name == "bench.call"]
    if not calls or not device:
        return None
    main = calls[0]
    ranges = sorted((a, b, name) for a, b, name, tid in host
                    if tid == main and name.startswith(PREFIX))
    if not ranges:
        return None
    launches = sorted((a, name) for a, _, name, tid in host
                      if tid == main and ENQUEUE.match(name))
    ops = sorted(device)
    # the profiler loses the records of the stretch's first device
    # operations now and then, never of its last: pair from the end
    lost = len(launches) - len(ops)
    if lost < 0:
        return None
    launches = launches[lost:]
    # the device's clock is mapped onto the host's to within a millisecond
    # or so, so an operation may seem to start before its call: only the
    # kinds are held to agree
    if any(_kind(call) != _kind(name)
           for (_, call), (_, _, name) in zip(launches, ops)):
        return None
    by_span: dict = {}
    stack: list = []
    i = 0
    for (t, _), (a, b, name) in zip(launches, ops):
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        span = stack[-1][2] if stack else UNATTRIBUTED
        if GENERATED.search(name) and span != KERNEL:
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
            "device_ops": len(ops), "lost": lost}


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
    """Device milliseconds a step launched inside ``span`` (0 where the
    program opened no such span)."""
    att = of_run(run)
    if att is None:
        return None
    ns = att["by_span"].get(span, {}).get("ns", 0)
    return ns / 1e6 / (run.trace["calls"] * run.steps_per_call)


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
