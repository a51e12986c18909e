"""A profiled stretch of calls, read from ``torch.profiler``'s raw events.

The profile keeps, for each device operation (kernel, copy or set), its
name, start, end, card and correlation id, and for each host event its
span, thread and correlation id (a runtime call that enqueues an
operation shares the operation's id). The raw events
(``kineto_results``) are read directly: the profiler's own event tree
takes tens of times as long to build.

A stretch over several cards is read card by card: each card's busy time
and idle gaps are its own, and :func:`summarise` reports every quantity
for the mean card of the run.
"""

from __future__ import annotations

import heapq
import re

CALL_SPAN = "bench.call"


def profile_calls(torch, call, n: int, on_card: bool = True,
                  sync=None) -> dict:
    """Run ``call`` ``n`` times under the profiler, each followed by
    ``sync()`` (the card's synchronise by default) inside a ``bench.call``
    range; return the raw stretch. ``on_card=False`` profiles the host
    alone (the CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if sync is None:
        sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        for _ in range(n):
            with record_function(CALL_SPAN):
                out = call()
                sync()
            del out
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id(),
                         e.correlation_id()))
        elif (e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and not name.startswith("[")):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name, e.device_index(), e.correlation_id()))
    return {"calls": n, "host": host, "device": device}


def generated_matcher(entries):
    """A test of whether a device operation's name is one of the program's
    generated kernels (``<entry>_kernel``)."""
    if not entries:
        return lambda name: False
    pat = re.compile(r"(?<![A-Za-z0-9_])(?:"
                     + "|".join(re.escape(e) for e in sorted(set(entries)))
                     + r")_kernel\b")
    return lambda name: bool(pat.search(name))


def short_name(name: str) -> str:
    """A device operation's name without its namespaces and, for a
    generated kernel, its parameters."""
    for part in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(part, "")
    if re.match(r"g\d+_kernel<", name):
        name = name.split("(", 1)[0]
    return name[:120]


def _busy_and_gaps(ops, w0: int, w1: int) -> tuple:
    """Nanoseconds in which some operation of ``ops`` (clipped to the
    window, sorted) runs, and the gaps ``[(a, b)]`` in which none does."""
    busy, gaps, cur_a, cur_b = 0, [], None, w0
    for a, b, *_ in ops:
        if cur_a is None or a > cur_b:
            if a > cur_b:
                gaps.append((cur_b, a))
            if cur_a is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if cur_b < w1:
        gaps.append((cur_b, w1))
    return busy, gaps


def _innermost(spans, points) -> list:
    """For each of ``points``, the least ``(duration, name)`` of the
    sorted ``spans`` ``(start, end, name)`` that cover it, or None: one
    sweep, holding only the spans open at the point."""
    out = [None] * len(points)
    open_, i = [], 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        p = points[k]
        while i < len(spans) and spans[i][0] <= p:
            a, b, name = spans[i]
            heapq.heappush(open_, (b, a, name))
            i += 1
        while open_ and open_[0][0] < p:
            heapq.heappop(open_)
        if open_:
            out[k] = min((b - a, name) for b, a, name in open_)
    return out


def summarise(raw: dict, is_generated, demangle=lambda s: s,
              cards: int = 1) -> dict:
    """Busy time, the traced window, device time by kind, the busiest
    device operations and the idle gaps by what the host was doing, each
    for the mean card of ``cards`` (a card with no operation is idle
    throughout)."""
    calls = [(a, b, tid) for a, b, name, tid, _ in raw["host"]
             if name == CALL_SPAN]
    if not calls:
        raise RuntimeError("the profile holds no bench.call range")
    w0 = min(a for a, _, _ in calls)
    w1 = max(b for _, b, _ in calls)
    main = calls[0][2]
    dev = sorted((max(a, w0), min(b, w1), name, card)
                 for a, b, name, card, _ in raw["device"]
                 if b > w0 and a < w1)
    by_card: dict = {}
    for op in dev:
        by_card.setdefault(op[3], []).append(op)
    busy, gaps, busy_by_card = 0, [], {}
    for card, ops in sorted(by_card.items()):
        b, g = _busy_and_gaps(ops, w0, w1)
        busy += b
        gaps += g
        busy_by_card[card] = b / 1e9
    gaps += [(w0, w1)] * max(0, cards - len(by_card))
    gen_ns = aux_ns = 0
    kernels = generated = 0
    by_name: dict = {}
    for a, b, name, _ in dev:
        d = b - a
        if is_generated(name):
            gen_ns += d
            generated += 1
        else:
            aux_ns += d
        kernels += 1
        key = short_name(demangle(name))
        by_name[key] = by_name.get(key, 0) + d
    spans = sorted((a, b, name) for a, b, name, tid, _ in raw["host"]
                   if tid == main)
    idle: dict = {}
    inner = _innermost(spans, [(a + b) // 2 for a, b in gaps])
    for (a, b), cover in zip(gaps, inner):
        what = cover[1] if cover else "outside any host event"
        idle[what] = idle.get(what, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    per = 1e9 * cards
    return {"calls": raw["calls"], "cards": cards,
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / per, "busy_by_card": busy_by_card,
            "generated_s": gen_ns / per,
            "aux_s": aux_ns / per, "device_ops": kernels / cards,
            "generated_ops": generated / cards,
            "top": [[n, ns / per] for n, ns in top],
            "idle_gaps": [[n, ns / per] for n, ns in gap_top],
            "raw": raw}
