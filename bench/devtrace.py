"""A profiled stretch of calls, read from ``torch.profiler``'s raw events.

The profile keeps, for each device operation (kernel, copy or set), its
name, start and duration, and for each host event its span. The raw
events (``kineto_results``) are read directly: the profiler's own event
tree takes tens of times as long to build.
"""

from __future__ import annotations

import re

CALL_SPAN = "bench.call"


def profile_calls(torch, call, n: int, on_card: bool = True) -> dict:
    """Run ``call`` ``n`` times under the profiler, each followed by a
    synchronise inside a ``bench.call`` range; return the raw stretch.
    ``on_card=False`` profiles the host alone (the CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
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
            host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
        elif (e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation() and not name.startswith("[")):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name))
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


def summarise(raw: dict, is_generated, demangle=lambda s: s) -> dict:
    """Busy time, the traced window, device time by kind, the busiest
    device operations and the idle gaps by what the host was doing."""
    calls = [(a, b, tid) for a, b, name, tid in raw["host"]
             if name == CALL_SPAN]
    if not calls:
        raise RuntimeError("the profile holds no bench.call range")
    w0 = min(a for a, _, _ in calls)
    w1 = max(b for _, b, _ in calls)
    main = calls[0][2]
    dev = sorted((max(a, w0), min(b, w1), name)
                 for a, b, name in raw["device"] if b > w0 and a < w1)
    busy, gaps, cur_a, cur_b = 0, [], None, w0
    for a, b, _ in dev:
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
    gen_ns = aux_ns = 0
    kernels = generated = 0
    by_name: dict = {}
    for a, b, name in dev:
        d = b - a
        if is_generated(name):
            gen_ns += d
            generated += 1
        else:
            aux_ns += d
        kernels += 1
        key = short_name(demangle(name))
        by_name[key] = by_name.get(key, 0) + d
    spans = sorted((a, b, name) for a, b, name, tid in raw["host"]
                   if tid == main)
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) // 2
        cover = [(sb - sa, name) for sa, sb, name in spans
                 if sa <= mid <= sb]
        what = min(cover)[1] if cover else "outside any host event"
        idle[what] = idle.get(what, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"calls": raw["calls"], "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9, "generated_s": gen_ns / 1e9,
            "aux_s": aux_ns / 1e9, "device_ops": kernels,
            "generated_ops": generated,
            "top": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gap_top],
            "raw": raw}
