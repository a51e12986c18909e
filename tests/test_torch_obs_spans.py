"""The orchestrator's spans and counters (``repro_torch.obs``), on the CPU.

* A span's ``id``, ``parent`` and ``call`` nest as the spans were opened.
* Span times are on the clock of ``torch.profiler``'s host events: a
  span mirrored into the profiler's trace starts where the profiler's
  event of its name starts, and the Chrome exports lay over each other.
* With tracing off, no record is kept and ``record_function`` is never
  entered; results are bit-identical with tracing on and off.
* Each schedule opens the spans its call makes: one ``stencil.call`` and
  one ``stencil.prologue``, a ``stencil.step`` a step (or a chain of T),
  a ``stencil.kernel`` a generated kernel call, no ``stencil.update`` in a
  chained sweep.
* ``stencil.pad_bytes``, ``stencil.carry_bytes``, ``stencil.carry_writes``
  and ``stencil.carry_unchanged`` are what the plan's padded shapes give.
"""

import collections
import json
import math
import threading
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core.pipeline import batched_executable
from repro_torch.obs import NULL, Tracer, call_tracer, global_metrics

GRID = (16, 12, 8)
APPS = {"pw": (pw_advection, pw_advection_update(0.1)),
        "tracer": (tracer_advection, tracer_advection_update())}
# (app, compile knobs, steps a call, stencil.step spans a call)
CASES = {
    "block_fused": ("tracer", dict(schedule="block", steps=3), 3, 3),
    "stream_t1": ("tracer", dict(schedule="stream", steps=2), 2, 2),
    "stream_t2": ("pw", dict(schedule="stream", steps=5, time_tile=2), 5, 3),
    "single_step": ("pw", dict(schedule="block"), 1, 1),
}


def _data(p, grid=GRID, batch=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    fields = {f: torch.randn(lead + grid, generator=gen) * 0.1
              for f in p.input_fields()}
    if "msk" in fields:
        fields["msk"] = (fields["msk"] > 0).float()
    if "e3t" in fields:
        fields["e3t"] = fields["e3t"].abs() + 1.0
    scalars = {s: (0.1 if batch is None else torch.full((batch,), 0.1))
               for s in p.scalars}
    coeffs = {c: torch.randn(lead + (grid[ax],), generator=gen)
              for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


def _compile(case, **extra):
    name, kw, _, _ = CASES[case]
    app, upd = APPS[name]
    kw = dict(kw, **extra)
    if "steps" in kw:
        kw["update"] = upd
    return app(), compile_program(app(), GRID, device="cpu", **kw)


def _counters():
    return {k: v for k, v in global_metrics().snapshot().items()
            if k.startswith("stencil.")}


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


# ---------------------------------------------------------------- the Tracer

def test_span_ids_parents_and_calls_nest_as_opened():
    tr = Tracer()
    with tr.span("outer") as outer:
        with tr.call("c1") as c1:
            with tr.span("a") as a:
                with tr.span("a.b") as ab:
                    pass
            with tr.span("d") as d:
                pass
        with tr.call("c2") as c2:
            with tr.span("e") as e:
                pass
    with tr.span("root2") as root2:
        pass
    recs = {r["name"]: r for r in tr.spans()}
    assert len({r["id"] for r in recs.values()}) == len(recs)
    assert recs["outer"]["parent"] is None
    assert recs["outer"]["call"] == outer.id
    assert recs["c1"]["parent"] == outer.id and recs["c1"]["call"] == c1.id
    assert recs["a"]["parent"] == c1.id and recs["a"]["call"] == c1.id
    assert recs["a.b"]["parent"] == a.id and recs["a.b"]["call"] == c1.id
    assert recs["d"]["parent"] == c1.id and recs["d"]["call"] == c1.id
    assert recs["c2"]["call"] == c2.id and recs["e"]["call"] == c2.id
    assert recs["e"]["parent"] == c2.id
    assert recs["root2"]["parent"] is None
    assert recs["root2"]["call"] == root2.id
    assert [recs[n]["depth"] for n in ("outer", "c1", "a", "a.b")] == \
        [0, 1, 2, 3]
    assert ab.parent == a.id and d.id > ab.id and e.id > c2.id


def test_spans_nest_per_thread():
    tr = Tracer()
    seen = {}

    def other():
        with tr.span("worker") as sp:
            seen["worker"] = sp

    with tr.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    recs = {r["name"]: r for r in tr.spans()}
    assert recs["worker"]["parent"] is None
    assert recs["worker"]["tid"] == t.native_id
    assert recs["main"]["tid"] == threading.get_native_id()


def test_span_times_are_the_profilers_clock(tmp_path):
    """A mirrored span starts where the profiler's event of its name
    starts (kineto stamps host events on the Unix clock; a monotonic
    clock would differ by decades), and the two Chrome exports share
    their clock, base, pid and tid."""
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with tr.span("probe.span"):
            torch.ones(8).add_(1)
    (ours,) = tr.spans("probe.span")
    kin = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe.span"
           and e.device_type() == DeviceType.CPU]
    assert len(kin) == 1
    assert abs(kin[0].start_ns() - ours["ts"]) < 100_000
    assert abs(kin[0].end_ns() - (ours["ts"] + ours["dur"])) < 100_000

    prof.export_chrome_trace(str(tmp_path / "kineto.json"))
    doc = json.loads((tmp_path / "kineto.json").read_text())
    base = int(doc["baseTimeNanoseconds"])
    tr.export_chrome(str(tmp_path / "ours.json"), base_ns=base)
    mine = json.loads((tmp_path / "ours.json").read_text())
    (theirs,) = [e for e in doc["traceEvents"]
                 if e.get("name") == "probe.span"]
    (ev,) = [e for e in mine["traceEvents"] if e["name"] == "probe.span"]
    assert abs(ev["ts"] - float(theirs["ts"])) < 100.0      # microseconds
    assert (ev["pid"], ev["tid"]) == (theirs["pid"], theirs["tid"])
    assert mine["baseTimeNanoseconds"] == base


def test_event_times_are_the_unix_clock():
    tr = Tracer()
    t = time.time_ns()
    tr.event("tick", n=1)
    (ev,) = tr.events("tick")
    assert 0 <= ev["ts"] - t < 1e9 and ev["args"] == {"n": 1}


# ------------------------------------------------------- tracing on and off

@pytest.mark.parametrize("case", sorted(CASES))
def test_tracing_off_keeps_nothing_and_changes_nothing(case, monkeypatch):
    p, ex = _compile(case)
    data = _data(p)
    tr = Tracer()
    with tr.active():
        on = ex(*data)
    assert tr.spans("stencil.call")

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert call_tracer() is NULL
    off = ex(*data)
    assert NULL.records() == []
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k


def test_a_profiled_call_marks_its_spans_without_a_tracer():
    p, ex = _compile("block_fused")
    data = _data(p)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert call_tracer() is not NULL
        assert not call_tracer().enabled
        ex(*data)
    names = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("stencil."))
    assert names == {"stencil.call": 1, "stencil.prologue": 1,
                     "stencil.step": 3, "stencil.kernel": 3,
                     "stencil.update": 3, "stencil.write_back": 3}
    assert call_tracer() is NULL


# ----------------------------------------------------------- spans a call

@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counts_match_the_schedule(case):
    p, ex = _compile(case)
    _, kw, steps, passes = CASES[case]
    chained = kw.get("time_tile", 1) > 1
    tr = Tracer()
    with tr.active():
        ex(*_data(p))
    count = collections.Counter(r["name"] for r in tr.spans())
    kernels = len(ex.kernels) if not chained else 1
    assert count["stencil.call"] == 1
    assert count["stencil.prologue"] == 1
    assert count["stencil.step"] == passes
    assert count["stencil.kernel"] == (passes * kernels if not chained
                                       else passes)
    fused = "steps" in kw
    assert count["stencil.update"] == (0 if chained or not fused
                                       else passes)
    assert count["stencil.write_back"] == (passes if fused else 0)
    (call,) = tr.spans("stencil.call")
    assert call["args"] == {"program": p.name,
                            "schedule": kw["schedule"],
                            "steps": steps, "batch": 1}
    for r in tr.spans():
        assert r["call"] == call["id"]
        if r["name"] == "stencil.kernel":
            assert r["args"]["entry"] in {k.entry for k in ex.kernels}
    steps_ = {r["id"] for r in tr.spans("stencil.step")}
    for r in tr.spans("stencil.kernel") + tr.spans("stencil.pad"):
        assert r["parent"] in steps_
    assert tr.spans("stencil.prologue")[0]["parent"] == call["id"]


def test_a_served_batch_opens_the_same_spans():
    p, ex = _compile("block_fused")
    run = batched_executable(ex)
    tr = Tracer()
    with tr.active():
        run(*_data(p, batch=2))
    (call,) = tr.spans("stencil.call")
    assert call["args"]["batch"] == 2
    assert len(tr.spans("stencil.step")) == 3


# ------------------------------------------------------------- counters

def _padded(grid, pad) -> int:
    return math.prod(int(g) + int(pad[a, 0]) + int(pad[a, 1])
                     for a, g in enumerate(grid))


def _coeff_pad_bytes(calls, item=4) -> int:
    n = 0
    for call in calls:
        for c in call.group_coeffs:
            ax = call.coeff_axis[c]
            lo, hi = int(call.pad_lo[ax]), int(call.pad_hi[ax])
            if lo or hi:
                n += (GRID[ax] + lo + hi) * item
    return n


def _temp_pad_bytes(calls, persistent, item=4) -> int:
    n = 0
    for call in calls:
        for f in call.group_inputs:
            if f in persistent:
                continue
            ext = [GRID[a] + int(call.halo_lo[a]) + int(call.halo_hi[a])
                   + int(call.align_hi[a]) for a in range(3)]
            if ext != list(GRID):
                n += math.prod(ext) * item
    return n


@pytest.mark.parametrize("carry_write", ["repad", "inplace"])
@pytest.mark.parametrize("case", ["block_fused", "stream_t1", "stream_t2"])
def test_counters_are_the_plans_padded_shapes(case, carry_write):
    p, ex = _compile(case, carry_write=carry_write)
    _, kw, steps, passes = CASES[case]
    spec = ex.time_spec
    persistent = list(spec.persistent)
    carry = {f: _padded(GRID, spec.field_pad[f]) * 4 for f in persistent}
    chained = kw.get("time_tile", 1) > 1
    before = _counters()
    ex(*_data(p))
    got = _delta(before, _counters())

    changed = {"pw": {"u", "v", "w"}, "tracer": {"t"}}[CASES[case][0]]
    if carry_write == "repad":
        per_pass = sum(carry.values())
    else:           # zero boundary: the changed interiors, copied in place
        per_pass = len(changed) * math.prod(GRID) * 4
    prologue = sum(carry.values()) + _coeff_pad_bytes(ex.kernels)
    temps = 0 if chained else passes * _temp_pad_bytes(ex.kernels,
                                                       persistent)
    assert got["stencil.calls"] == 1
    assert got["stencil.steps"] == steps
    assert got["stencil.carry_bytes"] == passes * per_pass
    assert got["stencil.pad_bytes"] == prologue + temps
    assert got["stencil.carry_writes"] == passes * len(persistent)
    assert got["stencil.carry_unchanged"] == \
        passes * (len(persistent) - len(changed))


def test_tracer_writes_six_fields_a_step_and_five_are_unchanged():
    p, ex = _compile("block_fused")
    before = _counters()
    ex(*_data(p))
    got = _delta(before, _counters())
    assert got["stencil.carry_writes"] == 6 * 3
    assert got["stencil.carry_unchanged"] == 5 * 3


def test_single_step_pads_its_inputs_and_coefficients():
    p, ex = _compile("single_step")
    before = _counters()
    ex(*_data(p))
    got = _delta(before, _counters())
    assert got["stencil.calls"] == 1 and got["stencil.steps"] == 1
    assert got["stencil.carry_writes"] == 0
    assert got["stencil.pad_bytes"] == (_temp_pad_bytes(ex.kernels, ())
                                        + _coeff_pad_bytes(ex.kernels))
