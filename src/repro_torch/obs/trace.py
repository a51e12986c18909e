"""Structured event tracing — the observability substrate every layer
emits into.

A :class:`Tracer` records two record kinds:

* **spans** — nested, wall-clock-timed intervals opened with
  ``tracer.span("compile")`` (a context manager; attach attributes at open
  time or later via ``sp.set(...)``).  Nesting is per-thread: the compile
  pipeline, the tuner's candidate loop and the serving worker each build
  their own stack.  Each span record carries its ``id``, the ``parent`` id
  of the span open around it on its thread, and a ``call`` id: that of
  the nearest enclosing span opened with ``tracer.call(...)`` (one
  executable call), or of its outermost span.
* **events** — instant, typed occurrences: ``tracer.event("name", k=v)``
  or ``tracer.emit(PlanChosen(...))`` for the typed payloads in
  :mod:`repro_torch.obs.events`.

Timestamps are nanoseconds on the clock that ``torch.profiler`` stamps
its host events with: ``CLOCK_REALTIME`` (``c10::getTime``, which kineto's
approximate clock converts to; ``time.time_ns()`` here), and ``tid`` is
the thread's native id, as kineto's.  While torch's profiler is running,
every span also opens a ``record_function`` range of its name, so the
program's spans sit in the profiler's trace beside the device operations
they launched; an executable call with no tracer installed still marks
them there (:func:`call_tracer`).

Everything is **off by default and near-zero cost when off**: the ambient
tracer (:func:`current_tracer`) is a process-wide no-op singleton
(:data:`NULL`) unless a real tracer was installed — explicitly
(:func:`set_tracer` / ``Tracer.active()`` / ``CompileOptions(trace=...)``
/ ``StencilEngine(tracer=...)``) or via the ``REPRO_TRACE=path``
environment variable, which installs a process tracer whose records are
exported to ``path`` at interpreter exit (Chrome ``trace_event`` JSON, or
JSONL when the path ends in ``.jsonl``).  No emission point sits inside
jitted code — tracing never touches numerics, so disabling it is
bit-identical by construction.

Exports:

* :meth:`Tracer.export_jsonl` — one JSON record per line (machine grep).
* :meth:`Tracer.export_chrome` — Chrome ``trace_event`` format, loadable
  in ``chrome://tracing`` / Perfetto: spans are ``ph="X"`` complete events
  (``ts``/``dur`` in microseconds), instants are ``ph="i"``; with the
  ``baseTimeNanoseconds`` of a ``torch.profiler`` export it lays over that
  export with no offset.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time

from torch.autograd import profiler as _profiler

#: Environment variable: set to a path to trace the whole process and
#: export at exit (Chrome trace_event JSON; ``*.jsonl`` for JSONL).
TRACE_ENV = "REPRO_TRACE"


class _Span:
    """One open interval; closes (and records itself) on ``__exit__``."""

    __slots__ = ("_tracer", "name", "t0", "args", "depth", "id", "parent",
                 "call", "_new_call", "_mark")

    def __init__(self, tracer: "Tracer", name: str, args: dict,
                 new_call: bool = False):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._new_call = new_call
        self.t0 = 0
        self.depth = 0

    def set(self, **attrs) -> "_Span":
        """Attach attributes to the span (visible in both export formats)."""
        self.args.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Emit an instant event while this span is open."""
        self._tracer.event(name, **attrs)

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        top = stack[-1] if stack else None
        self.id = next(tracer._ids)
        self.parent = top.id if top is not None else None
        self.call = (self.id if top is None or self._new_call
                     else top.call)
        self.depth = len(stack)
        stack.append(self)
        self.t0 = time.time_ns()
        self._mark = _mark_enter(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        t1 = time.time_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record({
            "kind": "span", "name": self.name, "ts": self.t0,
            "dur": t1 - self.t0, "id": self.id, "parent": self.parent,
            "call": self.call, "depth": self.depth, "args": self.args,
        })
        return False


def _mark_enter(name: str):
    """A ``record_function`` range named ``name``, entered, while torch's
    profiler runs; None otherwise (the range costs ~10 us even with no
    profiler, so it is never opened without one)."""
    if not _profiler._is_profiler_enabled:
        return None
    mark = _profiler.record_function(name)
    mark.__enter__()
    return mark


class _MarkSpan:
    """A span that records nothing and only marks the profiler's trace."""

    __slots__ = ("name", "_mark")

    def __init__(self, name: str):
        self.name = name

    def set(self, **attrs) -> "_MarkSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass

    def __enter__(self) -> "_MarkSpan":
        self._mark = _mark_enter(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        return False


class _NullSpan:
    """Reusable no-op span: the entire disabled-tracing cost is one method
    call returning this shared object (no allocation, no clock reads)."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide span/event recorder.  Thread-safe: records append under
    a lock, span nesting uses a per-thread stack, and every record carries
    ``pid`` and the thread's native ``tid`` so exports separate tracks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list = []
        self._local = threading.local()
        self._ids = itertools.count(1)

    # -- recording -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return True

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, rec: dict) -> None:
        rec["pid"] = os.getpid()
        rec["tid"] = threading.get_native_id()
        with self._lock:
            self._records.append(rec)

    def span(self, name: str, **attrs) -> _Span:
        """Open a nested, timed span (use as a context manager)."""
        return _Span(self, name, attrs)

    def call(self, name: str, **attrs) -> _Span:
        """Open a span that starts a new call: its id is the ``call`` of
        every span opened inside it."""
        return _Span(self, name, attrs, new_call=True)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event at the current time/thread/depth."""
        self._record({"kind": "event", "name": name, "ts": time.time_ns(),
                      "depth": len(self._stack()), "args": attrs})

    def emit(self, ev) -> None:
        """Record a typed event (any dataclass from :mod:`repro_torch.obs.events`
        — the class name becomes the event name, fields the args)."""
        import dataclasses
        self.event(type(ev).__name__, **dataclasses.asdict(ev))

    # -- reading -------------------------------------------------------
    def records(self, kind: str | None = None, name: str | None = None
                ) -> list:
        """Snapshot of recorded spans/events (filtered copies)."""
        with self._lock:
            recs = list(self._records)
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        if name is not None:
            recs = [r for r in recs if r["name"] == name]
        return recs

    def spans(self, name: str | None = None) -> list:
        return self.records(kind="span", name=name)

    def events(self, name: str | None = None) -> list:
        return self.records(kind="event", name=name)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- ambient installation ------------------------------------------
    def active(self):
        """Context manager installing this tracer as the thread-ambient
        :func:`current_tracer` (restores the previous one on exit).  This
        is how the compile pipeline threads an explicit
        ``CompileOptions(trace=...)`` down through layers whose functions
        never see a tracer argument."""
        return _Active(self)

    # -- export --------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """One JSON record per line; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)

    def export_chrome(self, path: str, base_ns: int = 0) -> int:
        """Chrome ``trace_event`` JSON (``chrome://tracing`` / Perfetto).

        Spans become ``ph="X"`` complete events, instant events ``ph="i"``,
        with ``ts`` in microseconds after ``base_ns`` on the Unix clock
        (``dur`` in microseconds).  Given the ``baseTimeNanoseconds`` of a
        ``torch.profiler`` export, the two lay over with no offset: the
        same clock, base, ``pid`` and ``tid``.  Returns the event count
        written."""
        out = []
        for r in self.records():
            base = {"name": r["name"], "pid": r["pid"], "tid": r["tid"],
                    "ts": (r["ts"] - base_ns) / 1e3, "cat": r["kind"],
                    "args": r.get("args", {})}
            if r["kind"] == "span":
                base["ph"] = "X"
                base["dur"] = r["dur"] / 1e3
                base["args"] = dict(base["args"], id=r["id"],
                                    parent=r["parent"], call=r["call"])
            else:
                base["ph"] = "i"
                base["s"] = "t"
            out.append(base)
        doc = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": int(base_ns),
            "otherData": {"source": "repro_torch.obs"},
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return len(out)


class _Active:
    __slots__ = ("_tracer", "_prev")

    def __init__(self, tracer):
        self._tracer = tracer

    def __enter__(self):
        self._prev = getattr(_ambient, "tracer", None)
        _ambient.tracer = self._tracer
        return self._tracer

    def __exit__(self, *exc):
        _ambient.tracer = self._prev
        return False


class NullTracer(Tracer):
    """The disabled tracer: every method is a no-op (spans return one
    shared reusable object), so instrumented code pays a single dynamic
    dispatch per emission point and allocates nothing."""

    def __init__(self):  # no lock, no buffers
        pass

    @property
    def enabled(self) -> bool:
        return False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    call = span

    def event(self, name: str, **attrs) -> None:
        pass

    def emit(self, ev) -> None:
        pass

    def records(self, kind=None, name=None) -> list:
        return []

    def clear(self) -> None:
        pass

    def active(self):
        return _Active(self)

    def export_jsonl(self, path: str) -> int:
        raise RuntimeError("cannot export the no-op tracer; install a real "
                           "Tracer (set_tracer / CompileOptions(trace=...) "
                           f"/ {TRACE_ENV}=path)")

    export_chrome = export_jsonl


class _ProfilerMarks(NullTracer):
    """Records nothing; its spans only open ``record_function`` ranges
    (while the profiler runs, which is when :func:`call_tracer` hands it
    out)."""

    def span(self, name: str, **attrs) -> _MarkSpan:
        return _MarkSpan(name)

    call = span


#: The process-wide no-op singleton — what :func:`current_tracer` returns
#: when tracing is off.
NULL = NullTracer()
_MARKS = _ProfilerMarks()

_ambient = threading.local()
_global: Tracer | None = None
_env_checked = False
_lock = threading.Lock()


def set_tracer(tracer: Tracer | None) -> None:
    """Install (or, with ``None``, remove) the process-global tracer."""
    global _global
    _global = tracer


def _tracer_from_env() -> Tracer | None:
    """``REPRO_TRACE=path``: build a process tracer that exports to
    ``path`` at interpreter exit.  Checked once per process (call
    :func:`_reset_for_tests` to re-read)."""
    global _env_checked, _global
    with _lock:
        if _env_checked:
            return _global
        _env_checked = True
        path = os.environ.get(TRACE_ENV)
        if not path or _global is not None:
            return _global
        tracer = Tracer()
        _global = tracer

        def _export():
            try:
                if path.endswith(".jsonl"):
                    tracer.export_jsonl(path)
                else:
                    tracer.export_chrome(path)
            except OSError:  # pragma: no cover - exit-time best effort
                pass

        atexit.register(_export)
        return _global


def current_tracer() -> Tracer:
    """The ambient tracer: a thread-local override installed by
    ``Tracer.active()`` wins, else the process-global tracer
    (:func:`set_tracer` or ``REPRO_TRACE``), else :data:`NULL`."""
    t = getattr(_ambient, "tracer", None)
    if t is not None:
        return t
    g = _global if _env_checked else _tracer_from_env()
    return g if g is not None else NULL


def call_tracer() -> Tracer:
    """The tracer one executable call records into: :func:`current_tracer`,
    except that while torch's profiler runs and no tracer is installed,
    one whose spans only mark the profiler's trace.  Off, its whole cost
    is :func:`current_tracer` and one flag read."""
    t = current_tracer()
    if t is NULL and _profiler._is_profiler_enabled:
        return _MARKS
    return t


def resolve_tracer(trace) -> Tracer:
    """Normalise a user-facing ``trace=`` knob: ``None``/``False`` defer to
    :func:`current_tracer` (the ambient/no-op default), ``True`` installs
    and returns a fresh process tracer, a :class:`Tracer` is itself."""
    if trace is None or trace is False:
        return current_tracer()
    if trace is True:
        t = current_tracer()
        if t is NULL:
            t = Tracer()
            set_tracer(t)
        return t
    if isinstance(trace, Tracer):
        return trace
    raise TypeError(f"trace= must be a Tracer, True, or None; got "
                    f"{type(trace).__name__}")


def _reset_for_tests() -> None:
    """Drop global/env tracer state (tests re-reading ``REPRO_TRACE``)."""
    global _global, _env_checked
    with _lock:
        _global = None
        _env_checked = False
    _ambient.tracer = None
