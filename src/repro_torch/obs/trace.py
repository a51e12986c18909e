"""Structured event tracing — the observability substrate every layer
emits into.

A :class:`Tracer` records two record kinds:

* **spans** — nested, wall-clock-timed intervals opened with
  ``tracer.span("compile")`` (a context manager; attach attributes at open
  time or later via ``sp.set(...)``).  Nesting is per-thread: the compile
  pipeline, the tuner's candidate loop and the serving worker each build
  their own stack.
* **events** — instant, typed occurrences: ``tracer.event("name", k=v)``
  or ``tracer.emit(PlanChosen(...))`` for the typed payloads in
  :mod:`repro_torch.obs.events`.

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
  (``ts``/``dur`` in microseconds), instants are ``ph="i"``.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time

#: Environment variable: set to a path to trace the whole process and
#: export at exit (Chrome trace_event JSON; ``*.jsonl`` for JSONL).
TRACE_ENV = "REPRO_TRACE"


class _Span:
    """One open interval; closes (and records itself) on ``__exit__``."""

    __slots__ = ("_tracer", "name", "t0", "args", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.depth = 0

    def set(self, **attrs) -> "_Span":
        """Attach attributes to the span (visible in both export formats)."""
        self.args.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        """Emit an instant event while this span is open."""
        self._tracer.event(name, **attrs)

    def __enter__(self) -> "_Span":
        self.t0 = self._tracer._clock()
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer._clock()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record({
            "kind": "span", "name": self.name, "ts": self.t0,
            "dur": max(0.0, t1 - self.t0), "depth": self.depth,
            "args": self.args,
        })
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
    ``pid`` plus a small per-thread ``tid`` so exports separate tracks."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._records: list = []
        self._local = threading.local()
        self._tids: dict = {}
        self.epoch = clock()
        self.epoch_unix = time.time()

    # -- recording -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return True

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    def _record(self, rec: dict) -> None:
        rec["ts"] = rec["ts"] - self.epoch
        rec["pid"] = os.getpid()
        rec["tid"] = self._tid()
        with self._lock:
            self._records.append(rec)

    def span(self, name: str, **attrs) -> _Span:
        """Open a nested, timed span (use as a context manager)."""
        return _Span(self, name, dict(attrs))

    def event(self, name: str, **attrs) -> None:
        """Record an instant event at the current time/thread/depth."""
        self._record({"kind": "event", "name": name, "ts": self._clock(),
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

    def export_chrome(self, path: str) -> int:
        """Chrome ``trace_event`` JSON (``chrome://tracing`` / Perfetto).

        Spans become ``ph="X"`` complete events with microsecond
        ``ts``/``dur``; instant events become ``ph="i"``.  Returns the
        event count written."""
        out = []
        for r in self.records():
            base = {"name": r["name"], "pid": r["pid"], "tid": r["tid"],
                    "ts": r["ts"] * 1e6, "cat": r["kind"],
                    "args": r.get("args", {})}
            if r["kind"] == "span":
                base["ph"] = "X"
                base["dur"] = r["dur"] * 1e6
            else:
                base["ph"] = "i"
                base["s"] = "t"
            out.append(base)
        doc = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro_torch.obs",
                          "epoch_unix": self.epoch_unix},
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
        self.epoch = 0.0
        self.epoch_unix = 0.0

    @property
    def enabled(self) -> bool:
        return False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

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


#: The process-wide no-op singleton — what :func:`current_tracer` returns
#: when tracing is off.
NULL = NullTracer()

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
