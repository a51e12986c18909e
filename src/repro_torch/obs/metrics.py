"""Metrics registry — counters, gauges and histograms with a JSON-ready
``snapshot()``.

One :class:`MetricsRegistry` is a namespace of named instruments.
:class:`~repro.serve.stats.ServeStats` (reference package) is the serve-scoped view over one
(its public attribute API is unchanged); compile-side code increments the
process-global registry (:func:`global_metrics`): compiles, lowerings,
tune runs, timed measurements, and plan-cache hit/miss counts (mirrored
from each :class:`~repro.core.tune.PlanCache`'s own registry so one
snapshot shows process-wide rates).

Everything is plain-int/float mutation — the engine's single-writer
threading model and the compile path's GIL-held bookkeeping need no
atomics — and ``snapshot()`` returns only JSON-serialisable scalars, so a
snapshot round-trips through ``json.dumps``/``loads`` unchanged.
"""

from __future__ import annotations

import collections


class Counter:
    """Monotonic-by-convention integer (``inc``), settable for views that
    mirror externally-tracked values."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += int(n)
        return self.value

    def set(self, v: int) -> None:
        self.value = int(v)

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """A float that goes up and down (wall-clock accumulators, ratios)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> float:
        self.value += float(v)
        return self.value

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Bounded sample reservoir with exact quantiles over the retained
    window (a ``deque(maxlen=...)`` — steady-state tails, not all-time)."""

    __slots__ = ("name", "samples", "total")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self.samples: collections.deque = collections.deque(maxlen=maxlen)
        self.total = 0            # observations ever (beyond the window)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))
        self.total += 1

    def __len__(self) -> int:
        return len(self.samples)

    def clear(self) -> None:
        """Drop the retained window (``total`` keeps counting ever-seen)."""
        self.samples.clear()

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def snapshot(self) -> dict:
        return {"count": len(self.samples), "total": self.total,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Named instruments, get-or-create by kind.  Re-requesting a name with
    a different kind is a bug and raises rather than silently aliasing."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, kind, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, **kw)
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, maxlen: int = 4096) -> Histogram:
        return self._get(name, Histogram, maxlen=maxlen)

    def names(self) -> list:
        return sorted(self._metrics)

    def reset(self) -> None:
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                m.samples.clear()
                m.total = 0
            else:
                m.reset()

    def snapshot(self) -> dict:
        """Flat JSON-serialisable view: counters/gauges map to their value,
        histograms to ``{count, total, p50, p99}``."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out


_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    """The process-wide registry compile-side counters accumulate into."""
    return _GLOBAL
