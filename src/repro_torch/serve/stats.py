"""Serving metrics — the serve-scoped view over a metrics registry (the
port of ``repro.serve.stats``).

``ServeStats`` keeps the attribute API the engine and tests have always
used (``stats.completed += 1``, ``stats.p99_ms()``, ``snapshot()``), but
every counter/gauge/latency sample now lives in a
:class:`repro_torch.obs.metrics.MetricsRegistry` (``stats.registry``), so the
serving numbers export through the same snapshot machinery as the
compile-side metrics and the tracer.

All mutation happens either on the worker thread or under the engine's
submit lock, so plain registry instruments suffice; ``snapshot()`` returns
a plain JSON-serialisable dict for logging/benchmark rows.
"""

from __future__ import annotations

from ..obs.metrics import MetricsRegistry

#: integer counters, in the order ``snapshot()`` reports them
_COUNTERS = (
    "submitted", "completed", "failed", "timeouts",
    # executor-table hits vs builds (a build may still reuse a stored plan)
    "exec_hits", "exec_misses",
    # PlanCache serve-record hits vs misses on executor build
    "plan_hits", "plan_misses",
    # LRU evictions from the executor table (``max_executors`` cap)
    "evictions",
    # kernel sources the engine's executor builds generated (each one
    # ``bind``, built by ``nvcc`` at its first launch on the card); the
    # reference counts JAX traces here.  A warm request adds none.
    "traces",
    "compiles",          # executor builds that ran compile_program
    "batches", "batched_requests",
    "padded_slots",      # replicated filler slots across all batches
)

_GAUGES = ("wall_s",)    # time spent inside batch execution

#: capped latency reservoir (steady-state quantiles, not all-time)
LATENCY_WINDOW = 4096


class ServeStats:
    """Engine counters as registry-backed attributes.

    ``ServeStats(registry=...)`` scopes the instruments into a shared
    registry (e.g. to merge several engines into one snapshot); the
    default is a private registry per stats object."""

    def __init__(self, registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", reg)
        for n in _COUNTERS:
            reg.counter(n)
        for n in _GAUGES:
            reg.gauge(n)
        reg.histogram("latency_ms", maxlen=LATENCY_WINDOW)

    # attribute API: reads return plain numbers, writes set the instrument
    # (so ``stats.completed += 1`` mutates the registry counter)
    def __getattr__(self, name: str):
        reg = self.__dict__["registry"]
        if name in _COUNTERS:
            return reg.counter(name).value
        if name in _GAUGES:
            return reg.gauge(name).value
        raise AttributeError(f"ServeStats has no metric {name!r}")

    def __setattr__(self, name: str, value) -> None:
        reg = self.__dict__["registry"]
        if name in _COUNTERS:
            reg.counter(name).set(value)
        elif name in _GAUGES:
            reg.gauge(name).set(value)
        else:
            object.__setattr__(self, name, value)

    # ------------------------------------------------------------------
    def record_latency(self, ms: float) -> None:
        self.registry.histogram("latency_ms").observe(float(ms))

    def reset_latencies(self) -> None:
        """Drop recorded latencies (e.g. after a warm-up phase, so the
        quantiles describe steady-state traffic, not compiles)."""
        self.registry.histogram("latency_ms").clear()

    # ------------------------------------------------------------------
    def cache_hit_rate(self) -> float:
        n = self.exec_hits + self.exec_misses
        return self.exec_hits / n if n else 0.0

    def occupancy(self) -> float:
        """Mean fraction of batch slots holding real requests."""
        slots = self.batched_requests + self.padded_slots
        return self.batched_requests / slots if slots else 0.0

    def throughput(self) -> float:
        """Completed requests per second of batch-execution wall time."""
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

    def latency_quantile(self, q: float) -> float:
        return self.registry.histogram("latency_ms").quantile(q)

    def p50_ms(self) -> float:
        return self.latency_quantile(0.50)

    def p99_ms(self) -> float:
        return self.latency_quantile(0.99)

    def snapshot(self) -> dict:
        d = {n: getattr(self, n) for n in _COUNTERS + _GAUGES}
        d.update(hit_rate=self.cache_hit_rate(), occupancy=self.occupancy(),
                 throughput=self.throughput(), p50_ms=self.p50_ms(),
                 p99_ms=self.p99_ms(),
                 latencies=len(self.registry.histogram("latency_ms")))
        return d
