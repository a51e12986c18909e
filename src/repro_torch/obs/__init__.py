"""repro_torch.obs — tracing and metrics, copied from the reference
package (pure Python): nested spans, typed events and a metrics registry
that the compile path emits into.  Off by default."""

from .events import (CacheHit, CacheMiss, ChainDemoted, ExecutorEvicted,
                     PlanChosen, PlaneDemoted)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      global_metrics)
from .trace import (NULL, TRACE_ENV, NullTracer, Tracer, current_tracer,
                    resolve_tracer, set_tracer)

__all__ = [
    "CacheHit", "CacheMiss", "ChainDemoted", "ExecutorEvicted",
    "PlanChosen", "PlaneDemoted",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "global_metrics",
    "NULL", "TRACE_ENV", "NullTracer", "Tracer", "current_tracer",
    "resolve_tracer", "set_tracer",
]
