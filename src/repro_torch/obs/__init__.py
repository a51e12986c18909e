"""repro_torch.obs — tracing and metrics, grown from the reference
package's: nested spans on the profiler's clock, typed events and a
metrics registry that the compile path and the stencil orchestrator
(``stencil.*`` spans and counters) emit into, off by default; and the achieved
roofline (:mod:`repro_torch.obs.achieved`): measured time as a fraction
of the H100 plan model's prediction."""

from .achieved import (AchievedResult, achieved_fraction, best_of,
                       fraction_for, measure_achieved, model_call_seconds)
from .events import (CacheHit, CacheMiss, ChainDemoted, ExecutorEvicted,
                     PlanChosen, PlaneDemoted)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      global_metrics)
from .trace import (NULL, TRACE_ENV, NullTracer, Tracer, call_tracer,
                    current_tracer, resolve_tracer, set_tracer)

__all__ = [
    "CacheHit", "CacheMiss", "ChainDemoted", "ExecutorEvicted",
    "PlanChosen", "PlaneDemoted",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "global_metrics",
    "NULL", "TRACE_ENV", "NullTracer", "Tracer", "call_tracer",
    "current_tracer",
    "resolve_tracer", "set_tracer",
    "AchievedResult", "achieved_fraction", "best_of", "fraction_for",
    "measure_achieved", "model_call_seconds",
]
