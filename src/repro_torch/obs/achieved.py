"""Roofline-achieved instrumentation: measured performance over the model
(the port of ``repro.obs.achieved``).

The H100 plan model (:func:`repro_torch.analysis.stencil_roofline.
model_plan`) predicts seconds per time step for a plan's geometry.  This
module holds that prediction against a compiled executor's measured time:

    achieved_fraction = modeled_seconds / measured_seconds

(< 1: slower than the model; the model prices the card's data-sheet
rates, so a fraction near 1 means the run reached them).  The fraction
rides on tune records (``record["roofline_fraction"]``),
:class:`~repro_torch.obs.events.PlanChosen` events and ``chip_smoke.py``'s
stencil rows.

:func:`best_of` is the one timer of the port's measurements: on a CUDA
device, CUDA events around each call (the card's time for the call, the
host's gaps between its launches included); on the CPU, the host clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AchievedResult:
    """One measured-vs-modeled comparison for a compiled executor."""

    measured_s: float         # best-of-k seconds for one call
    modeled_s: float          # model_plan prediction for the same call
    steps: int                # time steps one call advances (1 = single)
    points: float             # grid points per step
    bytes_moved: float        # modeled device-memory bytes for the call
    achieved_fraction: float  # modeled_s / measured_s, in (0, inf)

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.measured_s if self.measured_s > 0 else 0.0

    @property
    def gbytes_per_sec(self) -> float:
        return (self.bytes_moved / self.measured_s / 1e9
                if self.measured_s > 0 else 0.0)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["steps_per_sec"] = self.steps_per_sec
        return d


def best_of(fn, device, warmup: int = 1, repeats: int = 3) -> float:
    """Seconds of the fastest of ``repeats`` calls of ``fn`` after
    ``warmup`` untimed ones (the first call of a new executable builds
    and loads its kernels).  ``device`` says which clock: CUDA events on
    a CUDA device, ``time.perf_counter`` on the CPU."""
    on_card = torch.device(device).type == "cuda"
    for _ in range(max(1, warmup)):
        fn()
    if on_card:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(1, repeats)):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def achieved_fraction(modeled_s: float, measured_s: float) -> float:
    """``modeled / measured``; degenerate timings give 0.0 rather than
    raising mid-measurement."""
    if measured_s <= 0 or modeled_s <= 0:
        return 0.0
    return modeled_s / measured_s


def model_call_seconds(ex) -> float:
    """The roofline prediction for ONE call of a compiled executor: the
    per-step :func:`~repro_torch.analysis.stencil_roofline.model_plan`
    price of its plan times the steps a call advances."""
    from ..analysis.stencil_roofline import model_plan
    steps = ex.time_spec.steps if ex.time_spec is not None else 1
    return model_plan(ex.program, ex.plan, ex.grid) * steps


def fraction_for(ex, measured_s: float) -> float:
    """``achieved_fraction`` for an executor somebody else already timed
    (one call took ``measured_s``; no second measurement)."""
    return achieved_fraction(model_call_seconds(ex), measured_s)


def measure_achieved(ex, fields, scalars=None, coeffs=None, *,
                     warmup: int = 1, repeats: int = 3,
                     timer=None, tracer=None) -> AchievedResult:
    """Measure ``ex`` (:func:`best_of` on its device) and compare with its
    roofline prediction.

    ``timer(fn) -> seconds`` is injectable like
    :class:`~repro_torch.core.tune.TuneConfig`'s; ``tracer`` (default:
    the ambient one) gets a ``roofline.achieved`` span carrying the
    result."""
    from ..analysis.stencil_roofline import plan_bytes_per_point
    from .trace import current_tracer
    tracer = tracer or current_tracer()
    fields = dict(fields)
    scalars = dict(scalars or {})
    coeffs = dict(coeffs or {})

    def call():
        return ex(fields, scalars, coeffs)

    if timer is None:
        def timer(fn):
            return best_of(fn, ex.device, warmup, repeats)

    with tracer.span("roofline.achieved", program=ex.program.name,
                     backend=ex.plan.backend,
                     schedule=ex.plan.schedule) as sp:
        measured = float(timer(call))
        steps = ex.time_spec.steps if ex.time_spec is not None else 1
        modeled = model_call_seconds(ex)
        points = float(np.prod([int(g) for g in ex.grid]))
        bpp = plan_bytes_per_point(ex.program, ex.plan, ex.grid)
        res = AchievedResult(
            measured_s=measured, modeled_s=modeled, steps=int(steps),
            points=points, bytes_moved=bpp * points * int(steps),
            achieved_fraction=achieved_fraction(modeled, measured))
        sp.set(measured_s=measured, modeled_s=modeled,
               steps=int(steps), roofline_fraction=res.achieved_fraction)
    return res
