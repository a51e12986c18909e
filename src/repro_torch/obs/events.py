"""Typed trace events — the vocabulary of decisions the stack narrates.

Each event is a small frozen dataclass; ``tracer.emit(ev)`` records it
under the class name with the fields as args, so exports (JSONL, Chrome
``trace_event``) carry machine-readable payloads and tests can assert on
specific decisions instead of log strings.

The set mirrors the silent decisions the optimiser used to bury in field
values:

* :class:`PlanChosen` — a compile or tune settled on a plan (with the
  modeled-vs-measured ``roofline_fraction`` when a measurement exists);
* :class:`ChainDemoted` / :class:`PlaneDemoted` — stream legalisation
  reduced a requested ``time_tile`` / ``plane_tile`` (the structured form
  of ``chain_split_reason`` / ``plane_split_reason``);
* :class:`CacheHit` / :class:`CacheMiss` — any reuse layer consulted
  (``cache`` names which: ``"tuned_plan"``, ``"serve_record"``,
  ``"executor"``);
* :class:`ExecutorEvicted` — the serving LRU dropped a compiled bucket.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PlanChosen:
    """A plan was settled on — by the heuristic, the tuner, or a cache.

    ``roofline_fraction`` is achieved/predicted performance
    (``modeled_s / measured_s``; > 1 means the run beat the model) and is
    ``None`` when nothing was measured (pure-heuristic compiles)."""

    program: str
    backend: str
    schedule: str
    strategy: str
    label: str = ""
    time_tile: int = 1
    plane_tile: int = 1
    modeled_us: float | None = None
    measured_us: float | None = None
    roofline_fraction: float | None = None


@dataclasses.dataclass(frozen=True)
class ChainDemoted:
    """Temporal blocking: the requested ``time_tile`` could not chain."""

    program: str
    requested: int
    effective: int
    reason: str


@dataclasses.dataclass(frozen=True)
class PlaneDemoted:
    """Spatial unrolling: the requested ``plane_tile`` could not widen."""

    program: str
    requested: int
    effective: int
    reason: str


@dataclasses.dataclass(frozen=True)
class CacheHit:
    cache: str            # which reuse layer: tuned_plan / serve_record / ...
    key: str


@dataclasses.dataclass(frozen=True)
class CacheMiss:
    cache: str
    key: str


@dataclasses.dataclass(frozen=True)
class ExecutorEvicted:
    """The serving engine's LRU cap dropped a compiled bucket executor."""

    key: str
    resident: int         # executors still resident after the eviction
