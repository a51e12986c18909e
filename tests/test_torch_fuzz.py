"""Random programs through the port, against the reference, on the CPU.

The reference fuzzes its compiler with ``tests/strategies.py::programs``
(``tests/test_backends_parity.py``): random expression trees over random
fields with offsets in [-2, 2], scalars, a coefficient, producer->consumer
chains.  Each drawn program is converted to the port's IR (the same
dataclasses in ``repro_torch.core.ir``) and compiled with
``device="cpu"`` under the block schedule (``auto`` and ``per_field``)
and, from two dimensions up, the stream schedule, each held against the reference's ``jnp_naive``
at the reference's 1e-3.  Programs whose groups read no field or
coefficient are drawn too (``o0 = s0``).  A fused ``steps=3`` loop under
``carry_write="inplace"`` must leave every input the caller gave
unchanged, and match the reference's fused loop.
"""

import dataclasses
import enum

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings

from repro.core import compile_program as ref_compile
from repro_torch import compile_program
from repro_torch.core import ir as port_ir

from strategies import make_data, programs

GRIDS = {1: (24,), 2: (10, 32), 3: (6, 8, 32)}
TOL = 1e-3


def to_port(x):
    """A reference IR object as the port's: each dataclass and enum by its
    name in ``repro_torch.core.ir``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(port_ir, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, enum.Enum):
        return getattr(port_ir, type(x).__name__)(x.value)
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def _plans(ndim: int) -> list:
    """Block ``auto`` and ``per_field``, and the stream schedule where the
    program has a plane to sweep (it needs ndim >= 2, as the reference's
    does)."""
    return [{}, {"strategy": "per_field"}] + (
        [{"schedule": "stream"}] if ndim >= 2 else [])


def _close(got, want, what):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=what)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(p=programs())
def test_random_programs_match_the_reference(p):
    grid = GRIDS[p.ndim]
    fields, scalars, coeffs = make_data(p, grid, seed=5)
    want = ref_compile(p, grid, backend="jnp_naive")(fields, scalars, coeffs)
    q = to_port(p)
    assert q.to_text() == p.to_text()
    for kw in _plans(p.ndim):
        got = compile_program(q, grid, device="cpu", **kw)(fields, scalars,
                                                           coeffs)
        assert set(got) == set(want), kw
        for k in want:
            _close(got[k], want[k], f"{kw} {k}\n{p.to_text()}")


@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(p=programs(ndim=3))
def test_random_fused_inplace_loop_leaves_inputs_unchanged(p):
    """Three steps with in0 <- 0.5 * (the last output) under
    ``carry_write="inplace"``, block and stream schedules: the caller's
    arrays keep their values, and the loop gives the reference's."""
    grid = GRIDS[3]
    fields, scalars, coeffs = make_data(p, grid, seed=6)
    kept = {f: a.copy() for f, a in fields.items()}
    last = p.ops[-1].out

    def update(fs, out):
        return {"in0": 0.5 * out[last]}

    want = ref_compile(p, grid, backend="jnp_fused", steps=3,
                       update=update)(kept, scalars, coeffs)
    q = to_port(p)
    for kw in ({}, {"schedule": "stream"}):
        got = compile_program(q, grid, device="cpu", steps=3, update=update,
                              carry_write="inplace", **kw)(fields, scalars,
                                                           coeffs)
        for f in fields:
            np.testing.assert_array_equal(fields[f], kept[f], err_msg=f)
        for k in want:
            w = np.asarray(want[k], np.float64)
            if np.isfinite(w).all():
                _close(got[k], w, f"{kw} {k}\n{p.to_text()}")


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_program_that_reads_nothing_matches_the_reference(ndim):
    """The shape the random programs draw least often: one op that reads
    only a scalar, so its group reads no field or coefficient."""
    from repro.core import ProgramBuilder

    b = ProgramBuilder("fuzz", ndim=ndim)
    b.input("in0")
    s0 = b.scalar("s0")
    b.define(b.output("o0"), s0)
    p = b.build()
    grid = GRIDS[ndim]
    fields, scalars, coeffs = make_data(p, grid, seed=7)
    want = ref_compile(p, grid, backend="jnp_naive")(fields, scalars, coeffs)
    for kw in _plans(ndim):
        got = compile_program(to_port(p), grid, device="cpu",
                              **kw)(fields, scalars, coeffs)
        _close(got["o0"], want["o0"], str(kw))
