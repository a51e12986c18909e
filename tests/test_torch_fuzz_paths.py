"""Random programs through the port's other paths, against the reference,
on the CPU.

``tests/test_torch_fuzz.py`` compiles the reference's random programs
(``strategies.programs``) on one device under the default knobs.  This
file draws the same programs, three-dimensional, under the zero and the
periodic boundary (``boundary=`` of both packages' ``compile_program``),
and sends them where that file does not:

* the stream schedule with ``plane_tile=2`` (a single step and a fused
  loop) and with ``time_tile=2`` (a 3-step fused loop: one chain and a
  remainder, or the demoted T = 1 where the chain is not legal);
* meshes of CPU devices, (2,) and (2, 2), that cut the stream axis, a
  single step and a 3-step fused loop;
* ``StencilEngine(device="cpu")``, a single request and a fused request.

Each is held against the reference's ``jnp_naive`` (single steps) or
``jnp_fused`` (loops) at the existing fuzz's 1e-3, with torch flushing
float32 subnormals to zero as the reference's XLA CPU backend does (a
loop whose values underflow otherwise branches apart at a ``select`` on
``> 0``; ROADMAP.md, section C, "Not faults").  Besides the draws,
the mesh test always runs the draw that found a ring fed by a
coefficient alone reading zeros on a shard's first planes, and the
engine test ``o0 = s0``, whose only group reads nothing
(``tests/test_torch_repairs_c5_c6.py``), and the draw whose loop
underflows.  Axis 0 holds 16 planes, so a
(2,)-mesh shard keeps 8; a draw whose halo is deeper than a shard is
refused by the port as the reference refuses it (``exceeds the local
extent``), and that mesh is then not run for it.
"""

import warnings

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from repro.core import ProgramBuilder as RefBuilder
from repro.core import compile_program as ref_compile
from repro.core.ir import (Access, BinOp, BinOpKind, Cmp, CmpKind, Const,
                           Select, UnOp, UnOpKind)
from repro_torch import compile_program
from repro_torch.dist import make_auto_mesh
from repro_torch.serve import StencilEngine, StencilRequest

from strategies import make_data, programs
from test_torch_fuzz import _close, to_port
from test_torch_repairs_c5_c6 import coeff_ring, scalar_only, seed5_draw

GRID = (16, 8, 32)
STEPS = 3
BOUNDARIES = st.sampled_from(["zero", "periodic"])
FUZZ = settings(max_examples=20, deadline=None,
                suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(autouse=True, scope="module")
def flush_subnormals():
    """torch flushes float32 subnormals to zero here, as XLA's CPU backend
    does for the reference."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def subnormal_select():
    """o0 = in0 * in0; o1 = select(in0 > 0, square(o0), in0[0,0,1]): in a
    loop of 3 with in0 <- 0.5 o1, o1 underflows after two steps."""
    b = RefBuilder("fuzz", ndim=3)
    b.input("in0")
    o0, o1 = b.output("o0"), b.output("o1")
    x = Access("in0", (0, 0, 0))
    b.define(o0, BinOp(BinOpKind.MUL, x, x))
    b.define(o1, Select(Cmp(CmpKind.GT, x, Const(0.0)),
                        UnOp(UnOpKind.SQUARE, Access("o0", (0, 0, 0))),
                        Access("in0", (0, 0, 1))))
    return b.build()


def _update(p):
    """in0 <- 0.5 * (the program's last output), every step."""
    last = p.ops[-1].out

    def update(fs, out):
        return {"in0": 0.5 * out[last]}
    return update


def _want(p, boundary, data, steps=None):
    kw = ({"backend": "jnp_naive"} if steps is None else
          {"backend": "jnp_fused", "steps": steps, "update": _update(p)})
    return ref_compile(p, GRID, boundary=boundary, **kw)(*data)


def _check(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k], np.float64)
        if np.isfinite(w).all():
            _close(got[k], w, f"{what} {k}")


def _run(q, boundary, data, steps=None, **kw):
    """The port's compile of ``q`` on GRID (a fused loop with ``steps``)
    run on ``data``; a demoted tile's warning is expected."""
    if steps is not None:
        kw.update(steps=steps, update=_update(q))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compile_program(q, GRID, boundary=boundary, **kw)(*data)


@FUZZ
@given(p=programs(ndim=3), boundary=BOUNDARIES)
def test_random_programs_under_time_and_plane_tiles(p, boundary):
    data = make_data(p, GRID, seed=11)
    one, loop = _want(p, boundary, data), _want(p, boundary, data, STEPS)
    q = to_port(p)
    text = f"{boundary}\n{p.to_text()}"
    _check(_run(q, boundary, data, schedule="stream", plane_tile=2,
                device="cpu"), one, f"plane_tile=2 {text}")
    for kw in ({"plane_tile": 2}, {"time_tile": 2}):
        _check(_run(q, boundary, data, STEPS, schedule="stream",
                    device="cpu", **kw), loop, f"{kw} x{STEPS} {text}")


MESHES = [((2,), ("X",), ("X", None, None)),
          ((2, 2), ("X", "Y"), ("X", "Y", None))]


@FUZZ
@given(p=programs(ndim=3), boundary=BOUNDARIES)
@example(p=seed5_draw(), boundary="zero")
@example(p=coeff_ring(axis=1), boundary="periodic")
def test_random_programs_over_a_sharded_stream_axis(p, boundary):
    data = make_data(p, GRID, seed=12)
    one, loop = _want(p, boundary, data), _want(p, boundary, data, STEPS)
    q = to_port(p)
    text = f"{boundary}\n{p.to_text()}"
    for shape, names, axes in MESHES:
        mesh = make_auto_mesh(shape, names,
                              devices=["cpu"] * int(np.prod(shape)))
        kw = dict(schedule="stream", mesh=mesh, mesh_axes=axes)
        try:
            got = _run(q, boundary, data, **kw)
        except ValueError as e:
            if "exceeds the local" not in str(e):
                raise
            continue            # the reference's own single-hop refusal
        _check(got, one, f"mesh {shape} {text}")
        _check(_run(q, boundary, data, STEPS, **kw), loop,
               f"mesh {shape} x{STEPS} {text}")


@FUZZ
@given(p=programs(ndim=3), boundary=BOUNDARIES,
       schedule=st.sampled_from(["block", "stream"]))
@example(p=scalar_only(RefBuilder), boundary="zero", schedule="block")
@example(p=scalar_only(RefBuilder), boundary="periodic", schedule="stream")
@example(p=subnormal_select(), boundary="zero", schedule="block")
def test_random_programs_through_the_engine(p, boundary, schedule):
    data = make_data(p, GRID, seed=13)
    one, loop = _want(p, boundary, data), _want(p, boundary, data, STEPS)
    q = to_port(p)
    fields, scalars, coeffs = data
    text = f"{schedule} {boundary}\n{p.to_text()}"
    kw = {} if schedule == "block" else {"schedule": schedule}
    with StencilEngine(device="cpu", **kw) as eng:
        single, fused = eng.map([
            StencilRequest(program=q, fields=fields, scalars=scalars,
                           coeffs=coeffs, boundary=boundary),
            StencilRequest(program=q, fields=fields, scalars=scalars,
                           coeffs=coeffs, boundary=boundary, steps=STEPS,
                           update=_update(q), update_key="half_last")])
    _check(single.outputs, one, f"engine {text}")
    _check(fused.outputs, loop, f"engine x{STEPS} {text}")


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_a_refused_draw_is_the_references_refusal(boundary):
    """A halo deeper than a (2, 2)-mesh shard's axis 1 is refused with the
    reference's words, not run."""
    b = RefBuilder("deep", ndim=3)
    (x,) = b.inputs("in0")
    b.define(b.output("o0"), x[0, 6, 0] + x[0, -6, 0])
    p = to_port(b.build())
    mesh = make_auto_mesh((2, 2), ("X", "Y"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="exceeds the local extent"):
        compile_program(p, GRID, schedule="stream", mesh=mesh,
                        mesh_axes=("X", "Y", None), boundary=boundary)
