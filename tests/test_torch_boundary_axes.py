"""A boundary per axis: MONC's doubly periodic domain (x and y wrap, z
bounded) through the port, on the CPU (and on a card, ``-m cuda``).

* A uniform per-axis spec is the plain kind: the same IR, fingerprint,
  generated CUDA source and results, and the JAX reference's results.
* ``("periodic", "periodic", "zero")`` under the block and stream
  schedules, fused loops, single steps and a (2,2) mesh of CPU devices,
  against ``bench/reference/advection_periodic_xy.py`` (plain torch, loaded
  by path), the full torus and the zero boundary.
* The rules, axis by axis: mixing, coefficients, the stream schedule's
  temp and chain rules; serving refuses a per-axis spec.
* The tracing: ``stencil.wrap`` spans around the pads that fill wraparound
  slabs and ``stencil.wrap_bytes`` counting their buffers; none of either
  on a zero-boundary program.

The generated kernels' per-axis masks run on host threads among the cases
of ``test_torch_kernel_emulated.py``.
"""

import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import boundary as bc
from repro_torch.core.dataflow import (chain_split_reason,
                                       legalize_stream_groups,
                                       stream_split_reason)
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.schedule import (auto_plan, plan_to_dict,
                                       program_fingerprint)
from repro_torch.obs import Tracer, global_metrics

XY = ("periodic", "periodic", "zero")
GRID = (32, 16, 24)
APPS = {"pw": (pw_advection, lambda: pw_advection_update(0.1)),
        "tracer": (tracer_advection, tracer_advection_update)}
REF = Path(__file__).resolve().parents[1] / "bench" / "reference"


def _reference():
    spec = importlib.util.spec_from_file_location(
        "advection_periodic_xy_under_test", REF / "advection_periodic_xy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(p, grid=GRID, seed=0, device="cpu"):
    """Seeded inputs in the apps' ranges (winds x 0.1, t + 15, e3t >= 1,
    msk in {0, 1}), small enough that fused loops stay bounded."""
    gen = torch.Generator().manual_seed(seed)
    fields = {f: torch.randn(grid, generator=gen) * 0.1
              for f in p.input_fields()}
    if "t" in fields:
        fields["t"] = fields["t"] * 10 + 15.0
    if "e3t" in fields:
        fields["e3t"] = fields["e3t"].abs() + 1.0
    if "msk" in fields:
        fields["msk"] = (fields["msk"] > 0).float()
    scalars = {s: 0.1 for s in p.scalars}
    coeffs = {c: torch.randn((grid[ax],), generator=gen)
              for c, ax in p.coeffs.items()}
    fields = {k: v.to(device) for k, v in fields.items()}
    coeffs = {k: v.to(device) for k, v in coeffs.items()}
    return fields, scalars, coeffs


def _compile(p, grid=GRID, steps=3, **kw):
    name = "pw" if p.name == "pw_advection" else "tracer"
    if steps:
        kw.update(steps=steps, update=APPS[name][1]())
    kw.setdefault("device", "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compile_program(p, grid, **kw)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# ------------------------------------------------ a uniform spec is its kind

@pytest.mark.parametrize("schedule", ["block", "stream"])
@pytest.mark.parametrize("kind", ["zero", "periodic"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_a_uniform_per_axis_spec_is_its_kind(app, kind, schedule):
    """The tuple and the JSON list of one kind build the string's IR, its
    fingerprint, its plan and its generated CUDA source, and give its
    results bit for bit."""
    make = APPS[app][0]
    ref = make(kind)
    for spec in ((kind,) * 3, [kind] * 3):
        p = make(spec)
        assert p.boundaries() == ref.boundaries()
        assert all(b == kind for b in p.boundaries().values())
        assert program_fingerprint(p) == program_fingerprint(ref)
        assert p.is_torus() == ref.is_torus()
    p = make([kind] * 3)
    a, b = _compile(ref, schedule=schedule), _compile(p, schedule=schedule)
    assert plan_to_dict(a.plan) == plan_to_dict(b.plan)
    assert a.kernels[0].module.source == b.kernels[0].module.source
    data = _data(ref)
    ra, rb = a(*data), b(*data)
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k


@pytest.mark.parametrize("kind", ["zero", "periodic"])
@pytest.mark.parametrize("name", ["pw_advection", "tracer_advection"])
def test_a_uniform_per_axis_spec_matches_the_jax_reference(name, kind):
    """As ``test_torch_parity.py`` holds the string spec: the kernel
    orchestrator's ``steps=4`` loop against the reference's Pallas loop,
    at its tolerance (1e-5)."""
    from test_torch_parity import assert_close, port_result, reference_result

    grid = (6, 8, 32)
    want = reference_result(name, kind, grid, "pallas", steps=4)
    got = port_result(name, (kind,) * 3, grid, "cuda", steps=4)
    assert_close(got, want, 1e-5, f"cuda steps=4 {name}/({kind},)*3")


# ---------------------------------------------- the doubly periodic domain

#: max |got - ref| / max |ref| a field may read against the float32 plain
#: reference: the port evaluates the same float32 operations, in another
#: association only where value numbering shares a subtree (tracer reads
#: ~1e-7 after 3 steps); a bfloat16 run of the reference reads ~1e-2
TOL = 1e-5


@pytest.mark.parametrize("schedule", ["block", "stream"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_doubly_periodic_loop_matches_the_plain_reference(app, schedule):
    p = APPS[app][0](XY)
    ex = _compile(p, schedule=schedule)
    f, s, c = _data(p)
    got = ex(f, s, c)
    ref = _reference()
    want = ref.run(app, f, s, c, 3)
    low = ref.run(app, f, s, c, 3, dtype=torch.bfloat16)
    for k in got:
        assert _rel(got[k], want[k]) <= TOL, k
    assert max(_rel(low[k], want[k]) for k in got) > 100 * TOL


@pytest.mark.parametrize("kw", [dict(schedule="block"),
                                dict(schedule="stream"),
                                dict(backend="torch_naive")],
                         ids=["block", "stream", "torch_naive"])
def test_one_step_is_the_torus_inside_and_zero_away_from_the_sides(kw):
    """pw reads one point along each axis: one step of the lateral wrap
    equals the full torus on z-planes 1..nz-2 (where nothing is read past
    the lid or the surface) and the zero boundary wherever nothing is read
    past a lateral side."""
    data = _data(pw_advection("zero"))
    xy = _compile(pw_advection(XY), steps=0, **kw)(*data)
    torus = _compile(pw_advection("periodic"), steps=0, **kw)(*data)
    zero = _compile(pw_advection("zero"), steps=0, **kw)(*data)
    for k in xy:
        assert torch.equal(xy[k][:, :, 1:-1], torus[k][:, :, 1:-1]), k
        assert torch.equal(xy[k][1:-1, 1:-1], zero[k][1:-1, 1:-1]), k
        assert not torch.equal(xy[k], torus[k])
        assert not torch.equal(xy[k], zero[k])


@pytest.mark.parametrize("schedule", ["block", "stream"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_the_mesh_equals_one_device(app, schedule):
    """A (2,2) mesh of four CPU devices over x and y: the exchange closes
    both lateral rings and leaves z to the local zero fill; bit for bit
    the one-device loop."""
    from repro_torch.dist import make_auto_mesh

    p = APPS[app][0](XY)
    mesh = make_auto_mesh((2, 2), ("x", "y"), devices=["cpu"] * 4)
    one = _compile(p, schedule=schedule)
    four = _compile(p, schedule=schedule, mesh=mesh,
                    mesh_axes=("x", "y", None), device=None)
    data = _data(p)
    a, b = one(*data), four(*data)
    for k in a:
        assert torch.equal(a[k], b[k].cpu()), k


def test_the_mesh_exchange_wraps_only_the_periodic_axes():
    from repro_torch.core import distribute

    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    blocks = {(0, 0, 0): x[:1], (1, 0, 0): x[1:]}
    out = distribute.halo_exchange_pad(blocks, (1, 1, 1), (1, 1, 1),
                                       (0, 0, 0), ("x", None, None),
                                       {"x": 2}, periodic=(True, True, False))
    for (i, _, _), y in out.items():
        assert torch.equal(y[1, 1:-1, 1:-1], x[i])
        assert torch.equal(y[0, 1:-1, 1:-1], x[1 - i])      # the x ring
        assert torch.equal(y[1, 0, 1:-1], x[i, -1])         # y wraps
        assert torch.equal(y[:, :, 0], torch.zeros(3, 5))   # z does not
        assert torch.equal(y[:, :, -1], torch.zeros(3, 5))


# -------------------------------------------------------- pads and shifts

def test_pad_and_shift_follow_each_axis():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    y = bc.pad_field(x, (1, 1, 1), (1, 1, 1), XY, align_hi=(0, 0, 2))
    assert y.shape == (4, 5, 8)
    assert torch.equal(y[1:-1, 1:-1, 1:5], x)
    assert torch.equal(y[0, 1:-1, 1:5], x[-1])
    assert torch.equal(y[1:-1, 0, 1:5], x[:, -1])
    assert torch.equal(y[:, :, 0], torch.zeros(4, 5))
    assert torch.equal(y[:, :, 5:], torch.zeros(4, 5, 3))
    assert torch.equal(y[0, 0, 1:5], x[-1, -1])             # a corner
    s = bc.shift_field(x, (1, -1, 1), XY)
    want = torch.zeros_like(x)
    want[..., :3] = torch.roll(x, (-1, 1), (0, 1))[..., 1:]
    assert torch.equal(s, want)
    with pytest.raises(ValueError, match="unknown boundary"):
        bc.pad_field(x, (1, 1, 1), (1, 1, 1), ("periodic", "wall", "zero"))


# ------------------------------------------------------------- the rules

def _program(out_b, in_b, coeff_axis=None, other=None):
    """``o = x`` (times a coefficient along ``coeff_axis``), and an input
    ``y`` of boundary ``other`` that no op reads."""
    b = ProgramBuilder("rule", ndim=3)
    x = b.input("x", boundary=in_b)
    if other is not None:
        b.input("y", boundary=other)
    o = b.output("o", boundary=out_b)
    e = x[0, 0, 0]
    if coeff_axis is not None:
        e = e * b.coeff("c", axis=coeff_axis)[0]
    b.define(o, e)
    return b.build()


def test_the_mixing_rule_is_per_axis():
    _program(XY, "periodic")
    _program("zero", XY)
    _program(XY, XY)
    with pytest.raises(ValueError, match="periodic on axis 1.*not periodic "
                                         "on axis 1"):
        _program(XY, ("periodic", "zero", "zero"))
    with pytest.raises(ValueError, match="not periodic on axis 2"):
        _program("periodic", XY)
    with pytest.raises(ValueError, match="unknown boundary"):
        _program(("periodic", "wall", "zero"), "zero")
    with pytest.raises(ValueError, match="2 per-axis boundaries"):
        _program(("periodic", "zero"), "zero")


def test_the_coefficient_rule_and_mode_are_per_axis():
    p = _program(XY, XY, coeff_axis=2)      # along z, where nothing wraps
    assert [bc.coeff_mode(p, a) for a in range(3)] == \
        ["periodic", "periodic", "zero"]
    assert bc.coeff_mode(p) == "zero"
    _program(XY, "periodic", coeff_axis=2)
    _program(XY, XY, coeff_axis=0)
    with pytest.raises(ValueError, match="coefficient 'c' along axis 0.*"
                                         "not every field is periodic on "
                                         "axis 0"):
        _program(XY, XY, coeff_axis=0, other=("zero", "periodic", "zero"))
    with pytest.raises(ValueError, match="'c' along axis 2"):
        _program("periodic", "periodic", coeff_axis=2, other=XY)


@pytest.mark.parametrize("temp_b,splits", [
    ("periodic", True), (("periodic", "zero", "zero"), True),
    (("zero", "periodic", "periodic"), False), ("zero", False)])
def test_the_stream_temp_rule_looks_at_the_stream_axis(temp_b, splits):
    """A temp read at stream offset -1 splits the region only where it
    wraps along the stream axis (axis 0)."""
    b = ProgramBuilder("t", ndim=3, boundary=temp_b)
    x = b.input("x")
    t = b.temp("t")
    o = b.output("o")
    b.define(t, x[0, 0, 0] * 2.0)
    b.define(o, t[-1, 0, 0] + t[0, 1, 0])
    p = b.build()
    why = stream_split_reason(p, {"t"}, 1)
    assert (why is not None) == splits
    if splits:
        assert "periodic" in why
        assert ("stream axis 0" in why) == (temp_b != "periodic")
    assert len(legalize_stream_groups(p, [[0, 1]])) == (2 if splits else 1)


@pytest.mark.parametrize("spec,chains", [
    (XY, False), ("periodic", False), (("zero", "periodic", "zero"), True),
    (("zero", "periodic", "periodic"), True)])
def test_the_chain_rule_looks_at_the_stream_axis(spec, chains):
    """A two-step chain demotes only where a persistent field wraps along
    the stream axis; a chain that wraps along a plane axis runs, and gives
    the unchained loop's fields bit for bit."""
    p = pw_advection(spec)
    plan = auto_plan(p, GRID, schedule="stream")
    why = chain_split_reason(p, [list(g) for g in plan.groups])
    assert (why is None) == chains
    if not chains:
        assert "is periodic" in why
        assert ("stream axis 0" in why) == (spec != "periodic")
    ex = _compile(p, schedule="stream", time_tile=2, steps=4)
    assert ex.plan.stream.time_tile == (2 if chains else 1)
    data = _data(p)
    want = _compile(p, schedule="block", steps=4)(*data)
    got = ex(*data)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL, k


def test_serving_refuses_a_per_axis_boundary():
    from repro_torch.serve.bucket import serving_program
    from repro_torch.serve.engine import StencilRequest

    with pytest.raises(ValueError, match="per-axis boundary"):
        serving_program(pw_advection(XY))
    serving_program(pw_advection("periodic"))
    from repro_torch.serve.engine import StencilEngine

    eng = StencilEngine(device="cpu")
    try:
        f, s, c = _data(pw_advection(), grid=(8, 8, 8))
        with pytest.raises(ValueError, match="per-axis boundary"):
            eng.describe(StencilRequest(program=pw_advection(), fields=f,
                                        scalars=s, coeffs=c, boundary=XY))
    finally:
        eng.close()


# ------------------------------------------------------------ the tracing

def _counter(name):
    return global_metrics().snapshot().get("stencil." + name, 0)


@pytest.mark.parametrize("schedule,steps", [("block", 3), ("stream", 3),
                                            ("block", 0)])
def test_the_lateral_wrap_opens_wrap_spans_and_counts_its_buffers(schedule,
                                                                  steps):
    """A fused loop wraps each carry once in its prologue and once a step
    in its write-back; a single step wraps each input in its pad.  Each
    ``stencil.wrap`` is the innermost span there, and
    ``stencil.wrap_bytes`` is the bytes of the buffers those pads made."""
    p = pw_advection(XY)
    ex = _compile(p, schedule=schedule, steps=steps)
    data = _data(p)
    tr = Tracer()
    before = _counter("wrap_bytes")
    with tr.active():
        ex(*data)
    wraps = tr.spans("stencil.wrap")
    parents = {r["id"]: r["name"] for r in tr.spans()}
    names = sorted(parents[r["parent"]] for r in wraps)
    if steps:
        assert names == (["stencil.prologue"] * 3
                         + ["stencil.write_back"] * 3 * steps)
        fpad = ex.time_spec.field_pad
        nbytes = [4 * int(np.prod([GRID[a] + int(fpad[f][a].sum())
                                   for a in range(3)]))
                  for f in ("u", "v", "w")]
        want = sum(nbytes) * (1 + steps)
    else:
        assert names == ["stencil.pad"] * 3
        call = ex.kernels[0]
        want = 3 * 4 * int(np.prod([call.expect[a] for a in range(3)]))
    assert not any(r["parent"] == w["id"] for r in tr.spans() for w in wraps)
    assert _counter("wrap_bytes") - before == want


@pytest.mark.parametrize("schedule", ["block", "stream"])
def test_a_zero_boundary_loop_opens_no_wrap_span(schedule):
    p = pw_advection("zero")
    ex = _compile(p, schedule=schedule)
    tr = Tracer()
    before = _counter("wrap_bytes")
    with tr.active():
        ex(*_data(p))
    assert tr.spans("stencil.write_back") and not tr.spans("stencil.wrap")
    assert _counter("wrap_bytes") == before


# --------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["block", "stream", "stream_t2",
                                    "mesh2x2"])
def test_doubly_periodic_on_the_card(layout):
    """The generated kernels on the card, at 256 x 128 x 64, 4 fused steps,
    against the plain reference on the card (1e-4: nvcc contracts into
    FMAs, which the host build does not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.dist import make_auto_mesh

    grid = (256, 128, 64)
    p = pw_advection(XY)
    kw = {"schedule": "stream" if layout.startswith("stream") else "block"}
    if layout == "stream_t2":
        kw["time_tile"] = 2
    if layout == "mesh2x2":
        kw.update(mesh=make_auto_mesh((2, 2), ("x", "y"),
                                      devices=["cuda:0"] * 4),
                  mesh_axes=("x", "y", None))
    ex = _compile(p, grid, steps=4, device=None, **kw)
    f, s, c = _data(p, grid, device="cuda")
    got = ex(f, s, c)
    want = _reference().run("pw", f, s, c, 4)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-4, k
