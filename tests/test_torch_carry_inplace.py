"""The fused loop's default carry write-back, ``"inplace"``, on the CPU.

* ``compile_program`` with no ``carry_write`` (and no tuned style) resolves
  to ``"inplace"``; an explicit ``"repad"`` stays ``"repad"``.
* The default gives ``"repad"``'s fields bit for bit: pw and tracer under
  the block schedule and the stream schedule at T = 1 and T = 2, one
  request, a batch of three, and a (2,) mesh of CPU devices.
* An update whose new values alias carries (u and v swapped, a field's own
  carry view returned as a new view) gives ``"repad"``'s result, written
  into the buffers the loop already holds.
* ``stencil.carry_bytes`` is the changed interiors a pass and
  ``stencil.carry_inplace`` the persistent fields a pass under the default;
  ``stencil.carry_inplace`` is 0 under ``"repad"`` and for a periodic
  field, whose halo slabs are rebuilt each step.
* A loop over a mesh never writes into the caller's inputs, even for a
  field whose carry has no halo slab to pad.
"""

import math

import pytest
import torch

from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import ProgramBuilder, plan_time_loop
from repro_torch.core.pipeline import batched_executable
from repro_torch.core.schedule import TimeLoopSpec
from repro_torch.dist import make_auto_mesh
from repro_torch.obs import global_metrics

GRID = (16, 12, 8)
APPS = {"pw": (pw_advection, lambda: pw_advection_update(0.1)),
        "tracer": (tracer_advection, tracer_advection_update)}
CHANGED = {"pw": {"u", "v", "w"}, "tracer": {"t"}}
# schedule knobs, steps a call, passes over the kernels a call
SCHEDULES = {"block": (dict(schedule="block"), 3, 3),
             "stream_t1": (dict(schedule="stream"), 3, 3),
             "stream_t2": (dict(schedule="stream", time_tile=2), 5, 3)}
CASES = [(a, s) for a in APPS for s in SCHEDULES]
IDS = [f"{a}-{s}" for a, s in CASES]


def _data(p, batch=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lead = () if batch is None else (batch,)
    fields = {f: torch.randn(lead + GRID, generator=gen) * 0.1
              for f in p.input_fields()}
    if "msk" in fields:
        fields["msk"] = (fields["msk"] > 0).float()
    if "e3t" in fields:
        fields["e3t"] = fields["e3t"].abs() + 1.0
    scalars = {s: (0.1 if batch is None else torch.full((batch,), 0.1))
               for s in p.scalars}
    coeffs = {c: torch.randn(lead + (GRID[ax],), generator=gen)
              for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


def _compile(app, sched, update=None, **kw):
    make, upd = APPS[app]
    knobs, steps, _ = SCHEDULES[sched]
    return make(), compile_program(make(), GRID, device="cpu", steps=steps,
                                   update=update or upd(), **knobs, **kw)


def _counters():
    return {k: v for k, v in global_metrics().snapshot().items()
            if k.startswith("stencil.")}


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kw", [dict(schedule="block"),
                                dict(schedule="stream"),
                                dict(schedule="stream", time_tile=2),
                                dict(backend="torch_fused")],
                         ids=["block", "stream_t1", "stream_t2",
                              "torch_fused"])
def test_compile_program_resolves_the_default_to_inplace(kw):
    make, upd = APPS["pw"]
    ex = compile_program(make(), GRID, device="cpu", steps=4, update=upd(),
                         **kw)
    assert ex.time_spec.carry_write == "inplace"
    ex = compile_program(make(), GRID, device="cpu", steps=4, update=upd(),
                         carry_write="repad", **kw)
    assert ex.time_spec.carry_write == "repad"


def test_the_loop_specs_default_is_the_compilers():
    p = pw_advection()
    ex = compile_program(p, GRID, device="cpu", steps=2,
                         update=pw_advection_update(0.1))
    assert plan_time_loop(p, ex.plan, GRID, 2).carry_write == "inplace"
    assert TimeLoopSpec(steps=1, persistent=[], field_pad={},
                        double_buffer={},
                        group_offsets=[]).carry_write == "inplace"


@pytest.mark.parametrize("app,sched", CASES, ids=IDS)
def test_the_default_gives_repads_fields_bit_for_bit(app, sched):
    p, ex = _compile(app, sched)
    _, rep = _compile(app, sched, carry_write="repad")
    assert ex.time_spec.carry_write == "inplace"
    _assert_bit_equal(ex(*_data(p)), rep(*_data(p)))


@pytest.mark.parametrize("app,sched", CASES, ids=IDS)
def test_a_batch_of_three_under_the_default_gives_repads_fields(app, sched):
    p, ex = _compile(app, sched)
    _, rep = _compile(app, sched, carry_write="repad")
    got = batched_executable(ex)(*_data(p, batch=3))
    want = batched_executable(rep)(*_data(p, batch=3))
    assert next(iter(got.values())).shape == (3,) + GRID
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("app,sched", CASES, ids=IDS)
def test_a_cpu_mesh_under_the_default_gives_repads_fields(app, sched):
    def on_mesh(**kw):
        mesh = make_auto_mesh((2,), ("X",), devices=["cpu"] * 2)
        return _compile(app, sched, mesh=mesh, mesh_axes=("X", None, None),
                        **kw)

    p, ex = on_mesh()
    _, rep = on_mesh(carry_write="repad")
    assert ex.time_spec.shard is not None
    assert ex.time_spec.carry_write == "inplace"
    _assert_bit_equal(ex(*_data(p)), rep(*_data(p)))


def _swap_u_v(fields, out):
    return {"u": fields["v"], "v": fields["u"],
            "w": fields["w"] + 0.1 * out["sw"]}


def _own_views(fields, out):
    # new view objects of each field's own carry, one of them changed
    return {"u": fields["u"][...], "v": fields["v"].view_as(fields["v"]),
            "w": fields["w"] + 0.1 * out["sw"]}


@pytest.mark.parametrize("update", [_swap_u_v, _own_views],
                         ids=["swap_u_v", "own_carry_views"])
@pytest.mark.parametrize("sched", ["block", "stream_t1"])
def test_updates_returning_carry_views_match_repad_in_place(update, sched):
    p, ex = _compile("pw", sched, update=update)
    _, rep = _compile("pw", sched, update=update, carry_write="repad")
    fields = _data(p)
    before = _counters()
    got = ex(*fields)
    counted = _delta(before, _counters())
    _assert_bit_equal(got, rep(*_data(p)))
    passes = SCHEDULES[sched][2]
    assert counted["stencil.carry_inplace"] == passes * 3
    assert counted["stencil.carry_unchanged"] == 0
    # the swap's values still held the other field's old interior: u after
    # an odd number of passes is the caller's v
    if update is _swap_u_v:
        assert torch.equal(got["u"], fields[0]["v"])
        assert torch.equal(got["v"], fields[0]["u"])


@pytest.mark.parametrize("carry_write", [None, "repad"],
                         ids=["default", "repad"])
@pytest.mark.parametrize("app,sched", CASES, ids=IDS)
def test_the_counters_of_the_write_back(app, sched, carry_write):
    p, ex = _compile(app, sched, carry_write=carry_write)
    spec = ex.time_spec
    steps = SCHEDULES[sched][1]
    # tracer's regions demote a chain of two to one step a pass
    chain = ex.plan.stream.time_tile if ex.plan.stream is not None else 1
    passes = -(-steps // chain)
    persistent = list(spec.persistent)
    before = _counters()
    ex(*_data(p))
    got = _delta(before, _counters())
    if carry_write is None:
        interior = math.prod(GRID) * 4
        assert got["stencil.carry_bytes"] == \
            passes * len(CHANGED[app]) * interior
        assert got["stencil.carry_inplace"] == passes * len(persistent)
    else:
        padded = sum(math.prod(g + int(spec.field_pad[f][a, 0])
                               + int(spec.field_pad[f][a, 1])
                               for a, g in enumerate(GRID)) * 4
                     for f in persistent)
        assert got["stencil.carry_bytes"] == passes * padded
        assert got["stencil.carry_inplace"] == 0
    assert got["stencil.carry_writes"] == passes * len(persistent)


@pytest.mark.parametrize("sched", ["block", "stream_t1"])
def test_a_periodic_field_is_rebuilt_under_the_default(sched):
    make, upd = APPS["pw"]
    knobs, steps, passes = SCHEDULES[sched]

    def build(**kw):
        return compile_program(make("periodic"), GRID, device="cpu",
                               steps=steps, update=upd(), **knobs, **kw)

    ex, rep = build(), build(carry_write="repad")
    assert ex.time_spec.carry_write == "inplace"
    p = make("periodic")
    before = _counters()
    got = ex(*_data(p))
    counted = _delta(before, _counters())
    assert counted["stencil.carry_inplace"] == 0
    assert counted["stencil.carry_writes"] == passes * 3
    _assert_bit_equal(got, rep(*_data(p)))


def _pointwise():
    """o0 = 3 in0[0,0,0]: in0's carry has no halo slab on any axis."""
    b = ProgramBuilder("pointwise", ndim=3, boundary="zero")
    (in0,) = b.inputs("in0")
    (o0,) = b.outputs("o0")
    b.define(o0, in0[0, 0, 0] * 3.0)
    return b.build()


@pytest.mark.parametrize("backend", ["cuda", "torch_fused"])
def test_a_mesh_loop_leaves_the_callers_inputs_unchanged(backend):
    def build(**kw):
        mesh = make_auto_mesh((2,), ("X",), devices=["cpu"] * 2)
        return compile_program(_pointwise(), GRID, backend=backend, steps=3,
                               update=lambda f, o: {"in0": 0.5 * o["o0"]},
                               mesh=mesh, mesh_axes=("X", None, None), **kw)

    ex = build()
    assert ex.time_spec.carry_write == "inplace"
    assert not ex.time_spec.field_pad["in0"].any()
    x = torch.randn(GRID, generator=torch.Generator().manual_seed(3))
    kept = x.clone()
    got = ex({"in0": x})["in0"]
    assert torch.equal(x, kept)
    assert torch.equal(got, build(carry_write="repad")({"in0": kept})["in0"])
    torch.testing.assert_close(got, kept * 1.5 ** 3)
