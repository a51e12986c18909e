"""The block kernel's CTA on the CPU: what the planner prices (shared
memory, CTAs an SM, staged bytes and generated operations a point) and
what the emitter generates from it (levels, rings, inlined ops, copies).

The kernel itself runs in ``tests/test_torch_kernel_emulated.py`` (on host
threads) and ``tests/test_torch_cuda.py`` (on the card).
"""

import inspect
import re

import pytest
import torch

from repro_torch import hw
from repro_torch.apps import pw_advection, tracer_advection
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.schedule import (BLOCK_REGS, auto_plan, clamp_block,
                                       plan_block_cta, resident_threads,
                                       smem_cost)
from repro_torch.kernels import stencil3d

PAPER_GRIDS = [(256, 256, 128), (512, 256, 256)]
PLAN_GRIDS = [(8, 8, 32), (12, 10, 130), (16, 16, 256)] + PAPER_GRIDS


def _call(app, grid, dtype=torch.float32, boundary="zero"):
    p = app(boundary)
    plan = auto_plan(p, grid, dtype=str(dtype).removeprefix("torch."))
    return stencil3d.build_group_call(p, plan.groups[0], plan.block, grid,
                                      dtype=dtype)


@pytest.mark.parametrize("grid", PAPER_GRIDS)
def test_each_op_is_evaluated_once_a_point(grid):
    """Generated operations a grid point, margins, warm-up planes and
    ragged tiles included: tracer_advection at most twice its IR's 135
    (evaluating every op at every offset in each thread generated 1,704);
    pw_advection, which reads no op at an offset, exactly its IR's 63."""
    tr = _call(tracer_advection, grid)
    assert tr.program.flops_per_point() == 135
    assert tr.flops_per_point() <= 270
    pw = _call(pw_advection, grid)
    assert pw.flops_per_point() == pw.program.flops_per_point() == 63


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", PLAN_GRIDS)
@pytest.mark.parametrize("app", [pw_advection, tracer_advection])
def test_planned_cta_fits_shared_memory(app, grid, dtype):
    """Input rings and op rings after reuse fit the 232,448 B a CTA may
    use, at every grid the planner tests, in both compiled dtypes."""
    p = app()
    plan = auto_plan(p, grid, dtype=dtype)
    assert smem_cost(p, plan, grid) <= hw.H100.smem_per_block
    blk = clamp_block(plan.block, grid)
    assert blk[0] == plan.block[0] or blk[0] == grid[0]


@pytest.mark.parametrize("grid", PAPER_GRIDS)
def test_tracer_keeps_two_ctas_an_sm(grid):
    """tracer_advection's CTA leaves room for a second one on each SM, in
    shared memory and in the registers the planner allots, so one CTA's
    barriers do not idle the SM."""
    call = _call(tracer_advection, grid)
    nt = call.threads[0] * call.threads[1]
    assert call.cta.ctas_per_sm >= 2
    assert resident_threads(call.block, call.smem_bytes, BLOCK_REGS) \
        >= 2 * nt
    assert f"__launch_bounds__({nt}, {call.cta.ctas_per_sm})" in \
        call.source()


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("app", [pw_advection, tracer_advection])
def test_emitter_generates_what_the_planner_prices(app, dtype, boundary):
    """Each loop's value-numbered body has exactly the distinct operations
    the planner counts for it, so ``flops_per_point`` is the generated
    code's."""
    call = _call(app, (256, 256, 128), dtype, boundary)
    for level in call.cta.levels:
        for loop in level:
            em = stencil3d._Emitter(call, loop)
            for out in loop.roots:
                em.root(out)
            assert em.flops == loop.flops, loop.roots


def test_tracer_cta_structure():
    """tracer_advection's CTA: 8 levels of roots (19 ops read at an offset
    and the stored ``ta``); the four divergences inlined into the ops
    that read them; rings as deep as the planes they are read at (the
    predictor ``zta1`` at -1..+1, the x-direction chain at two); the
    tracer's input ring 5 planes and one in flight; single-plane rings
    sharing bytes where their lives do not overlap."""
    call = _call(tracer_advection, (256, 256, 128))
    cta = call.cta
    assert len(cta.levels) == 8
    assert [lp.roots for lp in cta.levels[3]] == [("zta1",)]
    assert cta.levels[-1][0].roots == ("ta",)
    assert cta.inline["zta1"] == ("zdivx", "zdivy", "zdivz")
    assert cta.inline["ta"] == ("zdiv2",)
    assert len(cta.rings) == 19
    deep = {out: r.slots for out, r in cta.rings.items() if r.slots > 1}
    assert deep == {"zdx": 2, "zsx": 2, "zfx": 2, "zta1": 3, "zdx2": 2,
                    "zsx2": 2, "zfx2": 2}
    assert {r.field: r.slots for r in cta.inputs}["t"] == 6
    single = [r for r in cta.rings.values() if r.slots == 1]
    assert len({r.offset for r in single}) == 8 < len(single) == 12
    # a shared offset is reused only at a level after every read of the
    # plane in it (readers: the roots whose bodies read it)
    lv = {r: n for n, level in enumerate(cta.levels) for lp in level
          for r in lp.roots}
    p = call.program
    ops = {p.ops[i].out: p.ops[i] for i in call.group}
    last = {j.out: max(lv[r] for r in lv for o in (r,) + cta.inline[r]
                       if j.out in {a.field for a in ops[o].accesses()})
            for j in single}
    for j in single:
        for k in single:
            if j.offset == k.offset and lv[j.out] < lv[k.out]:
                assert lv[k.out] > last[j.out], (j.out, k.out)
    # buffers lie inside the CTA's shared memory, 16-byte aligned
    ends = [r.offset + r.nbytes for r in cta.inputs] + [
        r.offset + 4 * r.slots * r.plane for r in cta.rings.values()]
    assert max(ends) <= cta.smem_bytes
    assert all(r.offset % 16 == 0 for r in list(cta.inputs)
               + list(cta.rings.values()))


@pytest.mark.parametrize("grid", [(70,), (9, 45)])
def test_lifted_programs_get_a_cta(grid):
    """1-D and 2-D programs plan and emit as 3-D kernels with unit outer
    axes (one plane, no sweep)."""
    nd = len(grid)
    b = ProgramBuilder("lifted", ndim=nd)
    x = b.input("x")
    t = b.temp("t")
    o = b.output("o")
    z = (0,) * nd
    lo = tuple(-1 if a == nd - 1 else 0 for a in range(nd))
    hi = tuple(1 if a == 0 else 0 for a in range(nd))
    b.define(t, x[z] * 2.0 + x[hi] - x[lo])
    b.define(o, t[hi] * t[lo] + t[z])
    p = b.build()
    plan = auto_plan(p, grid)
    assert len(plan.block) == nd
    cta = plan_block_cta(p, plan.groups[0], clamp_block(plan.block, grid),
                         "float32")
    assert cta.tile[0] == 1 and cta.warmup == 0
    assert list(cta.rings) == ["t"]
    src = stencil3d.build_group_call(p, plan.groups[0], plan.block,
                                     grid).source()
    assert "g0_kernel(" in src


def test_kernel_source_keeps_its_assembly_in_the_helpers():
    """All inline PTX of the block kernel (``cp.async``, its commit and
    wait, the opaque register) sits between the helper markers, which the
    host emulation replaces; the kernel body has one barrier per level
    and one at the top of each plane, and no switch between designs."""
    call = _call(tracer_advection, (256, 256, 128))
    src = stencil3d.KernelModule([call]).source
    head, rest = src.split("// ---- PTX helpers")
    helpers, tail = rest.split("// ---- end of PTX helpers")
    assert "asm" in helpers and "asm" not in head + tail
    for op in ("cp.async.cg.shared.global", "cp.async.ca.shared.global",
               "cp.async.commit_group", "cp.async.wait_all"):
        assert op in helpers
    body = tail.split("g0_kernel(", 1)[1]
    assert body.count("__syncthreads();") == len(call.cta.levels)
    assert "stage_rows<4>" in body and "stage_rows<1>" in body
    module = inspect.getsource(stencil3d)
    assert not re.search(r"environ|getenv", module)
