"""The stream sweep kernel's CTA and generated source on the CPU: what the
planner sizes (window rings with planes in flight, CTAs an SM at the
planned registers, chunks) and what the emitter makes of it (copies in
the helper block, barriers a plane, launch bounds), at the grids
``chip_smoke.py`` drives and on small ones."""

import re

import numpy as np
import pytest
import torch

from repro_torch import hw
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection)
from repro_torch.core import boundary as bc
from repro_torch.core.dataflow import lower_to_dataflow
from repro_torch.core.lower_stream import trace_update
from repro_torch.core.schedule import (STREAM_REGS, adapt_update,
                                       auto_plan, stream_levels)
from repro_torch.kernels import stencil3d
from repro_torch.kernels.stencil3d import scalar_rows
from repro_torch.kernels.stream3d import StreamCall

# chip_smoke.py's stream paths: (app, boundary, grid, dtype, T, P)
SMOKE = [
    (pw_advection, "zero", (512, 256, 256), torch.float32, 1, 1),
    (pw_advection, "periodic", (512, 256, 256), torch.float32, 1, 1),
    (pw_advection, "zero", (512, 256, 256), torch.float32, 2, 1),
    (pw_advection, "zero", (512, 256, 256), torch.float32, 4, 1),
    (pw_advection, "zero", (512, 256, 256), torch.float32, 1, 2),
    (tracer_advection, "zero", (256, 256, 128), torch.float32, 1, 1),
    (tracer_advection, "periodic", (256, 256, 128), torch.float32, 1, 1),
    (pw_advection, "zero", (256, 256, 128), torch.bfloat16, 1, 1),
]


def _calls(app, boundary, grid, dtype, T, P, **kw):
    p = app(boundary)
    plan = auto_plan(p, grid, schedule="stream", time_tile=T, plane_tile=P,
                     dtype=str(dtype).removeprefix("torch."))
    graph = lower_to_dataflow(p, plan, grid)
    calls = []
    for r in graph.regions:
        ckw = dict(kw)
        if graph.time_tile > 1:
            upd = adapt_update(pw_advection_update(0.1))
            exprs, why = trace_update(p, upd, r.halo.group_inputs,
                                      [p.ops[i].out for i in r.ops])
            assert why is None, why
            ckw.update(time_tile=graph.time_tile, update=upd,
                       update_exprs=exprs)
        calls.append(StreamCall(p, r, grid, dtype=dtype,
                                plane_tile=graph.plane_tile, **ckw))
    return calls


def _ids(case):
    app, boundary, grid, dtype, T, P = case
    return (f"{app.__name__}-{boundary}-{'x'.join(map(str, grid))}-"
            f"{str(dtype).removeprefix('torch.')}-T{T}-P{P}")


@pytest.mark.parametrize("case", SMOKE, ids=_ids)
def test_planned_cta_fits_the_sm(case):
    """Window rings hold the planes a loop step reads plus the next
    step's planes in flight, rows padded to 16 bytes; the CTAs an SM the
    planner counts fit its shared memory, threads and registers (at
    ``STREAM_REGS`` a thread); and the chunks give every CTA slot of the
    card work where there are tiles enough."""
    for call in _calls(*case):
        cta = call.cta
        nt = cta.threads[0] * cta.threads[1]
        assert cta.smem_bytes <= hw.H100.smem_per_block
        assert cta.ctas_per_sm * (cta.smem_bytes
                                  + hw.H100.smem_reserved_per_cta) \
            <= hw.H100.smem_per_sm
        assert cta.ctas_per_sm * nt * STREAM_REGS \
            <= hw.H100.registers_per_sm
        for b in cta.buffers:
            if b.key[0] == "win":
                assert b.slots == call.depths[b.key[1]] + 2 * call.P - 1
                assert b.extent[-1] * b.itemsize % 16 == 0
        n_tiles = int(np.prod(cta.tiles))
        slots = hw.H100.sms * cta.ctas_per_sm
        assert cta.ctas >= min(slots, n_tiles)
        assert cta.chunk * cta.n_chunks >= call.grid_shape[0]


@pytest.mark.parametrize("case", SMOKE, ids=_ids)
def test_kernel_source_follows_the_plan(case):
    """The launch bounds ask for the planned CTAs an SM; the barriers in
    the kernel body are the top-of-step one, one per level after the
    first and the chain's stage ends (a pw chain applies its update in
    its outputs' loop); all inline PTX sits in the helper block."""
    calls = _calls(*case)
    mod = stencil3d.bind(calls)
    src = mod.source
    head, rest = src.split("// ---- PTX helpers")
    helpers, body = rest.split("// ---- end of PTX helpers")
    assert "asm" in helpers
    assert "asm" not in head + body
    for k, call in enumerate(calls):
        cta = call.cta
        nt = cta.threads[0] * cta.threads[1]
        kern = body.split(f"g{k}_kernel(", 1)[1].split("extern \"C\"")[0]
        assert f"__launch_bounds__({nt}, {cta.ctas_per_sm})\ng{k}_kernel(" \
            in body
        assert kern.count("cp_async_wait_all();") == 1
        assert kern.count("__syncthreads();") == round(
            call.barriers_per_plane() * call.P)
        assert "cp_async_commit();" in kern
        assert not re.search(r"\bload\d+\(", kern)
    T, P = case[4], case[5]
    if case[0] is pw_advection:
        # one barrier a loop step, and one between two chain stages
        assert [c.barriers_per_plane() for c in calls] == [(1 + T - 1) / P]


def test_tracer_regions_keep_one_barrier_a_level():
    """tracer_advection's four regions: the top-of-step barrier closes the
    last level of the plane before, so a plane passes one barrier a
    level (three for the three-level regions)."""
    calls = _calls(tracer_advection, "zero", (256, 256, 128), torch.float32,
                   1, 1)
    levels = [len(set(stream_levels(c.program, c.region).values()))
              for c in calls]
    assert [c.barriers_per_plane() for c in calls] == levels
    assert max(levels) == 3


@pytest.mark.parametrize("dtype,width,want", [
    (torch.float32, 68, 16), (torch.float32, 66, 4),
    (torch.bfloat16, 72, 16), (torch.bfloat16, 70, 4),
    (torch.bfloat16, 69, 2)])
def test_copy_sizes_follow_the_layout(dtype, width, want):
    """16-byte copies where the window's base, strides and rounded rows
    allow, 4-byte ones where they allow those, element by element else
    (bfloat16); the planes' rows are 66 elements wide here."""
    p = pw_advection()
    grid = (4, 6, 64)
    call = StreamCall(p, lower_to_dataflow(
        p, auto_plan(p, grid, schedule="stream"), grid).regions[0], grid,
        dtype=dtype, tile=(4, 32))
    rng = np.random.default_rng(0)
    padded = {}
    for f in call.group_inputs:
        x = torch.as_tensor(rng.normal(size=grid).astype(np.float32))
        x = bc.pad_field(x.to(dtype), call.pad_lo, call.pad_hi, "zero")
        padded[f] = torch.nn.functional.pad(
            x, (0, width - x.shape[-1])).contiguous()
    outs = {o: torch.empty((1,) + grid, dtype=dtype)
            for o in call.group_outputs}
    sv = scalar_rows([0.1, 0.1], call.n_scalars, 1, "cpu")
    args = call.kernel_args(padded, sv, {
        c: torch.zeros(80, dtype=dtype) for c in call.group_coeffs}, None,
        None, outs)
    assert args[3] == want
