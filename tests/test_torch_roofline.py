"""The port's H100-priced stencil roofline
(repro_torch.analysis.stencil_roofline) and achieved-fraction probe
(repro_torch.obs.achieved) on the CPU.

Against the JAX package: ``model_program``'s operations and bytes a point
in all three backend roles, and the stream schedule's
``plan_bytes_per_point`` on the reference's own stream plans, equal the
reference's.  The port's own checks: the read-once bound at the paper's
grids (the bounds ``PERF.md`` reports), the block schedule priced by the
port's CTA, the torch backends collapsing to their roles, and the probe's
arithmetic.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest

from repro.analysis import stencil_roofline as ref_roofline
from repro.apps import pw_advection as ref_pw
from repro.apps import tracer_advection as ref_tracer
from repro.core.schedule import auto_plan as ref_auto_plan
from repro.core.schedule import plan_to_dict as ref_plan_to_dict
from repro_torch import compile_program, hw
from repro_torch.analysis import stencil_roofline as roofline
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection)
from repro_torch.core.dataflow import lower_to_dataflow
from repro_torch.core.passes import infer_halo
from repro_torch.core.schedule import auto_plan, plan_block_cta
from repro_torch.interop import BACKENDS, plan_from_reference
from repro_torch.obs import (Tracer, achieved_fraction, best_of,
                             fraction_for, measure_achieved,
                             model_call_seconds)

APPS = [(ref_pw, pw_advection), (ref_tracer, tracer_advection)]


# ------------------------------------------- against the reference

@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("apps", APPS, ids=["pw", "tracer"])
def test_model_program_counts_equal_reference(apps, boundary, dtype_bytes):
    """Operations and bytes a point in every backend role equal the
    reference's (``pallas`` -> ``cuda``, ``jnp_*`` -> ``torch_*``); only
    the price of them differs."""
    ref_app, app = apps
    want = ref_roofline.model_program(ref_app(boundary), dtype_bytes)
    got = roofline.model_program(app(boundary), dtype_bytes)
    assert got.flops_per_point == want.flops_per_point
    assert got.bytes_per_point == {BACKENDS[k]: v for k, v
                                   in want.bytes_per_point.items()}


@pytest.mark.parametrize("plane_tile", [1, 2])
@pytest.mark.parametrize("time_tile", [1, 2, 4])
@pytest.mark.parametrize("apps", APPS, ids=["pw", "tracer"])
def test_stream_plan_bytes_equal_reference(apps, time_tile, plane_tile):
    """On the reference's own stream plans, carried across by
    ``interop.plan_from_reference``, the stream count (chained halos, once
    per effective ``time_tile``) and its recompute-inflated operations
    equal the reference's."""
    ref_app, app = apps
    grid = (16, 12, 64)
    ref_plan = ref_auto_plan(ref_app(), grid, schedule="stream", steps=8,
                             time_tile=time_tile, plane_tile=plane_tile)
    p = app()
    plan = plan_from_reference(ref_plan_to_dict(ref_plan), p, grid)
    assert plan.schedule == "stream" and plan.backend == "cuda"
    assert roofline.plan_bytes_per_point(p, plan, grid) == \
        ref_roofline.plan_bytes_per_point(ref_app(), ref_plan, grid)
    graph = lower_to_dataflow(p, plan, grid)
    assert roofline._stream_flops_per_point(p, grid, graph) == \
        ref_roofline._plan_flops_per_point(ref_app(), ref_plan, grid)


# ------------------------------------------------ the port's own model

@pytest.mark.parametrize("app,grid,dtype,want_ms", [
    (pw_advection, (512, 256, 256), "float32", 0.2404),
    (tracer_advection, (256, 256, 128), "float32", 0.0701),
    (pw_advection, (256, 256, 128), "bfloat16", 0.0300),
], ids=["pw-f32-32M", "tracer-f32-8M", "pw-bf16-8M"])
def test_read_once_bound_at_the_paper_grids(app, grid, dtype, want_ms):
    """Every input read once and every output written once over 3.35 TB/s
    (the stencils are bytes-bound at 67 TFLOP/s): the bounds ``PERF.md``
    gives these kernels, from ``model_program`` and from the kernel count
    ``chip_smoke.py`` takes (coefficients included) alike."""
    p = app()
    isz = hw.DTYPE_BYTES[dtype]
    pts = float(np.prod(grid))
    m = roofline.model_program(p, isz)
    assert round(pts / (m.mpts("cuda") * 1e6) * 1e3, 4) == want_ms
    (grp,) = auto_plan(p, grid, dtype=dtype).groups
    gh = infer_halo(p, grp)
    nbytes, flops = roofline.kernel_traffic(
        p, grid, gh.group_inputs, gh.group_outputs,
        [p.ops[i].expr for i in grp], isz, coeffs=sorted(p.coeffs))
    seconds, by = roofline.roofline_seconds(nbytes, flops)
    assert by == "bytes" and round(seconds * 1e3, 4) == want_ms


def test_roofline_seconds_prices_the_h100():
    assert roofline.roofline_seconds(3.35e12, 0) == (1.0, "bytes")
    assert roofline.roofline_seconds(0, 67e12) == (1.0, "operations")
    assert roofline.modeled_energy_j(1e6, 1.0) == pytest.approx(700.0)


def test_no_tpu_constant_survives():
    src = inspect.getsource(roofline)
    for tpu in ("7.5e12", "5e-9", "TPU_V5E", "VPU", "busy_watts",
                "STREAM_STEP_OVERHEAD"):
        assert tpu not in src, tpu


def test_stream_models_fewer_bytes_than_a_small_block():
    """The sweep fetches each input cell once; a deliberately small block
    tile (chunks of 2 planes, 1 row, 32 columns) stages its halo rows and
    planes again and again, far above the read-once floor."""
    p = pw_advection()
    grid = (32, 32, 128)
    block = auto_plan(p, grid)
    small = dataclasses.replace(block, block=(2, 1, 32),
                                groups=[list(g) for g in block.groups])
    stream = auto_plan(p, grid, schedule="stream")
    b_small = roofline.plan_bytes_per_point(p, small, grid)
    b_stream = roofline.plan_bytes_per_point(p, stream, grid)
    floor = (3 + 3) * 4
    assert floor <= b_stream < floor * 1.25
    assert b_small > floor * 1.5 > b_stream
    assert roofline.model_plan(p, stream, grid) < \
        roofline.model_plan(p, small, grid)


@pytest.mark.parametrize("app", [pw_advection, tracer_advection])
def test_block_plan_priced_by_the_cta(app):
    """Under the block schedule the model prices what ``pick_block`` ranks
    by: each group's CTA staging its planes, plus its outputs written
    once, and the operations it generates."""
    p = app()
    grid = (64, 40, 100)
    plan = auto_plan(p, grid, strategy="per_field")
    assert len(plan.groups) > 1 or app is pw_advection
    bytes_pp = flops_pp = 0.0
    for grp in plan.groups:
        staged, ops = plan_block_cta(p, grp, plan.block, "float32"
                                     ).traffic(grid)
        bytes_pp += staged + 4 * len(infer_halo(p, grp).group_outputs)
        flops_pp += ops
    assert roofline.plan_bytes_per_point(p, plan, grid) == \
        pytest.approx(bytes_pp)
    pts = float(np.prod(grid))
    assert roofline.model_plan(p, plan, grid) == pytest.approx(
        roofline.roofline_seconds(bytes_pp * pts, flops_pp * pts)[0])


@pytest.mark.parametrize("backend", ["torch_fused", "torch_naive"])
def test_torch_backends_collapse_to_role_numbers(backend):
    p = pw_advection()
    grid = (16, 16, 128)
    plan = dataclasses.replace(auto_plan(p, grid), backend=backend)
    m = roofline.model_program(p)
    assert roofline.plan_bytes_per_point(p, plan, grid) == \
        m.bytes_per_point[backend]
    assert roofline.model_plan(p, plan, grid) == pytest.approx(
        float(np.prod(grid)) / (m.mpts(backend) * 1e6))
    # ... whatever the tile or schedule
    other = dataclasses.replace(plan, block=(1, 1, 32))
    assert roofline.model_plan(p, other, grid) == \
        roofline.model_plan(p, plan, grid)


# ------------------------------------------------ achieved fraction

def _pw_inputs(grid):
    rng = np.random.default_rng(0)
    f = {k: rng.normal(size=grid).astype(np.float32) * 0.1 for k in "uvw"}
    c = {k: np.ones(grid[2], np.float32)
         for k in ("tzc1", "tzc2", "tzd1", "tzd2")}
    return f, {"tcx": 0.05, "tcy": 0.05}, c


def test_measure_achieved_on_the_cpu():
    """The probe on a CPU executor: the host clock, the model's price of
    the plan, the ``roofline.achieved`` span."""
    grid = (8, 8, 32)
    ex = compile_program(pw_advection(), grid, device="cpu")
    tr = Tracer()
    res = measure_achieved(ex, *_pw_inputs(grid), warmup=1, repeats=1,
                           tracer=tr)
    assert 0 < res.achieved_fraction < float("inf")
    assert res.steps == 1 and res.points == float(np.prod(grid))
    assert res.modeled_s == roofline.model_plan(ex.program, ex.plan, grid)
    assert res.bytes_moved == pytest.approx(
        roofline.plan_bytes_per_point(ex.program, ex.plan, grid)
        * res.points)
    assert res.steps_per_sec > 0 and res.gbytes_per_sec > 0
    d = res.to_dict()
    assert json.loads(json.dumps(d)) == d
    sp = tr.spans("roofline.achieved")[0]
    assert sp["args"]["roofline_fraction"] == res.achieved_fraction


def test_fraction_for_counts_the_steps_of_a_call():
    grid = (6, 8, 32)
    ex = compile_program(pw_advection(), grid, steps=4,
                         update=pw_advection_update(0.1), device="cpu")
    per_step = roofline.model_plan(ex.program, ex.plan, grid)
    assert model_call_seconds(ex) == pytest.approx(4 * per_step)
    assert fraction_for(ex, 8 * per_step) == pytest.approx(0.5)
    res = measure_achieved(ex, *_pw_inputs(grid), timer=lambda fn: 1.0)
    assert res.steps == 4 and res.measured_s == 1.0
    assert res.achieved_fraction == pytest.approx(4 * per_step)


def test_achieved_fraction_degenerate_inputs():
    assert achieved_fraction(1.0, 0.0) == 0.0
    assert achieved_fraction(0.0, 1.0) == 0.0
    assert achieved_fraction(2.0, 4.0) == 0.5


def test_best_of_on_the_cpu_warms_up_then_takes_the_fastest():
    calls = []
    t = best_of(lambda: calls.append(1), "cpu", warmup=2, repeats=3)
    assert len(calls) == 5 and 0 <= t < 1.0
