"""Two faults of the port against the reference, each held here on the CPU.

* **A sharded stream axis and a ring fed by no field.**  When a mesh cuts
  axis 0 under ``schedule="stream"``, each shard's sweep must start deep
  enough below its first plane that every temp ring warms up with true
  values, also when the ring's producer reads only a coefficient or a
  scalar (``dataflow.stream_halo``).  The programs: ``t = cf0<0>;
  o3 = t[-1,0,0]`` and the random draw that found the fault,
  ``o2 = square(cf0<-1>); o3 = square(o2[-2,2,-1])``, on meshes (2,) and
  (4,) of CPU devices, a single step and a 3-step fused loop, held to the
  reference's ``jnp_naive``/``jnp_fused`` (1e-4 and 1e-5 of the output's
  max abs, the sharded tolerances of ``tests/test_torch_distribute.py``)
  and to the port's own local compile.  The reference's sharded stream
  executable has the same fault, so it is not what the port is held to:
  on these tests' single-step inputs its ``pallas`` backend (eight host
  devices) is off its own ``jnp_naive`` by 1.879 (``coeff_ring``,
  ``cf0`` on axis 1) and 3.238 (axis 2), and by 12.46 and 109.9
  (``seed5_draw``), on each shard's first planes, on both meshes (max
  abs; run this file as a script, with ``PYTHONPATH=src:tests``, to
  print them).  The generated sweep of a shard, run on host threads, is
  held to ``jnp_naive``'s planes of that shard.
* **A served group that reads nothing.**  ``StencilEngine`` serving
  ``o0 = s0``, whose only group reads no field or coefficient, under the
  block and stream schedules, one request and a batch of three, equals
  the reference's ``StencilEngine(backend="jnp_fused")``; a mixed group
  (a temp that reads only a scalar, read by an op that reads a field)
  stays exact; and the generated kernels of such a group launch a batch
  of three on host threads as their plain versions run it.
"""

import numpy as np
import pytest
import torch

from repro.core import ProgramBuilder as RefBuilder
from repro.core import compile_program as ref_compile
from repro.core.ir import Access, CoeffRef, UnOp, UnOpKind
from repro.serve import StencilEngine as RefEngine
from repro.serve import StencilRequest as RefRequest
from repro_torch import compile_program
from repro_torch.core import ProgramBuilder, auto_plan, lower_to_dataflow
from repro_torch.core import boundary as bc
from repro_torch.dist import make_auto_mesh
from repro_torch.kernels import stencil3d
from repro_torch.kernels.stream3d import StreamCall, stream_call_reference
from repro_torch.serve import StencilEngine, StencilRequest

from test_torch_fuzz import to_port
from test_torch_kernel_emulated import run_emulated, run_stream_emulated

GRID = (8, 8, 32)


def coeff_ring(axis=2):
    """t = cf0<0>; o3 = t[-1,0,0]: a ring fed by a coefficient alone."""
    b = RefBuilder("coeff_ring", ndim=3, boundary="zero")
    b.inputs("in0")
    cf0 = b.coeff("cf0", axis=axis)
    t = b.temp("t")
    (o3,) = b.outputs("o3")
    b.define(t, cf0[0])
    b.define(o3, t[-1, 0, 0])
    return b.build()


def seed5_draw(axis=2):
    """o2 = square(cf0<-1>); o3 = square(o2[-2,2,-1]) (the fuzz's draw)."""
    b = RefBuilder("fuzz", ndim=3, boundary="zero")
    b.inputs("in0")
    b.coeff("cf0", axis=axis)
    o2 = b.temp("o2")
    (o3,) = b.outputs("o3")
    b.define(o2, UnOp(UnOpKind.SQUARE, CoeffRef("cf0", -1)))
    b.define(o3, UnOp(UnOpKind.SQUARE, Access("o2", (-2, 2, -1))))
    return b.build()


#: name -> the reference's program on a coefficient axis (the port's is
#: ``to_port`` of it)
PROGRAMS = {"coeff_ring": coeff_ring, "seed5_draw": seed5_draw}


def _data(axis, seed=0):
    rng = np.random.default_rng(seed)
    return ({"in0": rng.standard_normal(GRID).astype(np.float32)}, {},
            {"cf0": rng.standard_normal(GRID[axis]).astype(np.float32)})


def _halve(fields, out):
    return {"in0": 0.5 * out["o3"]}


def _within(got, want, tol):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * float(np.abs(w).max()), err


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_sharded_sweep_warms_up_a_ring_fed_by_a_coefficient(name, axis, n):
    make = PROGRAMS[name]
    args = _data(axis, seed=axis)
    want = ref_compile(make(axis), GRID, backend="jnp_naive")(*args)["o3"]
    p = to_port(make(axis))
    mesh = make_auto_mesh((n,), ("X",), devices=["cpu"] * n)
    ex = compile_program(p, GRID, schedule="stream", mesh=mesh,
                         mesh_axes=("X", None, None))
    got = ex(*args)["o3"]
    _within(got, want, 1e-4)
    local = compile_program(p, GRID, schedule="stream", device="cpu")(*args)
    _within(got, local["o3"], 1e-4)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_sharded_fused_sweep_warms_up_a_ring_fed_by_a_coefficient(name, n):
    make = PROGRAMS[name]
    args = _data(2, seed=3)
    want = ref_compile(make(), GRID, backend="jnp_fused", steps=3,
                       update=_halve)(*args)["in0"]
    p = to_port(make())
    mesh = make_auto_mesh((n,), ("X",), devices=["cpu"] * n)
    got = compile_program(p, GRID, schedule="stream", mesh=mesh,
                          mesh_axes=("X", None, None), steps=3,
                          update=_halve)(*args)["in0"]
    _within(got, want, 1e-5)
    local = compile_program(p, GRID, schedule="stream", device="cpu",
                            steps=3, update=_halve)(*args)["in0"]
    _within(got, local, 1e-5)


@pytest.mark.parametrize("queued", [False, True])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_generated_sweep_of_a_shard_warms_up_its_rings(name, queued):
    """Shard 1 of a (2,) mesh on axis 0: its sweep kernel on host threads,
    given the coefficient as the distributed executor pads it, against
    ``jnp_naive``'s planes of that shard (and against its plain version
    exactly)."""
    make = PROGRAMS[name]
    fields, _, coeffs = _data(2, seed=4)
    want = np.asarray(ref_compile(make(), GRID, backend="jnp_naive")(
        fields, {}, coeffs)["o3"])
    p = to_port(make())
    local = (GRID[0] // 2,) + GRID[1:]
    plan = auto_plan(p, local, schedule="stream")
    (region,) = lower_to_dataflow(p, plan, local,
                                  stream_sharded=True).regions
    call = StreamCall(p, region, local, global_extent=GRID, chunk=2,
                      stream_sharded=True)
    assert call.halo_lo[0] >= call.cta.warmup
    pc = {"cf0": bc.pad_coeff(torch.from_numpy(coeffs["cf0"]),
                              call.pad_lo[2], call.pad_hi[2],
                              bc.coeff_mode(p)).contiguous()}
    org = (local[0], 0, 0)
    got = run_stream_emulated(call, {}, [], pc, origin=org, queued=queued)
    plain = stream_call_reference(call, {}, [], pc, origin=org)
    torch.testing.assert_close(got["o3"], plain["o3"], rtol=0, atol=0)
    _within(got["o3"].numpy(), want[local[0]:], 1e-5)


# --------------------------------------------------------------------------
# A served group that reads nothing
# --------------------------------------------------------------------------

def scalar_only(builder):
    """in0 (read by nothing), o0 = s0."""
    b = builder("scalar_only", ndim=3, boundary="zero")
    b.inputs("in0")
    (s0,) = b.scalars("s0")
    (o0,) = b.outputs("o0")
    b.define(o0, s0)
    return b.build()


def scalar_temp(builder):
    """t = s0 * 2; o0 = t[0,0,0] + in0[1,0,0]: a temp that reads only a
    scalar, read by an op that reads a field."""
    b = builder("scalar_temp", ndim=3, boundary="zero")
    (in0,) = b.inputs("in0")
    (s0,) = b.scalars("s0")
    t = b.temp("t")
    (o0,) = b.outputs("o0")
    b.define(t, s0 * 2.0)
    b.define(o0, t[0, 0, 0] + in0[1, 0, 0])
    return b.build()


SERVED = {"scalar_only": scalar_only, "scalar_temp": scalar_temp}


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [({"in0": rng.standard_normal(GRID).astype(np.float32)},
             {"s0": np.float32(0.5 + k)}) for k in range(n)]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("schedule", ["block", "stream"])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_engine_serves_a_group_that_reads_nothing(name, schedule, n):
    make = SERVED[name]
    reqs = _requests(n, seed=n)
    with RefEngine(backend="jnp_fused") as ref:
        want = ref.map([RefRequest(program=make(RefBuilder), fields=f,
                                   scalars=s) for f, s in reqs])
    kw = {} if schedule == "block" else {"schedule": schedule}
    with StencilEngine(device="cpu", **kw) as eng:
        got = eng.map([StencilRequest(program=make(ProgramBuilder),
                                      fields=f, scalars=s) for f, s in reqs])
    assert [r.batch_size for r in got] == [n] * n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.outputs["o0"].numpy(),
                                      np.asarray(w.outputs["o0"]))


@pytest.mark.parametrize("kw", [{"strategy": "per_field"},
                                {"schedule": "stream"}],
                         ids=["per_field", "stream"])
def test_batch_of_a_program_without_scalars_whose_group_reads_nothing(kw):
    """``o0 = 2, o1 = in0[0,0,0] + 1`` has no scalar, and under
    ``per_field`` its group ``o0 = 2`` reads nothing: the batched
    executable still gives every element its own ``(B, *grid)`` rows,
    equal to the reference's ``jnp_naive`` on each element."""
    from repro_torch.core import batched_executable

    b = RefBuilder("const_beside", ndim=3, boundary="zero")
    (in0,) = b.inputs("in0")
    o0, o1 = b.outputs("o0", "o1")
    b.define(o0, 2.0)
    b.define(o1, in0[0, 0, 0] + 1.0)
    ref = b.build()
    xs = np.random.default_rng(5).standard_normal((3,) + GRID).astype(
        np.float32)
    run = batched_executable(compile_program(to_port(ref), GRID,
                                             device="cpu", **kw))
    got = run({"in0": torch.from_numpy(xs)}, {}, {})
    want = ref_compile(ref, GRID, backend="jnp_naive")
    for k in ("o0", "o1"):
        assert tuple(got[k].shape) == (3,) + GRID, k
        for i in range(3):
            np.testing.assert_array_equal(
                got[k][i].numpy(), np.asarray(want({"in0": xs[i]})[k]))


@pytest.mark.parametrize("schedule", ["block", "stream"])
def test_generated_kernels_of_a_group_that_reads_nothing_run_a_batch(
        schedule):
    """``o0 = s0`` launched for three requests at once: the batch comes
    from the ``(3, n)`` scalar rows, each element gets its own scalar, and
    the kernel on host threads equals its batched plain version."""
    p = scalar_only(ProgramBuilder)
    if schedule == "stream":
        (region,) = lower_to_dataflow(
            p, auto_plan(p, GRID, schedule="stream"), GRID).regions
        call, run = StreamCall(p, region, GRID), run_stream_emulated
        ref = stream_call_reference
    else:
        plan = auto_plan(p, GRID)
        call = stencil3d.build_group_call(p, plan.groups[0], plan.block,
                                          GRID)
        run, ref = run_emulated, stencil3d.group_call_reference
    sv = torch.tensor([[0.5], [1.5], [-2.0]])
    assert stencil3d.batch_of(call, {}, {}, sv) == 3
    want = ref(call, {}, sv, {}, device="cpu")
    got = run(call, {}, sv, {})
    assert want["o0"].shape == got["o0"].shape == (3,) + GRID
    torch.testing.assert_close(got["o0"], want["o0"], rtol=0, atol=0)
    for b in range(3):
        assert torch.all(got["o0"][b] == sv[b, 0])


def coeff_times_scalar(builder):
    """o0 = cf0<0> * s0: a group that reads one coefficient and no field."""
    b = builder("coeff_times_scalar", ndim=3, boundary="zero")
    b.inputs("in0")
    cf0 = b.coeff("cf0", axis=2)
    (s0,) = b.scalars("s0")
    (o0,) = b.outputs("o0")
    b.define(o0, cf0[0] * s0)
    return b.build()


@pytest.mark.parametrize("schedule", ["block", "stream"])
def test_generated_kernels_of_a_group_with_a_shared_coefficient_run_a_batch(
        schedule):
    """``o0 = cf0<0> * s0`` launched for three requests that share one
    1-D coefficient: the batch comes from the ``(3, n)`` scalar rows, the
    kernel on host threads equals its batched plain version, and each
    element equals the reference's ``jnp_naive`` on that request."""
    p = coeff_times_scalar(ProgramBuilder)
    if schedule == "stream":
        (region,) = lower_to_dataflow(
            p, auto_plan(p, GRID, schedule="stream"), GRID).regions
        call, run = StreamCall(p, region, GRID), run_stream_emulated
        ref = stream_call_reference
    else:
        plan = auto_plan(p, GRID)
        call = stencil3d.build_group_call(p, plan.groups[0], plan.block,
                                          GRID)
        run, ref = run_emulated, stencil3d.group_call_reference
    cf0 = np.random.default_rng(7).standard_normal(GRID[2]).astype(
        np.float32)
    ax = call.coeff_axis["cf0"]
    pc = {"cf0": bc.pad_coeff(torch.from_numpy(cf0), call.pad_lo[ax],
                              call.pad_hi[ax], bc.coeff_mode(p)).contiguous()}
    sv = torch.tensor([[0.5], [1.5], [-2.0]])
    assert pc["cf0"].ndim == 1
    assert stencil3d.batch_of(call, {}, pc, sv) == 3
    want = ref(call, {}, sv, pc, device="cpu")
    got = run(call, {}, sv, pc)
    assert want["o0"].shape == got["o0"].shape == (3,) + GRID
    torch.testing.assert_close(got["o0"], want["o0"], rtol=0, atol=0)
    ex = ref_compile(coeff_times_scalar(RefBuilder), GRID,
                     backend="jnp_naive")
    zeros = np.zeros(GRID, np.float32)
    for b in range(3):
        one = ex({"in0": zeros}, {"s0": np.float32(sv[b, 0])},
                 {"cf0": cf0})["o0"]
        np.testing.assert_allclose(got["o0"][b].numpy(), np.asarray(one),
                                   rtol=1e-6, atol=0)


def reference_differences():
    """Print the reference's sharded stream executable against its own
    ``jnp_naive`` on the single-step cases above: program, coefficient
    axis, shards, max abs difference, the planes it sits on."""
    from repro.dist.sharding import make_auto_mesh as ref_mesh

    for name, make in sorted(PROGRAMS.items()):
        for axis in (1, 2):
            args = _data(axis, seed=axis)
            want = np.asarray(ref_compile(make(axis), GRID,
                                          backend="jnp_naive")(*args)["o3"])
            for n in (2, 4):
                got = np.asarray(ref_compile(
                    make(axis), GRID, backend="pallas", schedule="stream",
                    mesh=ref_mesh((n,), ("X",)),
                    mesh_axes=("X", None, None))(*args)["o3"])
                d = np.abs(got - want)
                print(name, axis, n, float(d.max()),
                      np.nonzero(d.max(axis=(1, 2)))[0].tolist())


if __name__ == "__main__":
    import os
    import subprocess
    import sys

    flag = "--xla_force_host_platform_device_count=8"
    if flag not in os.environ.get("XLA_FLAGS", ""):
        env = dict(os.environ, XLA_FLAGS=flag, JAX_PLATFORMS="cpu")
        sys.exit(subprocess.run([sys.executable, __file__], env=env)
                 .returncode)
    reference_differences()
