"""Faults of the port against the reference, each held here on the CPU.

* A fuse group or stream region that reads no field and no coefficient
  (``o0 = s0``) runs on the orchestrator's device: under ``"block"``
  (``auto`` and ``per_field``) and ``"stream"`` it gives what the
  reference's ``jnp_naive`` gives, and its generated kernels, run on host
  threads, give what their plain versions give.
* ``carry_write="inplace"`` writes each step into the loop's carry, never
  into the caller's arrays: numpy arrays and tensors given to a fused loop
  are unchanged after it, under ``"repad"`` and ``"inplace"``, under the
  block and stream schedules (T = 1, 2) and ``torch_fused``; the result is
  the reference's ``jnp_fused`` loop's at the fused loop's 1e-5.
* ``repro_torch.core`` exports every public name ``repro.core`` exports
  (its submodules aside).
"""

import inspect

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import ProgramBuilder as RefBuilder
from repro.core import compile_program as ref_compile
from repro_torch import compile_program
from repro_torch.core import ProgramBuilder, auto_plan, lower_to_dataflow
from repro_torch.kernels import stencil3d
from repro_torch.kernels.stream3d import StreamCall

from test_torch_kernel_emulated import run_emulated, run_stream_emulated

GRID = (6, 8, 32)


def _scalar_only(builder):
    """in0 (read by nothing), o0 = s0."""
    b = builder("scalar_only", ndim=3, boundary="zero")
    b.inputs("in0")
    (s0,) = b.scalars("s0")
    (o0,) = b.outputs("o0")
    b.define(o0, s0)
    return b.build()


def _const_beside_a_read(builder):
    """o0 = 2, o1 = in0[0,0,0] + 1: under per_field, o0's group reads
    nothing."""
    b = builder("const_beside", ndim=3, boundary="zero")
    (in0,) = b.inputs("in0")
    o0, o1 = b.outputs("o0", "o1")
    b.define(o0, 2.0)
    b.define(o1, in0[0, 0, 0] + 1.0)
    return b.build()


@pytest.mark.parametrize("kw", [{}, {"strategy": "per_field"},
                                {"schedule": "stream"}],
                         ids=["block", "per_field", "stream"])
def test_group_that_reads_nothing_runs_on_the_orchestrators_device(kw):
    x = np.random.default_rng(0).standard_normal(GRID).astype(np.float32)
    args = ({"in0": x}, {"s0": np.float32(0.5)})
    got = compile_program(_scalar_only(ProgramBuilder), GRID, device="cpu",
                          **kw)(*args)
    want = ref_compile(_scalar_only(RefBuilder), GRID,
                       backend="jnp_naive")(*args)
    assert float(got["o0"].sum()) == 768.0
    np.testing.assert_array_equal(got["o0"].numpy(), np.asarray(want["o0"]))


@pytest.mark.parametrize("schedule", ["fused", "per_field", "stream"])
def test_generated_kernels_of_a_group_that_reads_nothing(schedule):
    """The block and sweep kernels of ``o0 = s0`` on host threads (no
    input window, no coefficient) against their plain versions, which run
    on the device they are given."""
    p = _scalar_only(ProgramBuilder)
    sv = torch.tensor([0.5])
    if schedule == "stream":
        graph = lower_to_dataflow(p, auto_plan(p, GRID, schedule="stream"),
                                  GRID)
        calls = [StreamCall(p, r, GRID, dtype=torch.float32,
                            plane_tile=graph.plane_tile)
                 for r in graph.regions]
        run = run_stream_emulated
    else:
        plan = auto_plan(p, GRID, strategy=schedule)
        calls = [stencil3d.build_group_call(p, g, plan.block, GRID)
                 for g in plan.groups]
        run = run_emulated
    (call,) = calls
    assert not call.group_inputs and not call.group_coeffs
    want = call({}, sv, {}, device="cpu")
    with pytest.raises(ValueError, match="no device"):
        call({}, sv, {})
    got = run(call, {}, sv, {})
    assert float(want["o0"].sum()) == 768.0
    torch.testing.assert_close(got["o0"], want["o0"], rtol=0, atol=0)


def test_constant_group_beside_a_reading_one_under_per_field():
    x = np.random.default_rng(1).standard_normal(GRID).astype(np.float32)
    p = _const_beside_a_read(ProgramBuilder)
    got = compile_program(p, GRID, device="cpu",
                          strategy="per_field")({"in0": x})
    want = ref_compile(_const_beside_a_read(RefBuilder), GRID,
                       backend="jnp_naive")({"in0": x})
    assert float(got["o0"].sum()) == 3072.0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


def _carried(builder):
    """o0 = in0[0,0,0]; the loop carries in0 <- 0.5 o0."""
    b = builder("carried", ndim=3, boundary="zero")
    (in0,) = b.inputs("in0")
    (o0,) = b.outputs("o0")
    b.define(o0, in0[0, 0, 0] * 1.0)
    return b.build()


def _halve(fields, out):
    return {"in0": 0.5 * out["o0"]}


# (backend/schedule options, carry_write)
LOOPS = [(dict(), "repad"), (dict(), "inplace"),
         (dict(schedule="stream"), "repad"),
         (dict(schedule="stream"), "inplace"),
         (dict(schedule="stream", time_tile=2), "repad"),
         (dict(schedule="stream", time_tile=2), "inplace"),
         (dict(backend="torch_fused"), "repad"),
         (dict(backend="torch_fused"), "inplace")]


@pytest.mark.parametrize("kw,carry_write", LOOPS,
                         ids=[f"{'-'.join(map(str, k.values())) or 'block'}"
                              f"-{c}" for k, c in LOOPS])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_fused_loop_leaves_the_callers_inputs_unchanged(kw, carry_write,
                                                        as_tensor):
    x = np.random.default_rng(2).standard_normal(GRID).astype(np.float32)
    kept = x.copy()
    given = torch.from_numpy(x) if as_tensor else x
    ex = compile_program(_carried(ProgramBuilder), GRID, device="cpu",
                         steps=3, update=_halve, carry_write=carry_write,
                         **kw)
    got = ex({"in0": given})["in0"]
    np.testing.assert_array_equal(x, kept)
    assert given is not got and not np.shares_memory(got.numpy(), x)
    want = ref_compile(_carried(RefBuilder), GRID, backend="jnp_fused",
                       steps=3, update=_halve)({"in0": kept})["in0"]
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # a second call on the same arrays computes the same
    np.testing.assert_array_equal(ex({"in0": given})["in0"].numpy(),
                                  got.numpy())


def test_core_exports_what_the_references_core_exports():
    public = {n for n in dir(ref_core) if not n.startswith("_")
              and not inspect.ismodule(getattr(ref_core, n))}
    missing = public - set(dir(port_core))
    assert not missing
    for name in ("StreamGraph", "StreamRegion", "chain_split_reason",
                 "effective_plane_tile", "effective_time_tile",
                 "lower_to_dataflow", "plane_split_reason", "TuneResult"):
        assert getattr(port_core, name).__module__.startswith("repro_torch.")
