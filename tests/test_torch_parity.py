"""Parity of the PyTorch port with the JAX reference on the CPU.

The same seeded numpy inputs go through the reference's
``compile_program`` (``jnp_naive``/``jnp_fused``, and ``pallas`` in
interpret mode as its own tests run it) and the port's (``torch_naive``/
``torch_fused``, and ``cuda`` with ``device="cpu"``: the kernel
orchestrator over each group kernel's plain PyTorch version).  Both paper
apps, zero and periodic boundaries, single step and the fused ``steps=``
loop with both carry-write styles.

Tolerances are the reference's own: 1e-4 for single-step backend parity
(``tests/test_backends_parity.py``) and 1e-5 for the fused loop
(``tests/test_fused_loop.py``).
"""

import functools

import numpy as np
import pytest
import torch

from repro.apps import pw_advection as ref_pw
from repro.apps import pw_advection_update as ref_pw_update
from repro.apps import tracer_advection as ref_tracer
from repro.apps import tracer_advection_update as ref_tracer_update
from repro.core import compile_program as ref_compile
from repro.core.schedule import plan_to_dict as ref_plan_to_dict
from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.interop import plan_from_reference

APPS = {
    "pw_advection": (ref_pw, pw_advection, lambda: ref_pw_update(0.1),
                     lambda: pw_advection_update(0.1)),
    "tracer_advection": (ref_tracer, tracer_advection, ref_tracer_update,
                         tracer_advection_update),
}
BOUNDARIES = ("zero", "periodic")


def app_data(name, grid, seed=0):
    """Seeded numpy inputs in the apps' physical ranges (``e3t`` >= 1,
    ``msk`` in {0, 1}), small enough that fused loops stay bounded."""
    rng = np.random.default_rng(seed)
    if name == "pw_advection":
        fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
                  for f in ("u", "v", "w")}
        scalars = {"tcx": np.float32(0.05), "tcy": np.float32(0.05)}
        coeffs = {c: np.linspace(0.9, 1.1, grid[2]).astype(np.float32)
                  for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
        return fields, scalars, coeffs
    fields = {
        "t": rng.normal(size=grid).astype(np.float32) + 15.0,
        "un": rng.normal(size=grid).astype(np.float32) * 0.2,
        "vn": rng.normal(size=grid).astype(np.float32) * 0.2,
        "wn": rng.normal(size=grid).astype(np.float32) * 0.05,
        "e3t": np.abs(rng.normal(size=grid)).astype(np.float32) + 1.0,
        "msk": (rng.uniform(size=grid) > 0.05).astype(np.float32),
    }
    scalars = {"rdt": np.float32(0.05), "zeps": np.float32(1e-6)}
    coeffs = {"ztfreez": rng.normal(size=(grid[2],)).astype(np.float32)}
    return fields, scalars, coeffs


@functools.lru_cache(maxsize=None)
def reference_result(name, boundary, grid, backend, steps=None):
    """The reference's outputs (single step) or final fields (``steps``),
    as numpy arrays; cached so each reference run happens once."""
    ref_app, _, ref_upd, _ = APPS[name]
    fields, scalars, coeffs = app_data(name, grid)
    kw = {} if steps is None else dict(steps=steps, update=ref_upd())
    ex = ref_compile(ref_app(boundary), grid, backend=backend, **kw)
    return {k: np.asarray(v) for k, v in ex(fields, scalars, coeffs).items()}


def port_result(name, boundary, grid, backend, steps=None, **kw):
    _, _, _, upd = APPS[name]
    fields, scalars, coeffs = app_data(name, grid)
    if steps is not None:
        kw.update(steps=steps, update=upd())
    ex = compile_program(APPS[name][1](boundary), grid, backend=backend,
                         device="cpu", **kw)
    return {k: v.numpy() for k, v in ex(fields, scalars, coeffs).items()}


def assert_close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=f"{what} field {k}")


GRIDS = [(8, 8, 32), (12, 10, 130)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
@pytest.mark.parametrize("mode", ["naive", "fused"])
def test_torch_lowering_matches_jnp(mode, name, boundary, grid):
    """(c) The port's plain lowerings against the reference's jnp ones."""
    want = reference_result(name, boundary, grid, f"jnp_{mode}")
    got = port_result(name, boundary, grid, f"torch_{mode}")
    assert_close(got, want, 1e-4, f"torch_{mode} {name}/{boundary}/{grid}")


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_kernel_backend_matches_pallas_single_step(name, boundary):
    """(d) The kernel orchestrator (plain group versions on the CPU)
    against the reference's Pallas kernels in interpret mode."""
    grid = (8, 8, 32)
    want = reference_result(name, boundary, grid, "pallas")
    got = port_result(name, boundary, grid, "cuda")
    assert_close(got, want, 1e-4, f"cuda {name}/{boundary}")


@pytest.mark.parametrize("carry_write", ["repad", "inplace"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_kernel_backend_matches_pallas_fused_loop(name, boundary,
                                                  carry_write):
    """(d) ``steps=4`` fused loops, both carry-write styles, against the
    reference's Pallas fused loop."""
    grid = (6, 8, 32)
    want = reference_result(name, boundary, grid, "pallas", steps=4)
    got = port_result(name, boundary, grid, "cuda", steps=4,
                      carry_write=carry_write)
    assert_close(got, want, 1e-5, f"cuda steps=4 {name}/{boundary}/"
                                  f"{carry_write}")


@pytest.mark.parametrize("name", sorted(APPS))
def test_torch_fused_loop_matches_jnp_fused_loop(name):
    """The port's oracle loop against the reference's ``jnp_fused`` loop."""
    grid = (6, 8, 32)
    want = reference_result(name, "zero", grid, "jnp_fused", steps=4)
    got = port_result(name, "zero", grid, "torch_fused", steps=4)
    assert_close(got, want, 1e-5, f"torch_fused steps=4 {name}")


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", sorted(APPS))
def test_reference_plan_compiles_in_the_port(name, boundary):
    """(f) A plan written by the reference's planner compiles here and gives
    the reference's outputs."""
    from repro.core.schedule import auto_plan as ref_auto_plan

    grid = (12, 10, 130)
    ref_app = APPS[name][0]
    ref_plan = ref_auto_plan(ref_app(boundary), grid)
    plan = plan_from_reference(ref_plan_to_dict(ref_plan),
                               APPS[name][1](boundary), grid)
    assert plan.groups == [list(g) for g in ref_plan.groups]
    assert plan.backend == "cuda"
    want = reference_result(name, boundary, grid, "jnp_naive")
    got = port_result(name, boundary, grid, "cuda", plan=plan)
    assert_close(got, want, 1e-4, f"reference plan {name}/{boundary}")


def test_bfloat16_kernel_backend_within_reference_tolerance():
    """bfloat16 through the kernel orchestrator against the float32
    reference, as the reference's own bf16 test runs it
    (``tests/test_kernels.py``): unit-scale ``make_data`` inputs, seed 5,
    its grids, atol = rtol = 0.2."""
    from strategies import make_data

    for grid in [(8, 8, 64), (16, 4, 128), (5, 9, 130)]:
        fields, scalars, coeffs = make_data(ref_pw(), grid, seed=5)
        want = ref_compile(ref_pw(), grid, backend="jnp_naive")(
            fields, scalars, coeffs)
        ex = compile_program(pw_advection(), grid, dtype="bfloat16",
                             device="cpu")
        got = ex(fields, scalars, coeffs)
        for k in want:
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k]), atol=0.2,
                                       rtol=0.2, err_msg=f"{grid} {k}")


def _sweep_program(builder_cls, ndim):
    """The odd-grid sweep program of ``tests/test_backends_parity.py``,
    built with either package's builder."""
    b = builder_cls("sweep", ndim=ndim)
    x = b.input("x")
    o = b.output("o")
    z = (0,) * ndim
    off1 = tuple(1 if i == 0 else 0 for i in range(ndim))
    off2 = tuple(-1 if i == ndim - 1 else 0 for i in range(ndim))
    b.define(o, x[z] * 2.0 + x[off1] - x[off2])
    return b.build()


@pytest.mark.parametrize("grid", [(32,), (65,), (8, 48), (9, 130),
                                  (4, 6, 64), (5, 7, 96)])
def test_shape_sweep_odd_grids(grid):
    """1-D, 2-D and 3-D grids that are not tile multiples, every port
    backend against the reference's ``jnp_naive`` at 1e-4."""
    from repro.core.frontend import ProgramBuilder as RefBuilder
    from repro_torch.core.frontend import ProgramBuilder

    x = np.random.default_rng(2).normal(size=grid).astype(np.float32)
    want = ref_compile(_sweep_program(RefBuilder, len(grid)), grid,
                       backend="jnp_naive")({"x": x})
    p = _sweep_program(ProgramBuilder, len(grid))
    for backend in ("torch_naive", "torch_fused", "cuda"):
        got = compile_program(p, grid, backend=backend, device="cpu")({"x": x})
        np.testing.assert_allclose(got["o"].numpy(), np.asarray(want["o"]),
                                   atol=1e-4, rtol=1e-4, err_msg=backend)
