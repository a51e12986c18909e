"""The generated kernels on the card, against their plain PyTorch
versions.  Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is false.  This file imports only the port,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.kernels import stencil3d


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel_err(got, want):
    """Max abs difference over ``want``'s own max abs (no floor)."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / float(w.abs().max())


def _inputs(p, grid, seed=1):
    rng = np.random.default_rng(seed)
    f = {k: rng.normal(size=grid).astype(np.float32) * 0.1 for k in
         p.input_fields()}
    if "e3t" in f:
        f["e3t"] = np.abs(f["e3t"]) + 1
    if "msk" in f:
        f["msk"] = (f["msk"] > 0).astype(np.float32)
    s = {k: 0.1 for k in p.scalars}
    c = {k: rng.normal(size=grid[a]).astype(np.float32)
         for k, a in p.coeffs.items()}
    return f, s, c


@pytest.mark.cuda
@pytest.mark.parametrize("app,boundary,dtype,tol", [
    (pw_advection, "zero", "float32", 1e-5),
    (pw_advection, "periodic", "float32", 1e-5),
    (pw_advection, "zero", "bfloat16", 2e-2),
    (tracer_advection, "zero", "float32", 1e-5),
    (tracer_advection, "periodic", "float32", 1e-5),
])
def test_kernel_matches_plain_version_on_the_card(app, boundary, dtype, tol):
    """(h) The generated kernel against its plain version on the card, on
    a grid that is not a tile multiple; tolerances are relative to each
    field's max abs (bfloat16: a few ulps)."""
    _needs_card()
    p = app(boundary)
    grid = (20, 18, 100)
    ex = compile_program(p, grid, dtype=dtype)
    f, s, c = _inputs(p, grid)
    before = stencil3d.launches
    got = ex(f, s, c)
    torch.cuda.synchronize()
    assert stencil3d.launches > before
    want = compile_program(p, grid, dtype=dtype, backend="torch_fused")(
        f, s, c)
    for k in want:
        assert _rel_err(got[k], want[k]) <= tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("carry_write", ["repad", "inplace"])
@pytest.mark.parametrize("app,update", [
    (pw_advection, lambda: pw_advection_update(0.1)),
    (tracer_advection, tracer_advection_update),
])
def test_fused_loop_on_the_card_matches_torch_fused(app, update,
                                                    carry_write):
    """The fused loop reads windows out of its carries through a base
    offset; 4 steps against the plain backend on the card, to 1e-4."""
    _needs_card()
    p = app()
    grid = (20, 18, 100)
    f, s, c = _inputs(p, grid)
    before = stencil3d.launches
    got = compile_program(p, grid, steps=4, update=update(),
                          carry_write=carry_write)(f, s, c)
    torch.cuda.synchronize()
    assert stencil3d.launches - before == 4
    want = compile_program(p, grid, steps=4, update=update(),
                           backend="torch_fused")(f, s, c)
    for k in want:
        assert _rel_err(got[k], want[k]) <= 1e-4, k


@pytest.mark.cuda
def test_float64_raises_on_the_card():
    _needs_card()
    p = pw_advection()
    grid = (8, 8, 32)
    ex = compile_program(p, grid, dtype="float64")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ex(*_inputs(p, grid))


def _stream_region_check(ex, p, grid, dtype, tol):
    """Every sweep kernel of ``ex`` against its plain version on the card,
    on seeded inputs padded to the kernel's geometry."""
    from repro_torch.core import boundary as bc
    from repro_torch.kernels.stream3d import stream_call_reference

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    bnd = p.boundaries()
    for call in ex.kernels:
        padded = {f: bc.pad_field(torch.as_tensor(
            rng.normal(size=grid).astype(np.float32) * 0.1, device="cuda"
        ).to(tdt), call.pad_lo, call.pad_hi, bnd.get(f, "zero")).contiguous()
            for f in call.group_inputs}
        pc = {c: bc.pad_coeff(torch.as_tensor(
            rng.normal(size=grid[call.coeff_axis[c]]).astype(np.float32),
            device="cuda").to(tdt), call.pad_lo[call.coeff_axis[c]],
            call.pad_hi[call.coeff_axis[c]], bc.coeff_mode(p)).contiguous()
            for c in call.group_coeffs}
        svec = [0.1] * len(p.scalars)
        got = call(padded, svec, pc)
        want = stream_call_reference(call, padded, svec, pc)
        for k in want:
            assert _rel_err(got[k], want[k]) <= tol, (call.region.ops, k)


@pytest.mark.cuda
@pytest.mark.parametrize("app,boundary,dtype,kw,tol", [
    (pw_advection, "zero", "float32", {}, 1e-5),
    (pw_advection, "periodic", "float32", {}, 1e-5),
    (pw_advection, "zero", "float32", dict(plane_tile=2), 1e-5),
    (pw_advection, "zero", "bfloat16", {}, 2e-2),
    (pw_advection, "zero", "float32", dict(steps=5, time_tile=2), 1e-4),
    (pw_advection, "zero", "float32", dict(steps=6, time_tile=4), 1e-4),
    (tracer_advection, "zero", "float32", {}, 1e-5),
    (tracer_advection, "periodic", "float32", {}, 1e-5),
    (tracer_advection, "zero", "float32", dict(steps=3), 1e-4),
], ids=["pw-zero", "pw-periodic", "pw-P2", "pw-bf16", "pw-T2-rem",
        "pw-T4-rem", "tracer-zero", "tracer-periodic", "tracer-fused"])
def test_stream_kernels_on_the_card(app, boundary, dtype, kw, tol):
    """The sweep kernels on the card: the stream path against the plain
    backend and against the block path, and each region's kernel (a
    chain's remainder epilogue included) against its plain version, on a
    grid that is not a tile multiple."""
    from repro_torch.kernels import stream3d

    _needs_card()
    p = app(boundary)
    grid = (20, 18, 100)
    if "steps" in kw:
        kw = dict(kw, update=(pw_advection_update(0.1) if app is pw_advection
                              else tracer_advection_update()))
    f, s, c = _inputs(p, grid)
    ex = compile_program(p, grid, dtype=dtype, schedule="stream", **kw)
    before = stream3d.launches
    got = ex(f, s, c)
    torch.cuda.synchronize()
    assert stream3d.launches > before
    base = {k: v for k, v in kw.items() if k in ("steps", "update")}
    for backend in ("torch_fused", "cuda"):
        want = compile_program(p, grid, dtype=dtype, backend=backend,
                               **base)(f, s, c)
        for k in want:
            assert _rel_err(got[k], want[k]) <= tol, (backend, k)
    _stream_region_check(ex, p, grid, dtype, tol)


@pytest.mark.cuda
def test_stream_float64_raises_on_the_card():
    _needs_card()
    p = pw_advection()
    grid = (8, 8, 32)
    ex = compile_program(p, grid, dtype="float64", schedule="stream")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ex(*_inputs(p, grid))
