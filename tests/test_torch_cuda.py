"""The CUDA kernels on the card, against their plain PyTorch versions:
the generated stencil kernels, and the sliding-window attention kernel
with the LM serving path that runs it.  Marked ``cuda``; each test skips where
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


# --------------------------------------------------------------------------
# sliding-window attention and the LM serving path
# --------------------------------------------------------------------------

# (B, S, H, KV, D, window): head dims 64/80/128/256, GQA, a window >= S, a
# last query tile that is not full, window 1, a head dim that is not a
# multiple of 16 (bf16 pads it to 48), D 256 with a ragged last tile
SWA_SHAPES = [
    (2, 256, 4, 4, 64, 64),
    (2, 512, 8, 2, 128, 256),
    (1, 256, 32, 8, 80, 96),
    (1, 128, 4, 4, 256, 512),
    (2, 200, 4, 1, 80, 4096),
    (1, 128, 2, 2, 64, 1),
    (1, 192, 8, 2, 40, 100),
    (1, 200, 4, 2, 256, 96),
]


def _swa_inputs(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((B, S, h, D)).astype(
        np.float32), device="cuda").to(getattr(torch, dtype))
        for h in (H, KV, KV)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,D,w", SWA_SHAPES)
def test_swa_kernel_matches_plain_version_on_the_card(B, S, H, KV, D, w,
                                                      dtype, tol):
    """The kernel against ``swa_plain`` on the same inputs, relative to the
    plain output's max abs (bf16: a few ulps of the rounded output)."""
    from repro_torch.kernels import swa

    _needs_card()
    q, k, v = _swa_inputs(B, S, H, KV, D, dtype, seed=S + D + w)
    before = swa.launches
    got = swa.swa_cuda(q, k, v, window=w)
    torch.cuda.synchronize()
    assert swa.launches == before + 1
    want = swa.swa_plain(q, k, v, window=w, q_block=128 if S % 128 == 0
                         else S)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _rel_err(got, want) <= tol


@pytest.mark.cuda
def test_swa_bf16_call_runs_the_tensor_core_library():
    """A bf16 call loads the library built from ``swa_mma.cu`` (its source
    holds ``mma.sync``; ptxas compiled ``swa_kernel_mma``) and launches it
    once; float32 stays on ``swa.cu``."""
    from repro_torch.kernels import build, swa

    _needs_card()
    q, k, v = _swa_inputs(1, 256, 8, 2, 80, "bfloat16", seed=5)
    before = swa.launches
    got = swa.swa_cuda(q, k, v, window=100)
    torch.cuda.synchronize()
    assert swa.launches == before + 1
    src = swa.kernel_source(torch.bfloat16, 80)
    assert "mma.sync" in src
    assert build.library_path(src, "swa").exists()
    assert "swa_kernel_mma" in build.ptxas_report(src, "swa")
    assert "mma.sync" not in swa.kernel_source(torch.float32, 80)
    assert _rel_err(got, swa.swa_plain(q, k, v, window=100)) <= 2e-2


@pytest.mark.cuda
def test_swa_kernel_reads_strided_inputs_on_the_card():
    """q as the transposed view of a (B,H,S,D) buffer, k and v as slices
    of one packed (B,S,2*KV,D) tensor: read through their strides."""
    from repro_torch.kernels import swa

    _needs_card()
    q, k, v = _swa_inputs(1, 256, 8, 2, 80, "float32", seed=4)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kv = torch.cat([k, v], dim=2)
    got = swa.swa_cuda(qt, kv[:, :, :2], kv[:, :, 2:], window=100)
    want = swa.swa_plain(q, k, v, window=100)
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_lm_prefill_runs_the_kernel_and_matches_the_cpu(dtype, tol):
    """The Danube smoke config (window 16) over a 64-token prompt: each
    local layer launches the kernel once, and the logits agree with the
    same model on the CPU (the torch slab path there)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import swa
    from repro_torch.models import init_lm, prefill

    _needs_card()
    cfg = dataclasses.replace(get_smoke("h2o_danube_1_8b"), dtype=dtype)
    lm = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)), device="cuda")
    before = swa.launches
    got, _ = prefill(cfg, lm, tokens, 80)
    torch.cuda.synchronize()
    assert swa.launches - before == cfg.n_layers
    want, _ = prefill(cfg, lm.cpu(), tokens.cpu(), 80)
    assert _rel_err(got.cpu(), want) <= tol


@pytest.mark.cuda
def test_lm_path_raises_when_the_kernel_cannot_build(monkeypatch, tmp_path):
    """No fallback: without nvcc the SWA layer raises on the card."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import build, swa
    from repro_torch.models import init_lm, prefill

    _needs_card()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path))
    monkeypatch.setattr(swa, "_FNS", {})
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    cfg = get_smoke("h2o_danube_1_8b")
    lm = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.zeros((2, 64), dtype=torch.long, device="cuda")
    before = swa.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        prefill(cfg, lm, tokens, 80)
    assert swa.launches == before
