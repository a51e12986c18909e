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
@pytest.mark.parametrize("app,boundary,dtype,tol,grid", [
    (pw_advection, "zero", "float32", 1e-5, (20, 18, 100)),
    (pw_advection, "periodic", "float32", 1e-5, (20, 18, 100)),
    (pw_advection, "zero", "bfloat16", 2e-2, (20, 18, 100)),
    (tracer_advection, "zero", "float32", 1e-5, (20, 18, 100)),
    (tracer_advection, "periodic", "float32", 1e-5, (20, 18, 100)),
    # axis 0 in four chunks (33, 33, 33, 31), ragged tiles on axes 1 and 2
    (tracer_advection, "zero", "float32", 1e-5, (130, 70, 100)),
    (tracer_advection, "periodic", "float32", 1e-5, (130, 70, 100)),
])
def test_kernel_matches_plain_version_on_the_card(app, boundary, dtype, tol,
                                                  grid):
    """(h) The generated kernel against its plain version on the card, on
    grids that are not tile multiples; tolerances are relative to each
    field's max abs (bfloat16: a few ulps)."""
    _needs_card()
    p = app(boundary)
    ex = compile_program(p, grid, dtype=dtype)
    call = ex.kernels[0]
    if grid[0] > 100:
        assert call.tiles[0] > 1 and grid[0] % call.block[0] \
            and grid[1] % call.block[1] and grid[2] % call.block[2]
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
def test_multi_group_plan_on_the_card():
    """tracer_advection split per field (a kernel a group, inter-group
    fields re-padded between them) against the plain backend on the
    card, to 1e-5 of each field's max abs."""
    _needs_card()
    p = tracer_advection()
    grid = (20, 18, 100)
    f, s, c = _inputs(p, grid)
    ex = compile_program(p, grid, strategy="per_field")
    assert len(ex.plan.groups) > 1
    before = stencil3d.launches
    got = ex(f, s, c)
    torch.cuda.synchronize()
    assert stencil3d.launches - before == len(ex.plan.groups)
    want = compile_program(p, grid, backend="torch_fused")(f, s, c)
    for k in want:
        assert _rel_err(got[k], want[k]) <= 1e-5, k


@pytest.mark.cuda
def test_float64_raises_on_the_card():
    _needs_card()
    p = pw_advection()
    grid = (8, 8, 32)
    ex = compile_program(p, grid, dtype="float64")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ex(*_inputs(p, grid))


def _stream_region_check(ex, p, grid, dtype, tol, copy_bytes=None):
    """Every sweep kernel of ``ex`` against its plain version on the card,
    on seeded inputs padded to the kernel's geometry (``copy_bytes``: the
    bytes each input's ``cp.async`` copies must move)."""
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
        if copy_bytes is not None:
            outs = {f: torch.empty((1,) + grid, dtype=tdt, device="cuda")
                    for f in call.group_outputs}
            sv = stencil3d.scalar_rows(svec, call.n_scalars, 1, "cuda")
            args = call.kernel_args(padded, sv, pc, None, None, outs)
            # each input's arguments: pointer, two strides, copy width,
            # batch stride
            assert [args[5 * k + 3] for k in range(len(call.group_inputs))] \
                == [copy_bytes] * len(call.group_inputs), call.region.ops
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
@pytest.mark.parametrize("boundary,dtype,grid,kw,tol", [
    ("zero", "float32", (20, 18, 254), {}, 1e-5),
    ("zero", "bfloat16", (20, 18, 254), {}, 2e-2),
    ("periodic", "float32", (20, 18, 126), {}, 1e-5),
    ("zero", "float32", (20, 18, 252), dict(steps=4, time_tile=2), 1e-4),
], ids=["zero", "bf16", "periodic", "T2"])
def test_stream_kernels_take_16_byte_copies_on_the_card(boundary, dtype,
                                                        grid, kw, tol):
    """pw_advection on grids whose padded rows are multiples of 16 bytes:
    every input window of every sweep kernel (a T=2 chain's T-fold window
    too) is fetched by 16-byte ``cp.async`` copies, and each kernel
    matches its plain version and the path the plain backend."""
    _needs_card()
    p = pw_advection(boundary)
    if "steps" in kw:
        kw = dict(kw, update=pw_advection_update(0.1))
    f, s, c = _inputs(p, grid)
    ex = compile_program(p, grid, dtype=dtype, schedule="stream", **kw)
    got = ex(f, s, c)
    base = {k: v for k, v in kw.items() if k in ("steps", "update")}
    want = compile_program(p, grid, dtype=dtype, backend="torch_fused",
                           **base)(f, s, c)
    for k in want:
        assert _rel_err(got[k], want[k]) <= tol, k
    _stream_region_check(ex, p, grid, dtype, tol, copy_bytes=16)


@pytest.mark.cuda
@pytest.mark.parametrize("app,fused", [(pw_advection, True),
                                       (tracer_advection, False)],
                         ids=["pw-loop", "tracer-single"])
def test_tuned_candidates_match_torch_fused_on_the_card(app, fused):
    """A tiny tune on the card that measures every candidate (each
    strategy's top planner tiles, every sweep T x P, both carry styles;
    all built by one build_many, timed by CUDA events): the search
    launches both generated kernels, and every candidate's executables
    (single step, and the fused loop with its carry style) match
    ``torch_fused``."""
    from repro_torch.core import PlanCache, TuneConfig, tune_plan
    from repro_torch.kernels import stream3d

    _needs_card()
    p = app()
    grid = (20, 18, 100)
    update = ((pw_advection_update(0.1) if app is pw_advection
               else tracer_advection_update()) if fused else None)
    stencil3d.launches = stream3d.launches = 0
    res = tune_plan(p, grid, update=update, cache=PlanCache(path=None),
                    config=TuneConfig(steps=4, max_measured=1000,
                                      repeats=1))
    assert res.record["measured"] == res.record["candidates"]
    assert stencil3d.launches > 0 and stream3d.launches > 0
    assert res.record["device"] == torch.cuda.get_device_name()
    assert res.measured[0].score() <= res.baseline.score()
    f, s, c = _inputs(p, grid)
    modes = [({}, 1e-5)] + ([(dict(steps=4, update=update), 1e-4)]
                            if fused else [])
    for kw, tol in modes:
        want = compile_program(p, grid, backend="torch_fused", **kw)(f, s, c)
        for cand in res.measured:
            cw = dict(carry_write=cand.carry_write) if kw else {}
            got = compile_program(p, grid, plan=cand.plan, **kw, **cw)(
                f, s, c)
            for k in want:
                assert _rel_err(got[k], want[k]) <= tol, (cand.label, k)


@pytest.mark.cuda
@pytest.mark.parametrize("app,strategy", [(pw_advection, "auto"),
                                          (tracer_advection, "auto"),
                                          (tracer_advection, "per_field")])
def test_every_planner_tile_on_the_card(app, strategy):
    """Every tile the block planner ranks (``schedule.feasible_blocks``:
    outer tiles 1 to 16, lane tiles 32, 64 and the ragged 100, each with
    its chunk) on a grid whose chunks leave ragged last CTAs, single step
    and a 3-step fused loop, against ``torch_fused``; all the sources
    built by one build_many first."""
    import dataclasses

    from repro_torch.core.schedule import feasible_blocks
    from repro_torch.kernels import build

    _needs_card()
    p = app()
    grid = (130, 70, 100)
    upd = (pw_advection_update(0.1) if app is pw_advection
           else tracer_advection_update())
    base = compile_program(p, grid, strategy=strategy).plan
    blocks = feasible_blocks(p, base.groups, grid, "float32", 232_448)
    assert {b[1] for b in blocks} >= {1, 2} and {b[2] for b in blocks} \
        >= {32, 64, 100}
    exes = []
    for blk in blocks:
        plan = dataclasses.replace(base, block=blk,
                                   groups=[list(g) for g in base.groups])
        exes.append((blk, {}, compile_program(p, grid, plan=plan)))
        exes.append((blk, dict(steps=3, update=upd), compile_program(
            p, grid, plan=plan, steps=3, update=upd,
            carry_write="inplace")))
    build.build_many([ex.kernels[0].module.source for _, _, ex in exes])
    f, s, c = _inputs(p, grid)
    wants = {}
    for blk, kw, ex in exes:
        key = tuple(kw)
        if key not in wants:
            wants[key] = compile_program(p, grid, backend="torch_fused",
                                         **kw)(f, s, c)
        before = stencil3d.launches
        got = ex(f, s, c)
        torch.cuda.synchronize()
        assert stencil3d.launches > before
        for k in wants[key]:
            assert _rel_err(got[k], wants[key][k]) <= (1e-4 if kw
                                                       else 1e-5), (blk, k)


@pytest.mark.cuda
def test_stream_float64_raises_on_the_card():
    _needs_card()
    p = pw_advection()
    grid = (8, 8, 32)
    ex = compile_program(p, grid, dtype="float64", schedule="stream")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        ex(*_inputs(p, grid))


# --------------------------------------------------------------------------
# the stencil serving engine
# --------------------------------------------------------------------------

def _served(app, grids, steps, seed=3, **engine):
    """Requests on ``grids`` (one bucket) served by one engine in one
    batch: (requests, results, what a warm repeat built: nvcc runs, kernel
    sources, and the engine's executor compiles in all; the bucket's
    executor with the batch's arguments)."""
    from repro_torch.kernels import build
    from repro_torch.serve import StencilEngine, StencilRequest

    upd = (pw_advection_update(0.1) if app is pw_advection
           else tracer_advection_update())
    reqs = []
    for i, g in enumerate(grids):
        p = app()
        f, s, c = _inputs(p, g, seed=seed + i)
        s = {k: v * (1 + 0.2 * i) for k, v in s.items()}
        kw = ({} if steps is None else
              dict(steps=steps, update=upd, update_key=app.__name__))
        reqs.append(StencilRequest(program=p, fields=f, scalars=s, coeffs=c,
                                   **kw))
    with StencilEngine(max_batch=len(grids), window_s=0.5, **engine) as eng:
        res = eng.map(reqs, timeout=600)
        runs, traces = build.runs, eng.stats.traces
        eng.map(reqs, timeout=600)
        warm = (build.runs - runs, eng.stats.traces - traces,
                eng.stats.compiles)
        key, fb, sb, cb = eng.batch_inputs(reqs)
        bex = eng.executor(key)
        batch = (bex, fb, sb, cb)
    return reqs, res, warm, batch


@pytest.mark.cuda
@pytest.mark.parametrize("app,steps,tol,grids", [
    (pw_advection, 4, 1e-4, [(20, 18, 100), (19, 17, 98), (18, 20, 104)]),
    (tracer_advection, None, 1e-5, [(20, 18, 100), (17, 19, 96)]),
])
def test_served_batch_matches_per_request_compile_on_the_card(app, steps,
                                                              tol, grids):
    """A served batch (one launch a kernel a step) against each request's
    own ``compile_program`` on its exact grid on the card; a warm repeat
    builds no kernel and compiles no executor."""
    _needs_card()
    reqs, res, warm, _ = _served(app, grids, steps)
    assert {r.batch_size for r in res} == {len(grids)}
    for r, out in zip(reqs, res):
        kw = ({} if steps is None else dict(steps=steps, update=r.update))
        want = compile_program(r.program, r.grid(), **kw)(
            r.fields, r.scalars, r.coeffs)
        for k in want:
            assert out.outputs[k].device.type == "cuda"
            assert _rel_err(out.outputs[k], want[k]) <= tol, k
    assert warm == (0, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "stream"])
def test_served_batch_is_bit_equal_to_batches_of_one(schedule):
    """The same source at every batch size: a batch of 3 through a bucket's
    executor equals 3 batches of 1 bit for bit, with as many launches."""
    _needs_card()
    from repro_torch.kernels import stream3d

    _, _, _, (bex, f, s, c) = _served(
        pw_advection, [(20, 18, 100), (19, 17, 98), (18, 20, 104)], 3,
        schedule=schedule)
    stencil3d.launches = stream3d.launches = 0
    out = bex.batched(f, s, c)
    torch.cuda.synchronize()
    n = stencil3d.launches + stream3d.launches
    assert n > 0
    for i in range(3):
        stencil3d.launches = stream3d.launches = 0
        one = bex.batched({k: v[i:i + 1] for k, v in f.items()},
                          {k: v[i:i + 1] for k, v in s.items()},
                          {k: v[i:i + 1] for k, v in c.items()})
        torch.cuda.synchronize()
        assert stencil3d.launches + stream3d.launches == n
        for k in out:
            assert torch.equal(out[k][i], one[k][0]), (i, k)


# --------------------------------------------------------------------------
# the distributed executor: shards stacked on one card
# --------------------------------------------------------------------------

def _card_mesh(shape, names):
    from repro_torch.dist import make_auto_mesh
    return make_auto_mesh(shape, names,
                          devices=["cuda:0"] * int(np.prod(shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("app,boundary,schedule,time_tile,steps,tol", [
    (pw_advection, "zero", "block", None, None, 1e-5),
    (pw_advection, "periodic", "block", None, 5, 1e-4),
    (tracer_advection, "zero", "block", None, 3, 1e-4),
    (pw_advection, "zero", "stream", None, None, 1e-5),
    (pw_advection, "zero", "stream", 2, 5, 1e-4),
    (tracer_advection, "zero", "stream", None, 2, 1e-4),
])
def test_mesh_on_one_card_matches_the_local_compile(app, boundary, schedule,
                                                    time_tile, steps, tol):
    """A (2,2) mesh of four shards on ``cuda:0`` (the stream axis cut, so
    the sweeps take the sharded ghost planes and a T=2 chain runs a
    remainder) against the local compile on the card: both generated
    kernels launch once a shard a kernel, at every shard origin."""
    _needs_card()
    from repro_torch.kernels import stream3d
    p = app(boundary)
    grid = (24, 20, 64)
    f, s, c = _inputs(p, grid)
    kw = dict(schedule=schedule, time_tile=time_tile)
    if steps:
        upd = (pw_advection_update(0.1) if app is pw_advection
               else tracer_advection_update())
        kw.update(steps=steps, update=upd)
    want = compile_program(p, grid, **kw)(f, s, c)
    ex = compile_program(p, grid, mesh=_card_mesh((2, 2), ("X", "Y")),
                         mesh_axes=("X", "Y", None), **kw)
    stencil3d.launches = stream3d.launches = 0
    got = ex(f, s, c)
    torch.cuda.synchronize()
    n = stencil3d.launches + stream3d.launches
    per = -(-(steps or 1) // (time_tile or 1)) if schedule == "stream" \
        else (steps or 1)
    assert n >= 4 * per and n % 4 == 0
    for k in want:
        assert got[k].device.type == "cuda"
        assert _rel_err(got[k], want[k]) <= tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,time_tile,steps", [
    ("block", None, None), ("block", None, 4), ("stream", 2, 5)])
def test_degenerate_mesh_is_bit_equal_on_the_card(schedule, time_tile,
                                                  steps):
    _needs_card()
    p = pw_advection()
    grid = (24, 20, 64)
    f, s, c = _inputs(p, grid)
    kw = dict(schedule=schedule, time_tile=time_tile)
    if steps:
        kw.update(steps=steps, update=pw_advection_update(0.1))
    want = compile_program(p, grid, **kw)(f, s, c)
    got = compile_program(p, grid, mesh=_card_mesh((1, 1, 1),
                                                   ("X", "Y", "Z")),
                          **kw)(f, s, c)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_make_auto_mesh_takes_one_card_a_shard():
    """Four shards need four cards: on fewer it raises rather than stack
    shards on one card or move them to the CPU."""
    _needs_card()
    from repro_torch.dist import make_auto_mesh
    n = torch.cuda.device_count()
    if n >= 4:
        mesh = make_auto_mesh((2, 2), ("X", "Y"))
        assert len(set(mesh.devices.flat)) == 4
    else:
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            make_auto_mesh((2, 2), ("X", "Y"))


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
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "hymba_1_5b",
                                  "xlstm_350m"])
def test_family_prefill_and_decode_match_the_cpu(arch):
    """The MoE, hybrid and xLSTM smoke configs in float32: a 64-token
    prefill (the kernel once a local layer past its window) and four
    decode steps (no kernel), the logits at 1e-4 of the same model on the
    CPU."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import swa
    from repro_torch.models import decode_step, init_lm, prefill

    _needs_card()
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    lm = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    lm_cpu = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    lm_cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    local = sum(cfg.layer_kind(i) == "local" for i in range(cfg.n_layers)
                if cfg.window)
    before = swa.launches
    got, cache = prefill(cfg, lm, tokens.cuda(), 80)
    torch.cuda.synchronize()
    assert swa.launches - before == local
    want, cache_cpu = prefill(cfg, lm_cpu, tokens, 80)
    for t in range(64, 68):
        assert _rel_err(got.cpu(), want) <= 1e-4, t
        tok = want.argmax(-1)
        got, cache = decode_step(cfg, lm, cache, tok.cuda(), t)
        want, cache_cpu = decode_step(cfg, lm_cpu, cache_cpu, tok, t)
    assert _rel_err(got.cpu(), want) <= 1e-4
    assert swa.launches - before == local


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


# the backward: Danube's layer shapes cut in length, a head dim that is
# not a multiple of 16 with a ragged tile, a window >= S, MQA, window 1
SWA_BWD_SHAPES = [
    (1, 512, 32, 8, 80, 96),
    (2, 200, 4, 2, 40, 64),
    (1, 130, 2, 1, 80, 500),
    (1, 256, 4, 1, 16, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,D,w", SWA_BWD_SHAPES)
def test_swa_backward_kernel_matches_plain_version_on_the_card(B, S, H, KV,
                                                               D, w, dtype,
                                                               tol):
    """The dtype's backward source (bf16 ``swa_bwd_mma.cu`` fed the
    forward's lse, float32 ``swa_bwd.cu``) against ``swa_plain_backward`` on
    the same inputs, each gradient relative to the dv of the plain
    version's scale where the window is 1 (dq and dk are then 0 up to
    rounding), else its own; the bf16 forward's lse against
    ``swa_plain_lse`` at 1e-4 relative."""
    from repro_torch.kernels import swa

    _needs_card()
    q, k, v = _swa_inputs(B, S, H, KV, D, dtype, seed=S + D + w)
    do = _swa_inputs(B, S, H, H, D, dtype, seed=w)[0]
    lse = None
    if dtype == "bfloat16":
        o, lse = swa.swa_cuda_lse(q, k, v, window=w)
        want_lse = swa.swa_plain_lse(q, k, window=w)
        assert float((lse - want_lse).abs().max()) <= \
            1e-4 * float(want_lse.abs().max())
    else:
        o = swa.swa_cuda(q, k, v, window=w)
    before = swa.backward_launches
    got = swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
    torch.cuda.synchronize()
    assert swa.backward_launches == before + 1
    want = swa.swa_plain_backward(q, k, v, do, window=w,
                                  q_block=128 if S % 128 == 0 else S)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    scale = float(want[2].float().abs().max())
    for g, wg in zip(got, want):
        ref = scale if w == 1 else float(wg.float().abs().max())
        assert float((g.float() - wg.float()).abs().max()) <= tol * ref


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    """One ``make_train_step`` step of the Danube smoke config in float32
    (S 64 > window 16: the SWA layers run the forward and backward
    kernels) against the same step on the CPU, from the same non-zero
    moments (so the update is smooth in the gradients): params at 1e-5 of
    each leaf's max abs, and the kernels launched once a layer each way."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.kernels import swa
    from repro_torch.models import init_lm
    from repro_torch.train import (OptConfig, TrainConfig, adamw_init,
                                   make_train_step)

    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("h2o_danube_1_8b"), dtype="float32")
    cpu = init_lm(cfg, torch.Generator().manual_seed(0),
                  "cpu").requires_grad_(True)
    card = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=1e-3, warmup_steps=0)))
    gen = torch.Generator().manual_seed(1)
    state = adamw_init(dict(cpu.named_parameters()))
    state["count"] += 5
    for t in state["mu"].values():
        t.copy_(torch.randn(t.shape, generator=gen) * 1e-2)
    for t in state["nu"].values():
        t.copy_(torch.randn(t.shape, generator=gen).square() * 1e-4 + 1e-6)
    out = {}
    for name, lm in (("cpu", cpu), ("cuda", card)):
        before = (swa.launches, swa.backward_launches)
        named = dict(lm.named_parameters())
        moved = {"mu": {k: t.to(name, copy=True)
                        for k, t in state["mu"].items()},
                 "nu": {k: t.to(name, copy=True)
                        for k, t in state["nu"].items()},
                 "count": state["count"].to(name)}
        step(lm, moved, torch.zeros(()),
             {k: v.to(name) for k, v in batch.items()})
        out[name] = ({k: p.detach().cpu() for k, p in named.items()},
                     swa.launches - before[0],
                     swa.backward_launches - before[1])
    assert out["cuda"][1:] == (cfg.n_layers, cfg.n_layers)
    assert out["cpu"][1:] == (0, 0)
    for k, p in out["cpu"][0].items():
        assert _rel_err(out["cuda"][0][k], p) <= 1e-5, k


SHARDED_RANKS = r'''
import contextlib, dataclasses, json, sys
from pathlib import Path
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def rank_main(rank, work):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.dist.host_staged import HostStagedCollectives
    from repro_torch.kernels import swa
    from repro_torch.launch.mesh import make_rules
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    nccl = torch.cuda.device_count() >= WORLD
    torch.cuda.set_device(rank if nccl else 0)
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"file://{work}/store", rank=rank,
                            world_size=WORLD)
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_smoke("h2o_danube_1_8b"), dtype="float32")
    data = SyntheticLM(BatchSpec(4, 64, cfg.vocab), seed=0)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=40),
                       ckpt_every=10**9, ckpt_dir=f"{work}/ck",
                       log_every=10**9)
    with (contextlib.nullcontext() if nccl else HostStagedCollectives()):
        swa.launches = swa.backward_launches = 0
        hist = Trainer(cfg, tcfg, data,
                       rules=make_rules(mesh, kind="train")).run(1)
        launches = [swa.launches, swa.backward_launches]
    out = {"sharded": hist, "launches": launches}
    if rank == 0:
        out["single"] = Trainer(cfg, tcfg, data).run(1)
    Path(f"{work}/rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=WORLD)
'''


@pytest.mark.cuda
def test_sharded_smoke_step_on_the_card(tmp_path):
    """One ``Trainer(rules=)`` step of the Danube smoke config in float32
    on 4 ranks of a (2, 2) mesh on the card (NCCL with a card a rank, else
    gloo staged through host memory), under the dry run's train rules:
    the loss and grad norm equal on every rank and within 1e-4 of the
    unsharded Trainer's on the card, and the float32 SWA kernels launched
    on every rank's shard (a forward and a backward a layer)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    _needs_card()
    script = tmp_path / "ranks.py"
    script.write_text(SHARDED_RANKS)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    want = ranks[0]["single"][0]
    for r in ranks:
        got = r["sharded"][0]
        assert got["loss"] == ranks[0]["sharded"][0]["loss"]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got,
                                                                 want)
        assert r["launches"] == [2, 2], r["launches"]
