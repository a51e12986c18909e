"""The port's stencil serving engine (``repro_torch.serve``) on the CPU,
against the JAX package's (``repro.serve``).

The same requests, made from a seed with numpy, go through the port's
``StencilEngine(device="cpu")`` (the kernels' plain versions, batched) and
the reference's ``StencilEngine(backend="pallas", interpret=True)``; the
bucket helpers and the refresh are held against the reference's at the
same quantum; the engine's behaviours are those of ``tests/test_serve.py``.
Tolerances are the reference serving tests' (atol/rtol 1e-5).
"""

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as ref_hw
from repro.apps.advection import pw_advection as ref_pw
from repro.apps.advection import pw_advection_update as ref_pw_update
from repro.apps.advection import tracer_advection as ref_tracer
from repro.core.pipeline import compile_program as ref_compile
from repro.core.schedule import bucket_for as ref_bucket_for
from repro.core.schedule import program_reach as ref_program_reach
from repro.core.schedule import quantize_extent as ref_quantize_extent
from repro.serve import StencilEngine as RefEngine
from repro.serve import StencilRequest as RefRequest
from repro.serve import make_refresh as ref_make_refresh
from repro.serve import serving_program as ref_serving_program
from repro_torch import hw
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection)
from repro_torch.core import CompileOptions, batched_executable
from repro_torch.core.pipeline import compile_program
from repro_torch.core.schedule import (PLAN_SCHEMA_VERSION, bucket_for,
                                       program_reach, quantize_extent)
from repro_torch.core.tune import (PlanCache, make_serve_record,
                                   read_serve_record)
from repro_torch.kernels import stencil3d
from repro_torch.serve import (StencilEngine, StencilRequest, crop,
                               embed_coeff, embed_field, make_refresh,
                               serving_program, size_scalar_names)

TOL = dict(atol=1e-5, rtol=1e-5)


def make_data(p, grid, seed=0):
    rng = np.random.default_rng(seed)
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in p.input_fields()}
    if "e3t" in fields:
        fields["e3t"] = np.abs(fields["e3t"]) + 1.0
        fields["msk"] = (fields["msk"] > 0).astype(np.float32)
        fields["t"] += 15.0
    scalars = {s: float(rng.uniform(0.02, 0.08)) for s in p.scalars}
    coeffs = {c: (np.abs(rng.normal(size=(grid[ax],))) + 0.5
                  ).astype(np.float32)
              for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


def port_request(grid, boundary="zero", seed=0, steps=3, dt=0.01,
                 timeout=None):
    p = pw_advection(boundary)
    f, s, c = make_data(p, grid, seed)
    kw = ({} if steps is None else
          dict(steps=steps, update=pw_advection_update(dt),
               update_key=f"pw/dt={dt}"))
    return StencilRequest(program=p, fields=f, scalars=s, coeffs=c,
                          timeout=timeout, **kw)


def ref_request(req):
    """The reference's request carrying the same arrays."""
    p = ref_pw(req.program.boundaries()["u"])
    kw = ({} if req.steps is None else
          dict(steps=req.steps, update=ref_pw_update(0.01),
               update_key="pw/dt=0.01"))
    return RefRequest(program=p, fields=req.fields, scalars=req.scalars,
                      coeffs=req.coeffs, **kw)


def direct(req, grid=None):
    """The port's own compile of the request's exact grid (plain
    versions on the CPU)."""
    kw = ({} if req.steps is None else
          dict(steps=req.steps, update=req.update))
    return compile_program(req.program, grid or req.grid(), device="cpu",
                           **kw)(req.fields, req.scalars, req.coeffs)


def assert_outputs(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **TOL)


def engine(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("window_s", 0.0)
    return StencilEngine(**kw)


# --------------------------------------------------------------------------
# the port's engine against the reference's Pallas engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_fused_loop_matches_reference_pallas_engine(boundary):
    req = port_request((6, 7, 12), boundary, seed=3)
    with engine() as eng:
        got = eng.run(req, timeout=300)
    with RefEngine(backend="pallas", interpret=True, window_s=0.0) as ref:
        want = ref.run(ref_request(req), timeout=300)
    assert (got.bucket.bucket, got.bucket.offset) == \
        (want.bucket.bucket, want.bucket.offset)
    assert_outputs(got.outputs, want.outputs)


def test_single_apply_matches_reference_pallas_engine():
    req = port_request((5, 9, 14), "periodic", seed=11, steps=None)
    with engine() as eng:
        got = eng.run(req, timeout=300)
    with RefEngine(backend="pallas", interpret=True, window_s=0.0) as ref:
        want = ref.run(ref_request(req), timeout=300)
    assert_outputs(got.outputs, want.outputs)


def test_mixed_shape_batch_matches_reference_pallas_engine():
    """Three grids of one bucket in one batch, padded to four."""
    grids = [(8, 8, 16), (7, 7, 15), (7, 8, 18)]
    reqs = [port_request(g, seed=i) for i, g in enumerate(grids)]
    eng = engine(window_s=0.5, max_batch=4, autostart=False)
    ref = RefEngine(backend="pallas", interpret=True, window_s=0.5,
                    max_batch=4, autostart=False)
    futs = [eng.submit(r) for r in reqs]
    rfuts = [ref.submit(ref_request(r)) for r in reqs]
    eng.start()
    ref.start()
    try:
        got = [f.result(300) for f in futs]
        want = [f.result(300) for f in rfuts]
    finally:
        eng.close()
        ref.close()
    assert {r.batch_size for r in got} == {3}
    assert eng.stats.batches == 1 and eng.stats.padded_slots == 1
    for g, w in zip(got, want):
        assert_outputs(g.outputs, w.outputs)


@pytest.mark.parametrize("steps", [None, 2])
def test_tracer_served_as_on_its_exact_grid(steps):
    """tracer_advection's zero-boundary temps read as 0 outside each
    request's real domain, so a served answer is its exact grid's (the
    reference's Pallas compile of that grid) — where the reference engine,
    computing temps over the whole bucket, is off by about 5e-3."""
    p = tracer_advection()
    grid = (9, 7, 22)
    f, s, c = make_data(p, grid, seed=5)
    kw = ({} if steps is None else
          dict(steps=steps, update=lambda fl, out: dict(fl, t=out["ta"]),
               update_key="tracer"))
    with engine() as eng:
        got = eng.run(StencilRequest(program=p, fields=f, scalars=s,
                                     coeffs=c, **kw), timeout=300)
    ref_kw = ({} if steps is None else
              dict(steps=steps, update=lambda fl, out: dict(fl, t=out["ta"])))
    want = ref_compile(ref_tracer(), grid, backend="pallas", interpret=True,
                       **ref_kw)(f, s, c)
    assert_outputs(got.outputs, want)


# --------------------------------------------------------------------------
# bucketing units against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lane", [ref_hw.LANE, hw.BUCKET_LANE])
def test_bucket_helpers_equal_reference(lane):
    for n in (1, 3, 17, 31, 32, 33, 64, 100, 127, 128, 129, 250):
        for lane_axis in (False, True):
            assert quantize_extent(n, lane_axis=lane_axis, lane=lane) == \
                ref_quantize_extent(n, lane_axis=lane_axis, lane=lane)
    for port_app, app in ((pw_advection, ref_pw),
                          (tracer_advection, ref_tracer)):
        for boundary in ("zero", "periodic"):
            p, rp = port_app(boundary), app(boundary)
            np.testing.assert_array_equal(program_reach(p),
                                          ref_program_reach(rp))
            for grid in [(5, 6, 9), (8, 8, 16), (30, 31, 127),
                         (254, 230, 126)]:
                a = bucket_for(serving_program(p), grid, lane=lane)
                b = ref_bucket_for(ref_serving_program(rp), grid, lane=lane)
                assert (a.grid, a.bucket, a.offset) == \
                    (b.grid, b.bucket, b.offset)


def test_bucket_quantum_is_a_line_of_float32():
    """The contiguous axis rounds to 32 elements (a 128-byte line) on the
    card, where the reference rounds to the TPU's 128 lanes."""
    p = serving_program(pw_advection())
    assert bucket_for(p, (254, 230, 126)).bucket == (256, 256, 128)
    assert bucket_for(p, (190, 160, 94)).bucket == (192, 192, 96)
    assert bucket_for(p, (10, 12, 70)).bucket[-1] % hw.BUCKET_LANE == 0


def test_serving_program_appends_size_scalars_idempotently():
    p = pw_advection()
    sp = serving_program(p)
    assert sp.scalars == p.scalars + size_scalar_names(3)
    assert sp.scalars == ref_serving_program(ref_pw()).scalars
    assert serving_program(sp) is sp
    assert p.scalars == ["tcx", "tcy"]


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_embed_crop_round_trip(boundary):
    from repro.serve import embed_coeff as ref_embed_coeff
    from repro.serve import embed_field as ref_embed_field

    p = pw_advection()
    spec = bucket_for(p, (5, 6, 9))
    x = np.random.default_rng(7).normal(size=(5, 6, 9)).astype(np.float32)
    e = embed_field(x, spec, boundary)
    assert e.shape == spec.bucket
    np.testing.assert_array_equal(crop(e, spec), x)
    np.testing.assert_array_equal(e, ref_embed_field(x, spec, boundary))
    c = np.arange(9, dtype=np.float32) + 1
    ec = embed_coeff(c, 2, spec, boundary)
    np.testing.assert_array_equal(ec[spec.offset[2]:spec.offset[2] + 9], c)
    np.testing.assert_array_equal(ec, ref_embed_coeff(c, 2, spec, boundary))
    if boundary == "zero":
        e[spec.interior()] = 0
        assert not e.any()


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_refresh_matches_reference_with_sizes_per_element(boundary):
    """The batched refresh (a (B, bucket_a) gather index or mask an axis)
    against the reference's under ``jax.vmap``, on a batch whose real grid
    sizes differ per element."""
    p = serving_program(pw_advection(boundary))
    rp = ref_serving_program(ref_pw(boundary))
    spec = bucket_for(p, (6, 7, 12))
    sizes = np.array([[6, 7, 12], [5, 5, 9], [3, 7, 14]], np.float32)
    rng = np.random.default_rng(2)
    fields = {f: rng.normal(size=(3,) + spec.bucket).astype(np.float32)
              for f in ("u", "v", "w")}
    names = size_scalar_names(3)
    scal = {n: sizes[:, a] for a, n in enumerate(names)}
    got = make_refresh(p, spec)(
        {f: torch.as_tensor(x) for f, x in fields.items()},
        {n: torch.as_tensor(v).reshape(3, 1, 1, 1) for n, v in scal.items()})
    ref = ref_make_refresh(rp, spec)
    want = jax.vmap(lambda f, s: ref(f, s))(
        {f: jnp.asarray(x) for f, x in fields.items()},
        {n: jnp.asarray(v) for n, v in scal.items()})
    for f in fields:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


# --------------------------------------------------------------------------
# the batched executable
# --------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_pads_apply_to_the_grid_axes_of_a_batch(boundary):
    """``pad_field`` and ``pad_coeff`` on a leading batch axis pad (or wrap)
    each element as they pad it alone."""
    from repro_torch.core import boundary as bc

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(3, 4, 5, 6)).astype(np.float32))
    got = bc.pad_field(x, (1, 2, 0), (2, 1, 3), boundary, align_hi=(0, 1, 2))
    c = torch.as_tensor(rng.normal(size=(3, 6)).astype(np.float32))
    gotc = bc.pad_coeff(c, 2, 3, boundary)
    for b in range(3):
        assert torch.equal(got[b], bc.pad_field(x[b], (1, 2, 0), (2, 1, 3),
                                                boundary, align_hi=(0, 1, 2)))
        assert torch.equal(gotc[b], bc.pad_coeff(c[b], 2, 3, boundary))


@pytest.mark.parametrize("backend,schedule", [("cuda", "block"),
                                              ("cuda", "stream"),
                                              ("torch_fused", None)])
def test_batched_executable_equals_its_elements(backend, schedule):
    """A batch through the batched form equals each element run alone
    (the same plain versions on the CPU: bitwise), scalars and
    coefficients per element."""
    p = serving_program(pw_advection())
    grid = (8, 8, 32)
    rng = np.random.default_rng(4)
    B = 3
    f = {k: rng.normal(size=(B,) + grid).astype(np.float32)
         for k in p.input_fields()}
    s = {k: rng.uniform(0.05, 0.1, size=B).astype(np.float32)
         for k in p.scalars[:2]}
    s.update({n: np.array([6, 5, 7], np.float32) - a
              for a, n in enumerate(size_scalar_names(3))})
    c = {k: rng.normal(size=(B, grid[a])).astype(np.float32)
         for k, a in p.coeffs.items()}
    ex = compile_program(p, grid, device="cpu", backend=backend,
                         schedule=schedule, steps=2,
                         update=pw_advection_update(0.1))
    got = batched_executable(ex)(f, s, c)
    for i in range(B):
        one = ex({k: v[i] for k, v in f.items()},
                 {k: v[i] for k, v in s.items()},
                 {k: v[i] for k, v in c.items()})
        for k in one:
            assert torch.equal(got[k][i], one[k])


# --------------------------------------------------------------------------
# engine behaviours (those of tests/test_serve.py that carry over)
# --------------------------------------------------------------------------

def test_warm_requests_build_no_kernel():
    with engine() as eng:
        eng.run(port_request((8, 8, 16), seed=0), timeout=300)
        assert eng.stats.traces == 1 and eng.stats.compiles == 1
        eng.run(port_request((8, 8, 16), seed=1), timeout=300)
        eng.run(port_request((7, 8, 18), seed=2), timeout=300)
        assert eng.stats.traces == 1, "a warm request built a kernel"
        assert eng.stats.compiles == 1
        assert eng.stats.exec_hits == 2 and eng.stats.exec_misses == 1


def test_distinct_buckets_get_distinct_executors():
    with engine() as eng:
        eng.run(port_request((8, 8, 16)), timeout=300)
        eng.run(port_request((8, 8, 40)), timeout=300)
        assert eng.stats.compiles == 2


def test_boundary_override_on_request():
    req = port_request((6, 6, 12), seed=5)
    req.boundary = "periodic"
    with engine() as eng:
        got = eng.run(req, timeout=300)
    want = compile_program(pw_advection("periodic"), (6, 6, 12),
                           device="cpu", steps=3, update=req.update)(
        req.fields, req.scalars, req.coeffs)
    assert_outputs(got.outputs, want)


def test_mixed_shape_traffic_end_to_end():
    grids = [(8, 8, 16), (6, 7, 14), (8, 8, 24), (5, 8, 16), (8, 8, 16)]
    reqs = [port_request(g, "periodic", seed=10 + i)
            for i, g in enumerate(grids)]
    with engine(window_s=0.05, max_batch=4) as eng:
        results = eng.map(reqs, timeout=300)
        for req, res in zip(reqs, results):
            assert_outputs(res.outputs, direct(req))
        s = eng.stats
        assert s.completed == len(grids) and s.failed == 0
        assert s.throughput() > 0 and s.p99_ms() >= s.p50_ms() > 0


def test_bounded_queue_backpressure():
    eng = engine(queue_depth=2, autostart=False)
    eng.submit(port_request((8, 8, 16)))
    eng.submit(port_request((8, 8, 16)))
    with pytest.raises(queue.Full):
        eng.submit(port_request((8, 8, 16)))
    eng.close()
    assert eng.stats.failed == 2               # drained on close


def test_request_timeout_expires_in_queue():
    eng = engine(autostart=False)
    fut = eng.submit(port_request((8, 8, 16), timeout=0.01))
    time.sleep(0.05)
    eng.start()
    try:
        with pytest.raises(TimeoutError):
            fut.result(60)
        assert eng.stats.timeouts == 1
    finally:
        eng.close()


def test_submit_validation():
    p = pw_advection()
    eng = engine(autostart=False)
    f, s, c = make_data(p, (8, 8, 16))
    with pytest.raises(ValueError, match="steps and update"):
        eng.submit(StencilRequest(program=p, fields=f, scalars=s, coeffs=c,
                                  steps=3))
    with pytest.raises(ValueError, match="missing input fields"):
        eng.submit(StencilRequest(program=p, fields={"u": f["u"]},
                                  scalars=s, coeffs=c))
    with pytest.raises(ValueError, match="missing scalars"):
        eng.submit(StencilRequest(program=p, fields=f, coeffs=c))
    eng.close()


def test_serve_record_reused_across_engines(tmp_path):
    path = str(tmp_path / "plans.json")
    with engine(plan_cache=PlanCache(path)) as a:
        ra = a.run(port_request((8, 8, 16)), timeout=300)
        assert a.stats.plan_misses == 1 and a.stats.plan_hits == 0
    with engine(plan_cache=PlanCache(path)) as b:
        rb = b.run(port_request((8, 8, 16)), timeout=300)
        assert b.stats.plan_hits == 1 and b.stats.plan_misses == 0
    for k in ra.outputs:
        assert torch.equal(ra.outputs[k], rb.outputs[k])


def test_stale_schema_serve_record_misses_cleanly(tmp_path):
    cache = PlanCache(str(tmp_path / "plans.json"))
    req = port_request((8, 8, 16))
    eng = engine(plan_cache=cache, autostart=False)
    sp, spec, key = eng.describe(req)
    ex = compile_program(sp, spec.bucket, device="cpu")
    rec = make_serve_record(ex.plan, "repad", spec.bucket, req.steps)
    assert read_serve_record(rec) is not None
    rec["schema"] = PLAN_SCHEMA_VERSION - 1          # written by an old build
    assert read_serve_record(rec) is None
    cache.store(key, rec)
    eng.start()
    try:
        res = eng.run(port_request((8, 8, 16)), timeout=300)
        assert eng.stats.plan_misses == 1 and eng.stats.plan_hits == 0
        assert_outputs(res.outputs, direct(req))
        assert read_serve_record(cache.lookup(key)) is not None
    finally:
        eng.close()


def test_executor_lru_evicts_coldest():
    grids = [(8, 8, 16), (8, 8, 40), (8, 8, 70)]      # three buckets
    with engine(max_executors=2) as eng:
        eng.run(port_request(grids[0]), timeout=300)
        eng.run(port_request(grids[1]), timeout=300)
        assert eng.stats.evictions == 0 and len(eng._executors) == 2
        eng.run(port_request(grids[0], seed=1), timeout=300)
        eng.run(port_request(grids[2]), timeout=300)
        assert eng.stats.evictions == 1 and len(eng._executors) == 2
        misses = eng.stats.exec_misses
        eng.run(port_request(grids[0], seed=2), timeout=300)
        assert eng.stats.exec_misses == misses
        eng.run(port_request(grids[1], seed=1), timeout=300)
        assert eng.stats.exec_misses == misses + 1
        assert eng.stats.snapshot()["evictions"] == 2


def test_engine_accepts_compile_options():
    eng = StencilEngine(options=CompileOptions(schedule="block",
                                               device="cpu"),
                        autostart=False)
    assert eng.schedule == "block" and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="dtype"):
        StencilEngine(dtype="bfloat16", device="cpu",
                      options=CompileOptions(dtype="float64"),
                      autostart=False)


MESH_REFERENCE = r"""
import sys
import numpy as np
import jax
from repro.apps.advection import pw_advection, pw_advection_update
from repro.dist.sharding import make_auto_mesh
from repro.serve import StencilEngine, StencilRequest

assert jax.device_count() == 4
d = np.load(sys.argv[1])
mesh = make_auto_mesh((2, 2), ("X", "Y"))
out = {}
with StencilEngine(backend="pallas", interpret=True, window_s=0.0,
                   lane=int(d["lane"]), mesh=mesh,
                   mesh_axes=("X", "Y", None)) as eng:
    for name, boundary, steps in (("fused", "zero", 3),
                                  ("single", "periodic", None)):
        part = lambda kind: {k.split("/")[2]: d[k] for k in d.files
                             if k.startswith(f"{name}/{kind}/")}
        kw = ({} if steps is None else
              dict(steps=steps, update=pw_advection_update(0.01),
                   update_key="pw/dt=0.01"))
        res = eng.run(StencilRequest(
            program=pw_advection(boundary), fields=part("f"),
            scalars={k: float(v) for k, v in part("s").items()},
            coeffs=part("c"), **kw), timeout=600)
        for k, v in res.outputs.items():
            out[f"{name}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def cpu_mesh(shape, names):
    from repro_torch.dist import make_auto_mesh
    return make_auto_mesh(shape, names,
                          devices=["cpu"] * int(np.prod(shape)))


def test_mesh_engine_matches_reference_engine_under_its_mesh(tmp_path):
    """``StencilEngine(mesh=(2,2))`` on CPU devices against the reference's
    engine under its own (2,2) mesh (``shard_map``, four host devices, the
    Pallas kernels in interpret mode): a pw fused request (the bucket
    refresh at each shard's origin) and a periodic single apply, one
    bucket (16, 16, 32) cut into (8, 8, 32) shards, at 1e-5."""
    import os
    import subprocess
    import sys
    grid = (14, 14, 30)
    reqs = {"fused": port_request(grid, "zero", seed=21),
            "single": port_request(grid, "periodic", seed=22, steps=None)}
    arrays = {"lane": np.int64(hw.BUCKET_LANE)}
    for name, r in reqs.items():
        for kind, part in (("f", r.fields), ("s", r.scalars),
                           ("c", r.coeffs)):
            for k, v in part.items():
                arrays[f"{name}/{kind}/{k}"] = np.asarray(v, np.float32)
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(
                   os.path.dirname(os.path.abspath(__file__))), "src"))
    r = subprocess.run([sys.executable, "-c", MESH_REFERENCE,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    want = np.load(tmp_path / "out.npz")
    with engine(mesh=cpu_mesh((2, 2), ("X", "Y")),
                mesh_axes=("X", "Y", None)) as eng:
        for name, req in reqs.items():
            got = eng.run(req, timeout=300)
            assert got.bucket.bucket == (16, 16, 32)
            ex = eng.executor(got.key)
            assert "mesh=X:2,Y:2,-:1/devices=1" in got.key
            assert ex.plan.mesh_axes == ("X", "Y", None)
            for k, v in got.outputs.items():
                np.testing.assert_allclose(v.numpy(), want[f"{name}/{k}"],
                                           **TOL, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("steps", [None, 2])
def test_tracer_served_on_a_sharded_mesh_as_on_its_exact_grid(steps):
    """On a (2,2) mesh every shard masks tracer's zero-boundary temps to
    the request's real domain in global coordinates (the kernels through
    their origin), so the served answer is still its exact grid's: the
    port's local compile of that grid and the reference's, at 1e-5."""
    p = tracer_advection()
    grid = (13, 11, 25)
    f, s, c = make_data(p, grid, seed=9)
    upd = (None if steps is None else
           (lambda fl, out: dict(fl, t=out["ta"])))
    kw = ({} if steps is None else
          dict(steps=steps, update=upd, update_key="tracer"))
    with engine(mesh=cpu_mesh((2, 2), ("X", "Y")),
                mesh_axes=("X", "Y", None)) as eng:
        got = eng.run(StencilRequest(program=p, fields=f, scalars=s,
                                     coeffs=c, **kw), timeout=300)
    assert got.bucket.bucket == (32, 32, 64)
    ckw = {} if steps is None else dict(steps=steps, update=upd)
    assert_outputs(got.outputs, compile_program(
        p, grid, device="cpu", backend="torch_naive", **ckw)(f, s, c))
    assert_outputs(got.outputs, ref_compile(ref_tracer(), grid,
                                            backend="jnp_naive",
                                            **ckw)(f, s, c))


def test_mesh_engine_refuses_periodic_fused_serving():
    """As in the reference: the bucket refresh of a periodic field is a
    torus gather with no shard-local form, so fused serving of periodic
    fields under a sharded mesh is refused at submit; single applies and
    unsharded meshes serve."""
    eng = engine(mesh=cpu_mesh((2, 1), ("X", "Y")),
                 mesh_axes=("X", "Y", None), autostart=False)
    with pytest.raises(ValueError, match="periodic fields"):
        eng.describe(port_request((14, 14, 30), "periodic"))
    eng.describe(port_request((14, 14, 30), "periodic", steps=None))
    eng.describe(port_request((14, 14, 30), "zero"))
    one = engine(mesh=cpu_mesh((1, 1), ("X", "Y")),
                 mesh_axes=("X", "Y", None), autostart=False)
    one.describe(port_request((14, 14, 30), "periodic"))


def test_mesh_engine_needs_mesh_axes_and_keys_executors_by_topology():
    with pytest.raises(ValueError, match="mesh_axes"):
        StencilEngine(mesh=cpu_mesh((2, 2), ("X", "Y")), device="cpu",
                      autostart=False)
    req = port_request((14, 14, 30))
    keys = {engine(autostart=False).describe(req)[2]}
    for shape, axes in (((2, 2), ("X", "Y", None)), ((4, 1), ("X", "Y", None)),
                        ((2, 2), ("Y", "X", None))):
        eng = engine(mesh=cpu_mesh(shape, ("X", "Y")), mesh_axes=axes,
                     autostart=False)
        assert eng.device == torch.device("cpu")
        keys.add(eng.describe(req)[2])
    assert len(keys) == 4


def test_engine_defaults_to_the_card():
    """Without ``device="cpu"`` the engine serves on the card, and raises
    rather than fall back to the CPU when no card is present."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StencilEngine(autostart=False)


def test_batch_launches_like_one_request():
    """On the CPU the kernels' plain versions run, and count no launch;
    the batch of a bucket runs as one call per kernel (its calls are the
    executor's kernels, whatever the batch size)."""
    before = stencil3d.launches
    reqs = [port_request((8, 8, 16), seed=i) for i in range(3)]
    with engine(window_s=0.2, max_batch=4) as eng:
        eng.map(reqs, timeout=300)
        key, f, s, c = eng.batch_inputs(reqs)
        ex = eng.executor(key)
    assert stencil3d.launches == before
    assert next(iter(f.values())).shape[0] == 3
    assert len(ex.kernels) == len(ex.plan.groups)
