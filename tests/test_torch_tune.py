"""The port's measured plan search (repro_torch.core.tune) on the CPU: the
stencil cases of ``tests/test_tune.py`` with its fake timer and
``device="cpu"``, and the tuned compile against the reference's Pallas
kernels in interpret mode.

Invariants:
* The search is deterministic in its measurements: a fake timer returning
  the same times yields the same winning plan.
* ``compile_program(..., strategy="tuned")`` is a pure cache hit after the
  first tune: zero timed runs, the same plan.
* The cache is keyed by program fingerprint, grid, backend, dtype, mode and
  device (and the torch/CUDA/nvcc versions).
* The tuned plan is never slower than the ``auto_plan`` seed on the
  tuner's own measurements.
* Every block candidate is one of the planner's feasible tiles, with
  ``pick_block``'s chunk.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

from repro.apps import pw_advection as ref_pw
from repro.apps import pw_advection_update as ref_pw_update
from repro.apps import tracer_advection as ref_tracer
from repro.apps import tracer_advection_update as ref_tracer_update
from repro.core import compile_program as ref_compile
from repro_torch import compile_program
from repro_torch.apps import (pw_advection, pw_advection_update,
                              tracer_advection, tracer_advection_update)
from repro_torch.core import (PlanCache, TuneConfig, get_tuned_plan,
                              plan_from_dict, plan_to_dict,
                              program_fingerprint, tune_plan)
from repro_torch.core.frontend import ProgramBuilder
from repro_torch.core.schedule import (auto_plan, feasible_blocks,
                                       pick_block)
from repro_torch.core.tune import (CACHE_SCHEMA_VERSION, _candidates,
                                   cache_key, make_serve_record,
                                   read_serve_record)
from repro_torch.obs import global_metrics
from test_torch_parity import app_data

GRID = (8, 8, 16)
H100 = "NVIDIA H100 80GB HBM3"


def make_fake_timer():
    """Deterministic fake: the time depends only on the call index, and the
    candidate order is deterministic.  Never calls ``fn``: a counted call
    *is* a timed run."""
    calls = {"n": 0}

    def timer(fn):
        i = calls["n"]
        calls["n"] += 1
        return 0.001 * ((i * 7) % 13 + 1)

    return timer, calls


def small_program():
    b = ProgramBuilder("tune_small", ndim=3)
    u, = b.inputs("u")
    su = b.output("su")
    b.define(su, u[-1, 0, 0] + u[1, 0, 0] - 2.0 * u[0, 0, 0])
    return b.build()


def small_update(fields, out):
    return {"u": fields["u"] + 0.1 * out["su"]}


# ----------------------------------------------------------- determinism

@pytest.mark.parametrize("backend", ["torch_fused", "cuda"])
def test_tuner_determinism_with_fake_timer(backend):
    """Same measurements => same winning plan (and carry_write)."""
    results = []
    for _ in range(2):
        timer, _calls = make_fake_timer()
        cfg = TuneConfig(steps=2, max_measured=4, timer=timer)
        results.append(tune_plan(pw_advection(), GRID, backend=backend,
                                 update=pw_advection_update(0.1),
                                 config=cfg, cache=PlanCache(path=None),
                                 device="cpu"))
    a, b = results
    assert plan_to_dict(a.plan) == plan_to_dict(b.plan)
    assert a.carry_write == b.carry_write
    assert a.record["label"] == b.record["label"]
    assert [c.label for c in a.measured] == [c.label for c in b.measured]


# ------------------------------------------------------------ cache hits

def test_second_tuned_compile_is_pure_cache_hit(tmp_path):
    """The second ``strategy="tuned"`` compile, through the JSON file and a
    new PlanCache, performs zero timed runs and reuses the stored plan and
    carry style: the cache counts its own hit, and the process-wide
    ``tune.timed_runs`` counter does not move."""
    p = pw_advection()
    path = str(tmp_path / "plans.json")
    update = pw_advection_update(0.1)
    timed = global_metrics().counter("tune.timed_runs")

    timer1, calls1 = make_fake_timer()
    cache1 = PlanCache(path=path)
    t0 = timed.value
    ex1 = compile_program(p, GRID, strategy="tuned", steps=2, update=update,
                          tune_config=TuneConfig(steps=2, max_measured=3,
                                                 timer=timer1),
                          plan_cache=cache1, device="cpu")
    assert calls1["n"] > 0
    assert timed.value == t0 + calls1["n"]
    assert cache1.misses >= 1 and cache1.hits == 0

    timer2, calls2 = make_fake_timer()
    cache2 = PlanCache(path=path)
    t1 = timed.value
    ex2 = compile_program(p, GRID, strategy="tuned", steps=2, update=update,
                          tune_config=TuneConfig(steps=2, max_measured=3,
                                                 timer=timer2),
                          plan_cache=cache2, device="cpu")
    assert timed.value == t1
    assert calls2["n"] == 0
    assert cache2.hits == 1 and cache2.misses == 0
    assert plan_to_dict(ex1.plan) == plan_to_dict(ex2.plan)
    assert ex1.time_spec.carry_write == ex2.time_spec.carry_write


def test_cache_file_format_roundtrip(tmp_path):
    path = str(tmp_path / "plans.json")
    timer, _ = make_fake_timer()
    res = tune_plan(small_program(), GRID, update=small_update,
                    config=TuneConfig(steps=2, timer=timer),
                    cache=PlanCache(path=path), device="cpu")
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == CACHE_SCHEMA_VERSION
    rec = doc["entries"][res.key]
    assert plan_to_dict(plan_from_dict(rec["plan"])) == rec["plan"]
    assert rec["fingerprint"] == program_fingerprint(small_program())
    assert rec["measured"] >= 1 and rec["candidates"] >= rec["measured"]
    assert rec["device"] == "cpu" and rec["build_seconds"] == 0.0
    assert rec["tune_seconds"] > 0


# ------------------------------------------------------ cache invalidation

def test_cache_invalidated_by_program_fingerprint(tmp_path):
    """A semantically different program misses the cache and re-tunes."""
    path = str(tmp_path / "plans.json")
    timer, calls = make_fake_timer()
    cfg = TuneConfig(steps=2, timer=timer)
    get_tuned_plan(small_program(), GRID, update=small_update, config=cfg,
                   cache=PlanCache(path=path), device="cpu")
    n_first = calls["n"]
    assert n_first > 0

    b = ProgramBuilder("tune_small", ndim=3)   # same name, other stencil
    u, = b.inputs("u")
    su = b.output("su")
    b.define(su, u[0, -1, 0] + u[0, 1, 0] - 2.0 * u[0, 0, 0])
    other = b.build()
    assert program_fingerprint(other) != program_fingerprint(small_program())
    res = get_tuned_plan(other, GRID, update=small_update, config=cfg,
                         cache=PlanCache(path=path), device="cpu")
    assert not res.cache_hit and calls["n"] > n_first

    res2 = get_tuned_plan(small_program(), GRID, update=small_update,
                          config=cfg, cache=PlanCache(path=path),
                          device="cpu")
    assert res2.cache_hit


def test_cache_invalidated_by_grid_change(tmp_path):
    path = str(tmp_path / "plans.json")
    timer, calls = make_fake_timer()
    cfg = TuneConfig(steps=2, timer=timer)
    cache = PlanCache(path=path)
    p = small_program()
    get_tuned_plan(p, GRID, update=small_update, config=cfg, cache=cache,
                   device="cpu")
    n_first = calls["n"]
    res = get_tuned_plan(p, (16, 8, 16), update=small_update, config=cfg,
                         cache=cache, device="cpu")
    assert not res.cache_hit and calls["n"] > n_first


@pytest.mark.parametrize("other", [
    dict(backend="torch_fused"), dict(dtype="bfloat16"),
    dict(mode="single"), dict(device=H100), dict(grid=(16, 8, 16)),
    dict(p=small_program().with_boundary("periodic")),
], ids=["backend", "dtype", "mode", "device", "grid", "boundary"])
def test_cache_keyed_by_each_part_of_the_problem(other):
    """A float32 winner must not serve a bfloat16 compile, a single-step
    winner a fused one, nor a plan measured on the CPU the card."""
    base = dict(p=small_program(), grid=GRID, backend="cuda", device="cpu",
                dtype="float32", mode="loop")
    assert cache_key(**base) != cache_key(**dict(base, **other))
    assert cache_key(**base) == cache_key(**dict(base))


def test_tuned_plan_boundary_in_fingerprint():
    p = pw_advection()
    assert program_fingerprint(p) != \
        program_fingerprint(p.with_boundary("periodic"))


# ------------------------------------------- measured quality guarantee

@pytest.mark.parametrize("backend", ["torch_fused", "cuda"])
def test_tuned_never_slower_than_auto_plan_on_measurements(backend):
    """The auto_plan seed is always measured (here on the CPU's clock, the
    plain versions running), so argmin <= baseline."""
    cfg = TuneConfig(steps=2, repeats=1, max_measured=3)
    res = tune_plan(pw_advection(), GRID, backend=backend,
                    update=pw_advection_update(0.1), config=cfg,
                    cache=PlanCache(path=None), device="cpu")
    base = res.baseline
    assert base is not None and base.us_fused is not None
    assert res.record["us_fused"] <= base.us_fused
    assert res.measured[0].score() == min(c.score() for c in res.measured)


def test_tuned_plan_compiles_and_matches_auto_plan_results():
    rng = np.random.default_rng(0)
    p = small_program()
    fields = {"u": rng.normal(size=GRID).astype(np.float32)}
    timer, _ = make_fake_timer()
    ex_t = compile_program(p, GRID, strategy="tuned",
                           tune_config=TuneConfig(steps=2, timer=timer),
                           plan_cache=PlanCache(path=None), device="cpu")
    ex_a = compile_program(p, GRID, device="cpu")
    np.testing.assert_allclose(ex_t(fields)["su"].numpy(),
                               ex_a(fields)["su"].numpy(), atol=1e-6)


def test_tune_without_update_measures_single_step_only():
    timer, calls = make_fake_timer()
    res = tune_plan(small_program(), GRID, config=TuneConfig(steps=2,
                                                             timer=timer),
                    cache=PlanCache(path=None), device="cpu")
    assert res.record["us_fused"] is None
    assert res.record["us_single"] is not None
    assert calls["n"] == res.record["measured"]  # one timing a candidate


@pytest.mark.parametrize("app,grid", [(pw_advection, (8, 8, 256)),
                                      (tracer_advection, (20, 18, 100))])
def test_block_candidates_are_planner_tiles(app, grid):
    """Every block candidate is one of the planner's feasible tiles for
    its groups, with the chunk ``pick_block`` gives that tile; the
    ``auto_plan`` seed is the first of them."""
    p = app()
    cfg = TuneConfig(steps=2, timer=lambda fn: 1.0)
    cands = _candidates(p, grid, "cuda", "float32", cfg, with_loop=True)
    blocks = [c for c in cands if c.plan.schedule == "block"]
    assert blocks[0].label == "auto_plan"
    assert blocks[0].plan.block == pick_block(p, blocks[0].plan.groups,
                                              grid, "float32",
                                              cfg.smem_budget)
    for c in blocks:
        ranked = feasible_blocks(p, c.plan.groups, grid, "float32",
                                 cfg.smem_budget)
        assert c.plan.block in ranked
    assert len({c.plan.block for c in blocks}) > 1


def test_feasible_blocks_start_with_pick_block():
    for app in (pw_advection, tracer_advection):
        for grid in [(8, 8, 32), (130, 70, 100), (256, 256, 128)]:
            p = app()
            groups = auto_plan(p, grid).groups
            ranked = feasible_blocks(p, groups, grid, "float32", 232_448)
            assert ranked[0] == pick_block(p, groups, grid, "float32",
                                           232_448)
            assert len(set(ranked)) == len(ranked)


def test_force_retune_bypasses_cache(tmp_path):
    path = str(tmp_path / "plans.json")
    timer, calls = make_fake_timer()
    cfg = TuneConfig(steps=2, timer=timer)
    get_tuned_plan(small_program(), GRID, update=small_update, config=cfg,
                   cache=PlanCache(path=path), device="cpu")
    n_first = calls["n"]
    res = get_tuned_plan(small_program(), GRID, update=small_update,
                         config=dataclasses.replace(cfg, force_retune=True),
                         cache=PlanCache(path=path), device="cpu")
    assert not res.cache_hit and calls["n"] > n_first


def test_corrupt_cache_file_is_ignored(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text("{not json")
    timer, calls = make_fake_timer()
    res = get_tuned_plan(small_program(), GRID, update=small_update,
                         config=TuneConfig(steps=2, timer=timer),
                         cache=PlanCache(path=str(path)), device="cpu")
    assert not res.cache_hit and calls["n"] > 0
    with open(path) as f:
        assert json.load(f)["entries"]


# --------------------------------------------- cache schema evolution

def test_stale_cache_version_is_a_miss_and_rewritten(tmp_path):
    path = str(tmp_path / "plans.json")
    timer, calls = make_fake_timer()
    cfg = TuneConfig(steps=2, timer=timer)
    res = tune_plan(small_program(), GRID, update=small_update, config=cfg,
                    cache=PlanCache(path=path), device="cpu")
    with open(path) as f:
        doc = json.load(f)
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": doc["entries"]}, f)
    fresh = PlanCache(path=path)
    assert fresh.lookup(res.key) is None

    calls["n"] = 0
    res2 = get_tuned_plan(small_program(), GRID, update=small_update,
                          config=cfg, cache=fresh, device="cpu")
    assert not res2.cache_hit and calls["n"] > 0
    with open(path) as f:
        assert json.load(f)["version"] == CACHE_SCHEMA_VERSION
    assert fresh.lookup(res2.key) is not None


def test_plan_from_dict_tolerates_schema_drift():
    plan = auto_plan(small_program(), GRID)
    d = plan_to_dict(plan)
    future = dict(d, schema=99, exotic_knob={"nested": [1, 2]})
    assert plan_to_dict(plan_from_dict(future)) == d
    legacy = {k: v for k, v in d.items()
              if k not in ("schema", "schedule", "stream")}
    r = plan_from_dict(legacy)
    assert r.schedule == "block" and r.stream is None
    assert r.groups == plan.groups and r.block == plan.block
    r0 = plan_from_dict({"groups": [[0]], "block": [8, 8, 16]})
    assert r0.dtype == "float32" and r0.halo_every == 1


def test_plan_cache_roundtrips_stream_spec(tmp_path):
    plan = auto_plan(pw_advection(), GRID, schedule="stream")
    assert plan.stream is not None and plan.stream.depths
    path = str(tmp_path / "plans.json")
    PlanCache(path=path).store("k", {"plan": plan_to_dict(plan),
                                     "carry_write": "repad"})
    got = plan_from_dict(PlanCache(path=path).lookup("k")["plan"])
    assert got.schedule == "stream" and got.stream == plan.stream
    assert plan_to_dict(got) == plan_to_dict(plan)


def test_tuner_enumerates_stream_and_block_schedules():
    cfg = TuneConfig(steps=2, timer=lambda fn: 1.0)
    cands = _candidates(pw_advection(), GRID, "cuda", "float32", cfg,
                        with_loop=True)
    assert {c.plan.schedule for c in cands} == {"block", "stream"}
    stream = [c for c in cands if c.plan.schedule == "stream"]
    assert all(c.plan.stream is not None for c in stream)
    assert {c.plan.stream.time_tile for c in stream} == {1, 2, 4}
    assert {c.carry_write for c in cands} == {"repad", "inplace"}
    jcands = _candidates(pw_advection(), GRID, "torch_fused", "float32",
                         cfg, with_loop=True)
    assert {c.plan.schedule for c in jcands} == {"block"}


# ------------------------------------------------------- concurrency

def test_plan_cache_concurrent_writers_merge(tmp_path):
    """Threads storing distinct keys into one file through their own
    PlanCache objects: every entry survives the merge-on-write."""
    path = str(tmp_path / "plans.json")
    n_threads, per_thread = 8, 10
    rec = {"plan": plan_to_dict(auto_plan(pw_advection(), GRID)),
           "carry_write": "repad"}
    caches = [PlanCache(path) for _ in range(n_threads)]
    start = threading.Barrier(n_threads)
    errs = []

    def writer(i):
        try:
            start.wait(timeout=30)
            for j in range(per_thread):
                caches[i].store(f"w{i}/k{j}", dict(rec, label=f"{i}/{j}"))
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    with open(path) as f:
        doc = json.load(f)
    keys = {f"w{i}/k{j}" for i in range(n_threads) for j in range(per_thread)}
    assert keys <= set(doc["entries"])
    fresh = PlanCache(path)
    for k in keys:
        assert fresh.lookup(k)["carry_write"] == "repad"


def test_plan_cache_shared_object_threadsafe(tmp_path):
    path = str(tmp_path / "plans.json")
    cache = PlanCache(path)
    rec = {"plan": plan_to_dict(auto_plan(pw_advection(), GRID)),
           "carry_write": "inplace"}
    start = threading.Barrier(4)
    errs = []

    def worker(i):
        try:
            start.wait(timeout=30)
            for j in range(12):
                cache.store(f"t{i}/k{j}", dict(rec))
                assert cache.lookup(f"t{i}/k{j}") is not None
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    fresh = PlanCache(path)
    for i in range(4):
        for j in range(12):
            assert fresh.lookup(f"t{i}/k{j}")["carry_write"] == "inplace"


# -------------------------------------------------- serve records

def test_serve_record_round_trip():
    """A serving executor record decodes to its plan and carry style; a
    record of another schema, kind or shape is a clean miss."""
    plan = auto_plan(pw_advection(), GRID, schedule="stream", time_tile=2)
    rec = make_serve_record(plan, "inplace", (8, 8, 16), 4)
    got, cw = read_serve_record(json.loads(json.dumps(rec)))
    assert plan_to_dict(got) == plan_to_dict(plan) and cw == "inplace"
    assert rec["bucket"] == [8, 8, 16] and rec["steps"] == 4
    assert read_serve_record(None) is None
    assert read_serve_record(dict(rec, schema=rec["schema"] + 1)) is None
    assert read_serve_record(dict(rec, kind="tuned_plan")) is None
    assert read_serve_record(dict(rec, plan={"block": [1]})) is None


def test_compile_program_does_not_mutate_shared_plan():
    p = pw_advection()
    plan = auto_plan(p, GRID)
    groups_before = [list(g) for g in plan.groups]
    ex = compile_program(p, GRID, backend="torch_fused", plan=plan,
                         device="cpu")
    assert plan.backend == "cuda" and ex.plan.backend == "torch_fused"
    assert plan.groups == groups_before
    ex.plan.groups[0].append(99)
    assert plan.groups == groups_before


# ------------------------------------- against the reference (JAX package)

APPS = {
    "pw_advection": (ref_pw, pw_advection, lambda: ref_pw_update(0.1),
                     lambda: pw_advection_update(0.1)),
    "tracer_advection": (ref_tracer, tracer_advection, ref_tracer_update,
                         tracer_advection_update),
}


@pytest.mark.parametrize("steps", [None, 4], ids=["step", "fused4"])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", sorted(APPS))
def test_tuned_compile_matches_reference_pallas(name, boundary, steps):
    """The port's ``strategy="tuned"`` compile against the reference's
    Pallas kernels in interpret mode, at the parity tests' tolerances:
    1e-4 single step, 1e-5 fused.  The fake timer makes every timing
    faster than the one before, so the winner is the last candidate
    measured, never the ``auto_plan`` seed."""
    ref_app, app, ref_upd, upd = APPS[name]
    grid = (8, 8, 32) if steps is None else (6, 8, 32)
    fields, scalars, coeffs = app_data(name, grid)
    kw = {} if steps is None else dict(steps=steps)
    want = ref_compile(ref_app(boundary), grid, backend="pallas",
                       **kw, **({} if steps is None
                                else dict(update=ref_upd())))(
        fields, scalars, coeffs)
    calls = []

    def timer(fn):
        calls.append(fn)
        return 1.0 / len(calls)

    cache = PlanCache(path=None)
    ex = compile_program(app(boundary), grid, strategy="tuned",
                         tune_config=TuneConfig(steps=2, max_measured=4,
                                                timer=timer),
                         plan_cache=cache, device="cpu",
                         **kw, **({} if steps is None
                                  else dict(update=upd())))
    rec = next(iter(cache._mem.values()))
    assert calls and rec["label"] != "auto_plan"
    got = ex(fields, scalars, coeffs)
    tol = 1e-4 if steps is None else 1e-5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, rtol=tol, err_msg=k)


def test_tuned_compile_traces_the_search_and_its_choice():
    """A traced tuned compile records the ``tune`` span, one
    ``tune.candidate`` span a measured candidate, the cache miss, and the
    ``PlanChosen`` events (the tuner's and the compile's) carrying the
    winner's label, modeled and measured time and roofline fraction; the
    second compile records the hit."""
    from repro_torch.obs import Tracer

    timer, calls = make_fake_timer()
    cfg = TuneConfig(steps=2, max_measured=3, timer=timer)
    cache = PlanCache(path=None)
    kw = dict(strategy="tuned", steps=2, update=pw_advection_update(0.1),
              tune_config=cfg, plan_cache=cache, device="cpu")
    tr = Tracer()
    compile_program(pw_advection(), GRID, trace=tr, **kw)
    (tune_span,) = tr.spans("tune")
    assert tune_span["args"]["measured"] == 3
    assert len(tr.spans("tune.candidate")) == 3
    assert len(tr.events("CacheMiss")) == 1
    rec = next(iter(cache._mem.values()))
    chosen = tr.events("PlanChosen")
    assert [e["args"]["strategy"] for e in chosen] == ["tuned", "tuned"]
    for ev in chosen:
        a = ev["args"]
        assert a["label"] == rec["label"]
        assert a["modeled_us"] == rec["modeled_us"] > 0
        assert a["measured_us"] == rec["us_fused"]
        assert a["roofline_fraction"] == rec["roofline_fraction"] > 0

    tr2 = Tracer()
    compile_program(pw_advection(), GRID, trace=tr2, **kw)
    assert len(tr2.events("CacheHit")) == 1 and not tr2.spans("tune")
    assert tr2.events("PlanChosen")[0]["args"]["label"] == rec["label"]


# ------------------------------------------------------------- mesh keying

def _cpu_mesh(shape, names):
    from repro_torch.dist import make_auto_mesh
    return make_auto_mesh(shape, names,
                          devices=["cpu"] * int(np.prod(shape)))


def test_tuned_compile_under_a_mesh_is_keyed_by_its_topology(tmp_path):
    """``strategy="tuned"`` under a (2,2) mesh of CPU devices: candidates
    priced on the (4, 4, 16) shard-local grid, every measurement the real
    sharded executable, the winner stored under a key carrying the mesh
    topology; a second compile is a pure cache hit, and a (4,1) mesh of
    the same four devices misses and searches again.  The tuned sharded
    loop matches the local loop at the reference's 1e-5."""
    p = pw_advection()
    path = str(tmp_path / "plans.json")
    update = pw_advection_update(0.1)
    axes = ("X", "Y", None)
    f, s, c = app_data("pw_advection", GRID)

    def tuned(mesh):
        timer, calls = make_fake_timer()
        cache = PlanCache(path=path)
        ex = compile_program(p, GRID, strategy="tuned", steps=2,
                             update=update, mesh=mesh, mesh_axes=axes,
                             tune_config=TuneConfig(steps=2, max_measured=3,
                                                    timer=timer),
                             plan_cache=cache)
        return ex, calls["n"], cache

    ex, n, cache = tuned(_cpu_mesh((2, 2), ("X", "Y")))
    assert n > 0 and cache.misses == 1
    assert ex.shard.local_grid == (4, 4, 16)
    keys = list(json.loads(open(path).read())["entries"])
    assert len(keys) == 1 and keys[0].endswith("|mesh=X:2,Y:2,-:1/devices=1")
    rec = json.loads(open(path).read())["entries"][keys[0]]
    assert rec["mesh"] == "X:2,Y:2,-:1/devices=1"
    ex2, n2, cache2 = tuned(_cpu_mesh((2, 2), ("X", "Y")))
    assert n2 == 0 and cache2.hits == 1
    assert plan_to_dict(ex2.plan) == plan_to_dict(ex.plan)
    _, n3, cache3 = tuned(_cpu_mesh((4, 1), ("X", "Y")))
    assert n3 > 0 and cache3.misses == 1
    assert len(json.loads(open(path).read())["entries"]) == 2
    want = compile_program(p, GRID, device="cpu", steps=2,
                           update=update)(f, s, c)
    got = ex(f, s, c)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_cache_key_carries_the_mesh():
    base = dict(p=pw_advection(), grid=GRID, backend="cuda", device=H100)
    local = cache_key(**base)
    assert local.endswith("|mesh=none")
    m = _cpu_mesh((2, 2), ("X", "Y"))
    a = cache_key(**base, mesh=m, mesh_axes=("X", "Y", None))
    b = cache_key(**base, mesh=m, mesh_axes=("Y", "X", None))
    assert len({local, a, b}) == 3
