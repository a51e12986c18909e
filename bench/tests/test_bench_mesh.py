"""A cell over several cards: the reference in slabs, the digest in chunks,
the run over a mesh, and energy, memory, the least time and the device
trace taken over the cell's cards.

    PYTHONPATH=src python -m pytest -q bench/tests/test_bench_mesh.py
"""

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import compare, devtrace, harness, inputs, roofline, slabs, spans

MESH = "pw2g.mesh2x2.fused10.block"
MS = 1_000_000


def _config(root, name, reach):
    cfg = harness.load_json(root / "bench" / "configs" / f"{name}.json")
    return dict(cfg, reference=dict(cfg["reference"], reach=reach))


@pytest.mark.parametrize("name,steps,reach,grid", [
    ("pw_advection_134m", 10, 1, (48, 6, 4)),
    ("tracer_advection_134m", 4, 4, (72, 6, 4))])
@pytest.mark.parametrize("parts", [1, 2, 3])
def test_slab_reference_is_bit_equal_to_the_whole_grid(root, name, steps,
                                                       reach, grid, parts):
    cfg = _config(root, name, reach)
    ref = harness.reference(root, cfg["reference"]["module"])
    f, s, c = inputs.make(cfg, grid, 2**31 + 17, "cpu")
    whole = ref.run(cfg["reference"]["scheme"], f, s, c, steps,
                    **cfg["reference"].get("args", {}))
    plan = slabs.plan(cfg, grid, steps, ["cpu"] * parts, slab_points=2**40)
    assert len(plan) == parts
    if parts == 3:      # the middle slab is cut from the grid on both sides
        lo, a, b, hi, _ = plan[1]
        assert 0 < lo < a < b < hi < grid[0]
    res = slabs.run(ref, cfg, f, s, c, steps, plan)
    assert [(a, b) for a, b, _ in res] == [(a, b) for _, a, b, _, _ in plan]
    for k in whole:
        got = torch.cat([r[torch.float32][k] for _, _, r in res])
        assert torch.equal(got, whole[k]), k


def test_too_few_ghost_rows_are_not_equal(root):
    """The check above can fail: one ghost row short, the cut shows."""
    cfg = _config(root, "pw_advection_134m", 1)
    ref = harness.reference(root, "advection")
    grid, steps = (48, 6, 4), 10
    f, s, c = inputs.make(cfg, grid, 5, "cpu")
    whole = ref.run("pw", f, s, c, steps, dt=0.1)
    short = dict(cfg, reference=dict(cfg["reference"], reach=0))
    plan = slabs.plan(short, grid, steps, ["cpu"] * 3, slab_points=2**40)
    res = slabs.run(ref, short, f, s, c, steps, plan)
    got = torch.cat([r[torch.float32]["u"] for _, _, r in res])
    assert not torch.equal(got, whole["u"])


def test_slabs_cover_the_grid_and_take_at_most_the_slab_points(root):
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_2g_mesh2x2.json")
    grid = cfg["grid"]
    plan = slabs.plan(cfg, grid, 10, ["cuda:1", "cuda:2", "cuda:3"])
    rows = grid[1] * grid[2]
    assert len(plan) == math.ceil(grid[0] / (slabs.SLAB_POINTS // rows))
    assert [p[1] for p in plan[1:]] == [p[2] for p in plan[:-1]]
    assert plan[0][:2] == (0, 0) and plan[-1][2:4] == (grid[0], grid[0])
    assert all((b - a) * rows <= slabs.SLAB_POINTS and a - lo <= 10
               and hi - b <= 10 for lo, a, b, hi, _ in plan)
    assert {str(p[4]) for p in plan} == {"cuda:1", "cuda:2", "cuda:3"}
    # at the one-card cells' grid one slab a device
    assert len(slabs.plan(cfg, (1024, 512, 256), 10, ["cpu"])) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_chunked_digest_is_the_one_pass_digest(dtype):
    g = torch.Generator().manual_seed(3)
    padded = torch.randn((18, 14, 10), generator=g).to(dtype)
    fields = {"a": torch.randn((16, 12, 8), generator=g).to(dtype),
              "b": padded[1:17, 1:13, 1:9]}        # a carry's interior
    one = compare.digest(torch, fields, ["a", "b"])
    for chunk in (1, 100, 96 * 5, 16 * 12 * 8):
        assert torch.equal(compare.digest(torch, fields, ["a", "b"],
                                          chunk=chunk), one)
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    assert int(one[0]) == int(fields["a"].view(bits).to(torch.int64).sum())
    fields["b"][3, 4, 5] += 1
    assert not torch.equal(compare.digest(torch, fields, ["a", "b"],
                                          chunk=100), one)


def test_a_slab_comparison_reads_as_the_whole_grids():
    g = torch.Generator().manual_seed(1)
    want = torch.randn((30, 4, 4), generator=g)
    got = want + 1e-3 * torch.randn((30, 4, 4), generator=g)
    parts = [compare.error_parts(got[a:b], want[a:b])
             for a, b in ((0, 7), (7, 19), (19, 30))]
    assert compare.rel_err_of_parts(parts) == compare.rel_err(got, want)
    got[20, 1, 1] = torch.nan
    parts = [compare.error_parts(got[a:b], want[a:b])
             for a, b in ((0, 7), (7, 19), (19, 30))]
    assert not compare.rel_err_of_parts(parts) <= 1.0


def test_the_mesh_cell_compiles_under_its_mesh(root):
    cell = harness.load_cell(root, MESH)
    assert harness.mesh_size(cell.config) == cell.entry["chips"] == 4
    ex = harness.compile_cell(cell, (16, 12, 8), "cpu")
    assert ex.shard is not None
    assert tuple(ex.shard.mesh_axes) == ("x", "y", None)
    assert tuple(ex.shard.local_grid) == (8, 6, 8)
    one = harness.load_cell(root, "pw134m.fused10.block")
    assert harness.compile_cell(one, (16, 12, 8), "cpu").shard is None


def test_a_mesh_whose_size_is_not_the_chips_is_refused(root, tmp_path):
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((root / "BENCHMARK.json").read_text())
    for w in bm["workloads"]:
        if w["name"] == MESH:
            w["chips"] = 1
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    with pytest.raises(ValueError, match="mesh has 4"):
        harness.load_cell(tmp_path, MESH)
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", MESH,
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and "{" not in r.stdout
    assert "mesh has 4" in r.stderr


def test_the_runner_refuses_fewer_cards_than_the_chips(root):
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", MESH,
                        "--seed", str(2**31 + 3), "--seconds", "1"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2 and "{" not in r.stdout
    assert "needs 4 CUDA card(s)" in r.stderr


def test_a_mesh_run_on_the_cpu_is_correct_and_counts_the_exchange(root):
    cell = harness.load_cell(root, MESH)
    res, rows = harness.run_cell(cell, 2**31 + 21, 0.3, True,
                                 t0=time.perf_counter(), device="cpu",
                                 grid=(16, 12, 8))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["count"] == 4
    # the halo slabs of u, v and w a step: one row along x, then one column
    # along y that carries the x halos, on each of the four shards
    per_field = 4 * (1 * 6 * 8 + (8 + 2) * 1 * 8) * 4
    assert res["metrics"]["exchange_gb_per_step"]["value"] == \
        pytest.approx(3 * per_field / 1e9, rel=1e-12)
    # no stencil.* counters or spans in the mesh orchestrator: left out
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}


def test_least_time_divides_over_the_chips(root):
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_134m.json")
    one, what = roofline.least_time(cfg, cfg["grid"], 10)
    nbytes, ops = roofline.call_work(cfg, cfg["grid"], 10)
    assert one == max(nbytes / roofline.HBM_BYTES_PER_S,
                      ops / roofline.PEAK_F32_FLOPS)
    assert roofline.least_time(cfg, cfg["grid"], 10, 1) == (one, what)
    four, what4 = roofline.least_time(cfg, cfg["grid"], 10, 4)
    assert four == pytest.approx(one / 4, rel=1e-15) and what4 == what


def _stretch(cards, kernel_ns, calls=2):
    """``calls`` calls, each one generated kernel of ``kernel_ns`` on each
    card and a copy of 1 ms."""
    host, device = [], []
    call_ns = kernel_ns + 3 * MS
    for c in range(calls):
        o = c * call_ns
        host.append((o, o + call_ns, "bench.call", 1, 0))
        for card in range(cards):
            device.append((o + MS, o + MS + kernel_ns,
                           "void g0_kernel<false>(float*)", card, 0))
            device.append((o + MS + kernel_ns, o + 2 * MS + kernel_ns,
                           "Memcpy PtoP (Device -> Device)", card, 0))
    return {"calls": calls, "host": host, "device": device}


def _run(cfg, grid, steps, chips, trace, call_s):
    return harness.Run(
        cell=None, points=math.prod(grid), steps_per_call=steps,
        least_time_s=roofline.least_time(cfg, grid, steps, chips)[0],
        setup_s=1.0, spans={}, call_s=call_s, window_s=sum(call_s),
        energy_j=None, window_peak_bytes=1, trace=trace)


def test_both_shares_stay_under_100_on_four_cards(root):
    """Four cards that each run the call in a quarter of one card's least
    time: both shares read 100%, where one card's least time would make
    the whole step read 400%; on one card the arithmetic is the one-card
    formula."""
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_2g_mesh2x2.json")
    grid, steps = cfg["grid"], 10
    lt4 = roofline.least_time(cfg, grid, steps, 4)[0]
    ns = math.ceil(lt4 * 1e9)
    match = devtrace.generated_matcher(["g0"])
    share = harness.reader(root, "stencil_roofline")
    mfu = harness.reader(root, "step_mfu")
    tr = devtrace.summarise(_stretch(4, ns), match, cards=4)
    run = _run(cfg, grid, steps, 4, tr, [ns / 1e9] * 3)
    for v in (share(run), mfu(run)):
        assert 99.99 < v <= 100.0
    # one card's least time over the call: the 400% the chips remove
    assert 100 * roofline.least_time(cfg, grid, steps)[0] \
        / (ns / 1e9) > 399
    tr1 = devtrace.summarise(_stretch(1, 4 * ns), match)
    run1 = _run(cfg, grid, steps, 1, tr1, [4 * ns / 1e9] * 3)
    lt1 = roofline.least_time(cfg, grid, steps)[0]
    assert share(run1) == 100.0 * lt1 / (tr1["generated_s"] / tr1["calls"])
    assert 99.99 < share(run1) <= 100.0


def test_summarise_reads_each_card_and_reports_the_mean_card():
    raw = {"calls": 1, "host": [(0, 10 * MS, "bench.call", 1, 0),
                                (5 * MS, 10 * MS, "cudaDeviceSynchronize",
                                 1, 0)],
           "device": [(0, 6 * MS, "void g0_kernel<false>(float*)", 0, 1),
                      (2 * MS, 4 * MS, "void fill_kernel", 1, 2),
                      (5 * MS, 9 * MS, "Memcpy PtoP (Device -> Device)", 1,
                       3)]}
    match = devtrace.generated_matcher(["g0"])
    two = devtrace.summarise(raw, match, cards=2)
    assert two["busy_by_card"] == {0: 0.006, 1: 0.006}
    assert two["busy_s"] == pytest.approx(0.006)     # not the union, 9 ms
    assert two["window_s"] == 0.01
    assert sum(v for _, v in two["idle_gaps"]) == pytest.approx(0.004)
    assert two["device_ops"] == 1.5 and two["generated_s"] == 0.003
    # a card of the cell with no operation is idle throughout
    three = devtrace.summarise(raw, match, cards=3)
    assert three["busy_s"] == pytest.approx(0.004)
    assert sum(v for _, v in three["idle_gaps"]) == pytest.approx(0.006)
    # the readers divide by the calls and steps only
    run = _run({"dtype": "float32", "reads": [], "writes": [],
                "inputs": {"coeffs": {}}, "flops_per_point": 1},
               (1, 1, 1), 1, 3, three, [0.01])
    assert harness.reader(harness.ROOT, "device_idle_share")(run) == \
        pytest.approx(60.0)


def test_energy_is_summed_over_the_cards(monkeypatch):
    from bench import power

    monkeypatch.setattr(power, "_nvidia_smi", lambda: "nvidia-smi")
    cards = power.Cards(["GPU-a", "GPU-b"], interval_ms=100)
    assert [s._cmd[1] for s in cards.each] == ["--id=GPU-a", "--id=GPU-b"]
    cards.each[0].samples = [(0.05 + 0.1 * i, 500.0) for i in range(20)]
    cards.each[1].samples = [(0.05 + 0.1 * i, 300.0) for i in range(20)]
    assert cards.energy_j(0.0, 2.0) == pytest.approx(1600.0)
    assert cards.energy_j(0.0, 2.0) == sum(s.energy_j(0.0, 2.0)
                                           for s in cards.each)
    cards.each[1].samples = []          # a card with no reading: no result
    with pytest.raises(RuntimeError):
        cards.energy_j(0.0, 2.0)


def test_exchange_device_time_is_read_per_card(root):
    """Two cards, each with an exchange (a fill and a peer copy) and a
    generated kernel launched outside any stencil.kernel span; operations
    pair with their calls by correlation id."""
    host, device = [(0, 20 * MS, "bench.call", 1, 0)], []
    for card in range(2):
        o = card * 8 * MS
        host += [(o, o + 4 * MS, "distribute.exchange", 1, 0),
                 (o + 1 * MS, o + 2 * MS, "cudaLaunchKernel", 1, 10 + card),
                 (o + 2 * MS, o + 3 * MS, "cudaMemcpyAsync", 1, 20 + card),
                 (o + 5 * MS, o + 6 * MS, "cudaLaunchKernel", 1, 30 + card)]
        device += [(o + 3 * MS, o + 4 * MS, "void fill_kernel", card,
                    10 + card),
                   (o + 4 * MS, o + 7 * MS, "Memcpy PtoP (Device -> Device)",
                    card, 20 + card),
                   (o + 7 * MS, o + 9 * MS, "void g0_kernel<false>(float*)",
                    card, 30 + card)]
    raw = {"calls": 1, "host": host, "device": device}
    att = spans.attribute(raw)
    assert att["by_span"]["distribute.exchange"]["ns"] == 8 * MS
    assert att["by_span"][spans.UNATTRIBUTED]["generated_ops"] == 2
    tr = devtrace.summarise(raw, devtrace.generated_matcher(["g0"]),
                            cards=2)
    tr["exchanged_bytes"] = 3 * 10**9
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_2g_mesh2x2.json")
    run = _run(cfg, (16, 12, 8), 10, 2, tr, [0.02])
    assert harness.reader(root, "exchange_device_ms_per_step")(run) == \
        pytest.approx(8 / 10 / 2)
    assert harness.reader(root, "exchange_gb_per_step")(run) == \
        pytest.approx(0.3)
    # an operation with no call of its id: nothing is paired
    raw["device"].append((15 * MS, 16 * MS, "void fill_kernel", 1, 99))
    assert spans.attribute(raw) is None


def test_the_mesh_stretch_holds_the_exchange_spans(root):
    """The mesh orchestrator opens its spans for an installed tracer only:
    the profiled stretch of a mesh cell installs one, and holds a
    ``distribute.exchange`` range a field a step; a one-card cell's
    stretch is profiled as before."""
    cell = harness.load_cell(root, MESH)
    grid = (16, 12, 8)
    f, s, c = inputs.make(cell.config, grid, 3, "cpu")
    ex = harness.compile_cell(cell, grid, "cpu")
    with harness.program_spans(cell.config):
        raw = devtrace.profile_calls(torch, lambda: ex(f, s, c), 2, False)
    names = [h[2] for h in raw["host"]]
    assert names.count("distribute.exchange") == 2 * 10 * 3
    one = harness.load_cell(root, "pw134m.fused10.block")
    assert isinstance(harness.program_spans(one.config),
                      contextlib.nullcontext)
