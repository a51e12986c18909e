"""The orchestrator's per-layer metrics: ``bench/spans.py`` putting device
operations down to the program's ``stencil.*`` spans, ``summarise`` naming
idle gaps by them with its other outputs unchanged, the counters read in a
CPU run, and the benchmark run against a program from before the spans."""

import json
import math
import shutil
import subprocess
import sys

import pytest

from bench import devtrace, harness, spans

MS = 1_000_000
NEW = ["pad_device_ms_per_step", "update_device_ms_per_step",
       "carry_device_ms_per_step", "prologue_device_ms_per_step",
       "orchestrator_gb_per_step", "carry_useful_share"]


def _raw(lost=0, cards=1):
    """Two calls: a prologue copy, a pad, a generated kernel, an update
    and a write-back each, and one kernel launched outside any span; each
    runtime call and its operation share a correlation id, and call ``c``
    runs on card ``c % cards``."""
    host, device = [], []
    for c in range(2):
        o, k, card = c * 100 * MS, 100 * c, c % cards
        host += [(o, o + 90 * MS, "bench.call", 1, 0),
                 (o + 1 * MS, o + 80 * MS, "stencil.call", 1, 0),
                 (o + 2 * MS, o + 10 * MS, "stencil.prologue", 1, 0),
                 (o + 11 * MS, o + 79 * MS, "stencil.step", 1, 0),
                 (o + 12 * MS, o + 20 * MS, "stencil.pad", 1, 0),
                 (o + 21 * MS, o + 30 * MS, "stencil.kernel", 1, 0),
                 (o + 31 * MS, o + 40 * MS, "stencil.update", 1, 0),
                 (o + 41 * MS, o + 50 * MS, "stencil.write_back", 1, 0),
                 (o + 3 * MS, o + 4 * MS, "cudaMemcpyAsync", 1, k + 1),
                 (o + 13 * MS, o + 14 * MS, "cudaLaunchKernel", 1, k + 2),
                 (o + 22 * MS, o + 23 * MS, "cudaLaunchKernel", 1, k + 3),
                 (o + 32 * MS, o + 33 * MS, "cudaLaunchKernel", 1, k + 4),
                 (o + 42 * MS, o + 43 * MS, "cudaLaunchKernel", 1, k + 5),
                 (o + 42 * MS, o + 43 * MS, "cudaStreamIsCapturing", 1, k + 9),
                 (o + 85 * MS, o + 86 * MS, "cudaLaunchKernel", 1, k + 6),
                 (o + 87 * MS, o + 89 * MS, "cudaDeviceSynchronize", 1, k + 7)]
        device += [(o + 5 * MS, o + 6 * MS, "Memcpy HtoD (Pageable -> Device)",
                    card, k + 1),
                   (o + 15 * MS, o + 18 * MS, "void at::native::fill_kernel",
                    card, k + 2),
                   (o + 24 * MS, o + 34 * MS, "void g0_kernel<false>(float*)",
                    card, k + 3),
                   (o + 35 * MS, o + 37 * MS, "void elementwise_kernel add",
                    card, k + 4),
                   (o + 44 * MS, o + 48 * MS, "void direct_copy_kernel",
                    card, k + 5),
                   (o + 86 * MS, o + 87 * MS, "void at::native::fill_kernel",
                    card, k + 6)]
    return {"calls": 2, "host": host, "device": sorted(device)[lost:]}


def test_device_ops_go_to_the_innermost_span():
    att = spans.attribute(_raw())
    by = att["by_span"]
    assert att["lost"] == 0 and att["device_ops"] == 12
    assert by["stencil.prologue"] == {"ns": 2 * MS, "ops": 2,
                                      "generated_ns": 0, "generated_ops": 0}
    assert by["stencil.pad"]["ns"] == 6 * MS
    assert by["stencil.kernel"] == {"ns": 20 * MS, "ops": 2,
                                    "generated_ns": 20 * MS,
                                    "generated_ops": 2}
    assert by["stencil.update"]["ns"] == 4 * MS
    assert by["stencil.write_back"]["ns"] == 8 * MS
    # launched after stencil.call closed: reported, not dropped
    assert by[spans.UNATTRIBUTED] == {"ns": 2 * MS, "ops": 2,
                                      "generated_ns": 0, "generated_ops": 0}
    assert att["device_ns"] == sum(b - a for a, b, *_ in _raw()["device"])
    assert "stencil.call" not in by and "stencil.step" not in by


def test_records_lost_at_the_start_pair_from_the_end():
    att = spans.attribute(_raw(lost=1))
    assert att["lost"] == 1
    assert att["by_span"]["stencil.prologue"]["ops"] == 1
    assert att["by_span"]["stencil.kernel"]["generated_ops"] == 2


def test_the_devices_clock_may_run_ahead_of_the_hosts():
    """Every operation seems to start 2 ms before its call (the device's
    timestamps mapped onto the host's clock): the pairing stands."""
    raw = _raw()
    skewed = [(a - 2 * MS, b - 2 * MS, *rest) for a, b, *rest in raw["device"]]
    assert spans.attribute(dict(raw, device=skewed))["by_span"] == \
        spans.attribute(raw)["by_span"]


def test_a_stretch_that_does_not_pair_gives_nothing():
    raw = _raw()
    assert spans.attribute(dict(raw, device=raw["device"] + [
        (300 * MS, 301 * MS, "void extra", 0, 999)])) is None
    # a copy paired with a kernel launch
    swapped = [(a, b, "Memcpy DtoD" if "fill" in n else n, *rest)
               for a, b, n, *rest in raw["device"]]
    assert spans.attribute(dict(raw, device=swapped)) is None
    # a generated kernel whose id is a call's outside stencil.kernel
    early = [(a, b, n, card, corr + 1 if "g0_kernel" in n else
              corr - 1 if "elementwise_kernel add" in n else corr)
             for a, b, n, card, corr in raw["device"]]
    assert spans.attribute(dict(raw, device=early)) is None
    # a program without spans
    bare = dict(raw, host=[h for h in raw["host"]
                           if not h[2].startswith("stencil.")])
    assert spans.attribute(bare) is None
    assert spans.attribute(dict(raw, device=[])) is None


def test_summarise_is_unchanged_but_for_the_gaps_names():
    raw = _raw()
    bare = dict(raw, host=[h for h in raw["host"]
                           if not h[2].startswith("stencil.")])
    match = devtrace.generated_matcher(["g0"])
    with_spans, without = (devtrace.summarise(r, match) for r in (raw, bare))
    for key in without:
        if key not in ("idle_gaps", "raw"):
            assert with_spans[key] == without[key], key
    gaps = dict(with_spans["idle_gaps"])
    assert sum(gaps.values()) == sum(dict(without["idle_gaps"]).values())
    assert dict(without["idle_gaps"])["bench.call"] > 0
    # inside stencil.call no gap is put down to bench.call alone
    assert gaps.get("bench.call", 0) < dict(without["idle_gaps"])[
        "bench.call"]
    assert {"stencil.call", "stencil.step"} & set(gaps)


RUN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from bench import harness
cell = harness.load_cell(harness.Path(sys.argv[1]), sys.argv[2])
out = {}
for trace in (0, 1):
    res, _ = harness.run_cell(cell, 2**31 + 9, 0.2, bool(trace),
                              t0=time.perf_counter(), device="cpu",
                              grid=(16, 12, 8))
    assert res["correct"]
    out[trace] = {k: v["value"] for k, v in res["metrics"].items()}
print(json.dumps(out))
"""


def _run(root, cell):
    r = subprocess.run([sys.executable, "-c", RUN, str(root), cell],
                       capture_output=True, text=True, timeout=600,
                       cwd=root)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _gb_per_step(cell_name):
    """What the plan's padded shapes give a step at the test's grid, the
    carry written back in place: the padded carries and coefficients made
    once a call, then each pass (a step under the block schedule) copies
    the interior of every field the update changes."""
    from repro_torch import apps
    from repro_torch.core.pipeline import compile_program

    cell = harness.load_cell(harness.ROOT, cell_name)
    cfg, tr = cell.config, cell.traffic
    grid = (16, 12, 8)
    ex = compile_program(getattr(apps, cfg["program"])(cfg["boundary"]),
                         grid, steps=int(tr["steps"]),
                         update=getattr(apps, cfg["update"]["rule"])(
                             *cfg["update"].get("args", ())),
                         schedule=tr["schedule"],
                         time_tile=tr.get("time_tile"), device="cpu")
    spec, steps = ex.time_spec, int(tr["steps"])
    carry = sum(math.prod(g + int(spec.field_pad[f][a, 0])
                          + int(spec.field_pad[f][a, 1])
                          for a, g in enumerate(grid)) * 4
                for f in spec.persistent)
    coeff = sum((grid[k.coeff_axis[c]] + int(k.pad_lo[k.coeff_axis[c]])
                 + int(k.pad_hi[k.coeff_axis[c]])) * 4
                for k in ex.kernels for c in k.group_coeffs
                if k.pad_lo[k.coeff_axis[c]] or k.pad_hi[k.coeff_axis[c]])
    assert tr["schedule"] == "block" and len(ex.kernels) == 1
    interior = math.prod(grid) * 4
    return (carry + coeff + steps * len(cfg["writes"]) * interior) \
        / steps / 1e9


@pytest.mark.parametrize("cell,useful", [("tracer134m.fused4.block", 100 / 6),
                                         ("pw134m.fused10.block", 100.0)])
def test_a_cpu_run_reports_the_counters_and_no_device_time(root, cell,
                                                           useful):
    got = _run(root, cell)
    for name in NEW[:4]:
        assert name not in got["1"], name
    assert got["1"]["carry_useful_share"] == pytest.approx(useful)
    assert got["1"]["orchestrator_gb_per_step"] == pytest.approx(
        _gb_per_step(cell), rel=1e-12)
    assert not set(NEW) & set(got["0"])


def _older_commit(root):
    """The last commit whose orchestrator opened no ``stencil.*`` span."""
    r = subprocess.run(["git", "log", "--format=%H", "-S", "stencil.call",
                        "--", "src/repro_torch/core/lower_kernel.py"],
                       cwd=root, capture_output=True, text=True)
    if r.returncode:
        pytest.skip("needs the repository's git history")
    shas = r.stdout.split()
    return f"{shas[-1]}^" if shas else "HEAD"


def test_the_benchmark_on_an_older_program_reports_only_the_old_metrics(
        root, tmp_path):
    old = tmp_path / "older"
    old.mkdir()
    arc = subprocess.run(["git", "archive", _older_commit(root), "src"],
                         cwd=root, capture_output=True)
    if arc.returncode:
        pytest.skip("needs the repository's git history")
    subprocess.run(["tar", "-x", "-C", str(old)], input=arc.stdout,
                   check=True)
    assert "stencil." not in (old / "src/repro_torch/core/lower_kernel.py"
                              ).read_text()
    shutil.copytree(root / "bench", old / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", old / "BENCHMARK.json")
    try:
        got_old = _run(old, "tracer134m.fused4.block")
    finally:
        shutil.rmtree(old)
    got_new = _run(root, "tracer134m.fused4.block")
    assert set(got_old["0"]) == set(got_new["0"])
    assert set(got_new["1"]) - set(got_old["1"]) == {
        "orchestrator_gb_per_step", "carry_useful_share"}
    assert not set(NEW) & set(got_old["1"])
