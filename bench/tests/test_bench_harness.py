"""The yardstick, ``BENCHMARK.json`` against the benchmark's contract, the
harness finding a new cell's files by name, and the runner refusing to run
without a card."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from bench import harness, roofline

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture
def bm(root):
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("config,steps,ms,bound", [
    ("pw_advection_134m", 10, 1.2620, "operations"),
    ("tracer_advection_134m", 4, 1.1218, "bytes")])
def test_least_time_of_a_call(root, config, steps, ms, bound):
    cfg = harness.load_json(root / "bench" / "configs" / f"{config}.json")
    t, what = roofline.least_time(cfg, cfg["grid"], steps)
    assert round(t * 1e3, 4) == ms and what == bound


def test_least_time_parts(root):
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_134m.json")
    nbytes, ops = roofline.call_work(cfg, cfg["grid"], 10)
    assert round(nbytes / 1e9, 3) == 3.221 and round(ops / 1e9, 2) == 84.56
    cfg = harness.load_json(root / "bench" / "configs"
                            / "tracer_advection_134m.json")
    nbytes, ops = roofline.call_work(cfg, cfg["grid"], 4)
    assert round(nbytes / 1e9, 3) == 3.758 and round(ops / 1e9, 2) == 72.48


def test_flops_per_point_is_the_programs_count(root):
    from repro_torch import apps

    for config in ("pw_advection_134m", "tracer_advection_134m"):
        cfg = harness.load_json(root / "bench" / "configs"
                                / f"{config}.json")
        p = getattr(apps, cfg["program"])(cfg["boundary"])
        assert p.flops_per_point() == cfg["flops_per_point"]
        assert sorted(p.input_fields()) == sorted(cfg["reads"])


def test_names_units_and_keys(bm):
    assert set(bm) == KEYS
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bm[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    assert len(set(names)) == len(names)
    assert 1 <= bm["run_seconds"] <= 51


def test_every_moves_is_reported_where_the_metric_is(bm):
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    cells = [w["name"] for w in bm["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in bm["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        here = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in here and len(here) >= 2
        assert any(reports(m, cell) for m in bm["per_layer"])


def test_every_file_is_found_by_name(root, bm):
    for w in bm["workloads"]:
        cell = harness.load_cell(root, w["name"])
        assert cell.config["name"] == w["config"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(root, m["name"]))


def test_a_dropped_in_cell_is_found(root, bm, tmp_path):
    """A configuration, a traffic mix, a limit and a metric reader added
    as files of their own; no existing file of bench/ edited."""
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(root / "src")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    cfg = harness.load_json(root / "bench" / "configs"
                            / "pw_advection_134m.json")
    cfg.update(name="pw_advection_small", grid=[16, 12, 8])
    (tmp_path / "bench" / "configs" / "pw_advection_small.json") \
        .write_text(json.dumps(cfg))
    tr = harness.load_json(root / "bench" / "traffic"
                           / "fused10.block.json")
    tr.update(steps=3)
    (tmp_path / "bench" / "traffic" / "fused3.block.json") \
        .write_text(json.dumps(tr))
    (tmp_path / "bench" / "limits" / "pwsmall.fused3.block.json") \
        .write_text(json.dumps({"rel_err": 1e-3}))
    (tmp_path / "bench" / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return len(run.call_s)\n")
    bm = json.loads(json.dumps(bm))
    bm["configs"].append({"name": "pw_advection_small", "source": "x",
                          "file": "bench/configs/pw_advection_small.json",
                          "reduced": ["grid"], "why": "test"})
    bm["workloads"].append({"name": "pwsmall.fused3.block",
                            "config": "pw_advection_small",
                            "traffic": "fused3.block", "chips": 1,
                            "why": "test"})
    bm["end_to_end"].append({"name": "calls_done", "unit": "calls",
                             "better": "higher", "bound": 0.25,
                             "source": "host_clock",
                             "workloads": ["pwsmall.fused3.block"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    cell = harness.load_cell(tmp_path, "pwsmall.fused3.block")
    res, _ = harness.run_cell(cell, 7, 0.2, False, t0=time.perf_counter(),
                              device="cpu")
    assert res["correct"]
    assert res["metrics"]["calls_done"]["value"] == res["attempted"]
    assert {"gpts_per_s", "call_p95_ms", "setup_s"} <= set(res["metrics"])
    for p, data in before.items():
        assert p.read_bytes() == data, p
    old = harness.load_cell(tmp_path, "pw134m.fused10.block")
    assert "calls_done" not in [m["name"] for m in old.end_to_end]


def test_without_the_program_the_run_fails(root, tmp_path):
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cell = harness.load_cell(tmp_path, "pw134m.fused10.block")
    with pytest.raises((ImportError, RuntimeError)):
        harness.run_cell(cell, 1, 0.1, False, t0=time.perf_counter(),
                         device="cpu", grid=(8, 8, 8))


def test_the_runner_refuses_without_a_card(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "pw134m.fused10.block", "--seed", str(2**31 + 3),
                        "--seconds", "1", "--trace", "0"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA card" in r.stderr


def test_nothing_forbidden_in_the_runners_process(root):
    code = ("import sys; sys.argv=['x']; sys.path.insert(0, '.');"
            "from bench import harness;"
            "harness.import_program(harness.ROOT);"
            "import repro_torch.apps;"
            "print(harness.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.stdout.strip() == "[]", r.stderr


def test_energy_integrates_the_samples(monkeypatch):
    from bench import power

    monkeypatch.setattr(power, "_nvidia_smi", lambda: "nvidia-smi")
    p = power.PowerSampler("GPU-x", interval_ms=100)
    p.samples = [(0.05 + 0.1 * i, 500.0 + (i % 2) * 100) for i in range(20)]
    assert abs(p.energy_j(0.0, 2.0) - 1100.0) < 1.0
    with pytest.raises(RuntimeError):
        p.energy_j(10.0, 12.0)


def test_trace_summary_splits_busy_idle_and_kernels():
    from bench import devtrace

    ms = 1_000_000
    raw = {"calls": 2, "host": [
        (0, 10 * ms, "bench.call", 1, 0), (10 * ms, 20 * ms, "bench.call", 1, 0),
        (4 * ms, 6 * ms, "aten::constant_pad_nd", 1, 0)],
        "device": [(1 * ms, 4 * ms, "void g0_kernel<false>(float*)", 0, 1),
                   (6 * ms, 9 * ms, "void at::native::fill_kernel", 0, 2),
                   (8 * ms, 10 * ms, "void g12_kernel<true>(float*)", 0, 3),
                   (12 * ms, 20 * ms, "Memcpy DtoD (Device -> Device)", 0, 4)]}
    s = devtrace.summarise(raw, devtrace.generated_matcher(["g0", "g12"]))
    assert s["window_s"] == 0.02 and s["busy_s"] == 0.015
    assert s["generated_ops"] == 2 and s["device_ops"] == 4
    assert abs(s["generated_s"] - 0.005) < 1e-12
    assert abs(s["aux_s"] - 0.011) < 1e-12
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::constant_pad_nd"] == 0.002
    assert abs(gaps["bench.call"] - 0.003) < 1e-12
    assert s["top"][0][0] == "Memcpy DtoD (Device -> Device)"
    assert not devtrace.generated_matcher(["g1"])("void g12_kernel<false>")
