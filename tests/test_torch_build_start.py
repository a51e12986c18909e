"""Kernel builds started ahead of their first launch
(``repro_torch.kernels.build.start``), through a stand-in ``nvcc`` that
copies its source to its output: a started build is waited for, not run
again, by the ``build_many`` of the launch; a build no launch waited for
is published when the process exits; without ``nvcc`` nothing starts;
and a compile for the CPU starts no build."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch import compile_program
from repro_torch.apps import pw_advection
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = """#!{python}
import sys, time
out, src = sys.argv[sys.argv.index("-o") + 1], sys.argv[-1]
time.sleep(0.2)
with open(src) as f, open(out, "w") as g:
    g.write(f.read())
"""

STARTED_THEN_BUILT = """
import sys
from repro_torch.kernels import build
sources = sys.argv[1:]
build.start(sources)
started = build.runs
paths = build.build_many(sources)
print(started, build.runs, *paths)
"""

STARTED_THEN_EXIT = """
import sys
from repro_torch.kernels import build
build.start(sys.argv[1:])
print(build.runs)
"""


def _fake_nvcc(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    env = dict(os.environ, NVCC=str(nvcc), REPRO_TORCH_BUILD=str(out),
               PYTHONPATH=str(ROOT / "src"))
    return out, env


def _run(script, args, env):
    proc = subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_a_started_build_is_waited_for_not_run_again(tmp_path):
    out, env = _fake_nvcc(tmp_path)
    sources = ["// a\n", "// b\n", "// a\n"]
    started, runs, *paths = _run(STARTED_THEN_BUILT, sources, env)
    assert (started, runs) == ("2", "2")
    assert [Path(p).read_text() for p in paths] == sources
    assert not [f for f in os.listdir(out) if ".tmp" in f]


def test_a_build_no_launch_waited_for_is_published_at_exit(tmp_path):
    out, env = _fake_nvcc(tmp_path)
    (runs,) = _run(STARTED_THEN_EXIT, ["// c\n"], env)
    assert runs == "1"
    (so,) = [f for f in os.listdir(out) if f.endswith(".so")]
    assert (out / so).read_text() == "// c\n"
    assert (out / so).with_suffix(".log").exists()
    assert not [f for f in os.listdir(out) if ".tmp" in f]


def test_without_nvcc_nothing_starts(monkeypatch):
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc", missing)
    runs = build.runs
    build.start(["// d\n"])
    assert build.runs == runs and not build._STARTED


def test_a_compile_for_the_cpu_starts_no_build(tmp_path, monkeypatch):
    out, env = _fake_nvcc(tmp_path)
    monkeypatch.setenv("NVCC", env["NVCC"])
    monkeypatch.setenv("REPRO_TORCH_BUILD", env["REPRO_TORCH_BUILD"])
    runs = build.runs
    ex = compile_program(pw_advection(), (8, 8, 32), device="cpu")
    assert ex.kernels and ex.kernels[0].module is not None
    rng = np.random.default_rng(0)
    ex({f: rng.standard_normal((8, 8, 32)).astype(np.float32)
        for f in ex.program.input_fields()},
       {s: np.float32(0.1) for s in ex.program.scalars},
       {c: np.ones(32 if ax == 2 else 8, np.float32)
        for c, ax in ex.program.coeffs.items()})
    assert build.runs == runs and not build._STARTED
    assert not out.exists()
