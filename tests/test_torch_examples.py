"""The port's examples (``examples_torch/``) on the CPU, against the
reference.

Every example runs once, at a small size with ``--device cpu``, in ONE
subprocess in which ``import jax`` and ``import repro`` fail
(``sys.modules[...] = None``): each example's ``main(argv)`` is called with
its standard output captured, and what it returns (its arrays, a training
history, generated ids) is saved under the test's temporary directory.
Each example must end with the closing line its counterpart in
``examples/`` prints (``quickstart OK``, ``pw_advection OK``, ...; the
stream walkthrough's last timing line, the trace example's JSON summary),
and its numbers are held here to the reference's ``compile_program``
(``jnp_naive`` single steps at 1e-5 of the output's max abs, ``jnp_fused``
loops at 1e-5), to the reference's ``ServeEngine`` (greedy ids equal) or
to the reference's ``Trainer`` (losses and grad norms at the bfloat16
LM's 2e-2), on the same inputs.  An
example also refuses to run without a card unless given ``--device
cpu``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.apps import (pw_advection, pw_advection_update, tracer_advection,
                        tracer_advection_update)
from repro.core import ProgramBuilder
from repro.core import compile_program as ref_compile
from repro.core import run_time_loop as ref_loop

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
TOL = 1e-5

# run name -> (example, argv); the device and the output paths are added
RUNS = {
    "quickstart": ("quickstart", ["--grid", "8,8,32"]),
    "pw_advection": ("pw_advection", ["--size", "16K", "--steps", "3"]),
    "pw_advection_fused": ("pw_advection", ["--size", "16K", "--steps", "3",
                                            "--fused-loop"]),
    "tracer_advection": ("tracer_advection", ["--size", "16K", "--steps",
                                              "2"]),
    "tracer_advection_fused": ("tracer_advection", ["--size", "16K",
                                                    "--steps", "2",
                                                    "--fused-loop"]),
    "stream_schedule": ("stream_schedule", ["--grid", "8,8,32", "--steps",
                                            "5", "--time-tile", "2",
                                            "--plane-tile", "2"]),
    "autotune": ("autotune", ["--grid", "8,8,32", "--steps", "3"]),
    "distributed_stencil": ("distributed_stencil", ["--grid", "8,8,32",
                                                    "--steps", "4"]),
    "serve_stencils": ("serve_stencils", ["--requests", "4", "--steps",
                                          "2"]),
    "trace_compile": ("trace_compile", []),
    "serve_lm": ("serve_lm", ["--tokens", "6", "--temperature", "0"]),
    "serve_lm_swa": ("serve_lm", ["--arch", "gemma3_1b", "--tokens", "6",
                                  "--temperature", "0", "--batch", "2"]),
    "train_lm": ("train_lm", ["--steps", "3"]),
}

# the closing line of each example, as its counterpart in examples/ ends
CLOSING = {
    "quickstart": r"quickstart OK",
    "pw_advection": r"pw_advection OK",
    "pw_advection_fused": r"pw_advection fused-loop OK",
    "tracer_advection": r"tracer_advection OK",
    "tracer_advection_fused": r"tracer_advection fused-loop OK",
    "stream_schedule": r"\s*stream/P=2/T=2: +[\d.]+ steps/s \(\d+ us for 5 "
                       r"fused steps\)",
    "autotune": r"autotune OK",
    "distributed_stencil": r"distributed_stencil OK",
    "serve_stencils": r"serve_stencils OK",
    "trace_compile": r"}",
    "serve_lm": r"serve_lm OK",
    "serve_lm_swa": r"serve_lm OK",
    "train_lm": r"train_lm OK",
}

DRIVER = r"""
import contextlib, importlib.util, io, json, sys, time, traceback
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch

runs, examples, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]


def flat(x, key, acc):
    if isinstance(x, dict):
        for k, v in x.items():
            flat(v, f"{key}/{k}" if key else str(k), acc)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            flat(v, f"{key}/{i}" if key else str(i), acc)
    elif isinstance(x, torch.Tensor):
        acc[key or "result"] = x.detach().cpu().numpy()
    else:
        acc[key or "result"] = np.asarray(x)
    return acc


report = {}
for name, (example, argv) in runs.items():
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", f"{examples}/{example}.py")
    buf, t0 = io.StringIO(), time.perf_counter()
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        np.savez(f"{out}/{name}.npz", **flat(res, "", {}))
        err = None
    except BaseException:
        err = traceback.format_exc()
    report[name] = {"stdout": buf.getvalue(), "error": err,
                    "seconds": time.perf_counter() - t0}
with open(f"{out}/report.json", "w") as fh:
    json.dump(report, fh)
"""


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """Every run of RUNS in one subprocess without jax or repro: name ->
    (report, arrays)."""
    out = tmp_path_factory.mktemp("examples")
    runs = {}
    for name, (example, argv) in RUNS.items():
        argv = argv + ["--device", "cpu"]
        if example == "trace_compile":
            argv += ["--out", str(out / "TRACE.json")]
        if example == "train_lm":
            argv += ["--ckpt-dir", str(out / "ckpt")]
        runs[name] = (example, argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", DRIVER, json.dumps(runs),
                          str(EXAMPLES), str(out)], capture_output=True,
                         text=True, env=env, timeout=600, cwd=out)
    assert res.returncode == 0, res.stderr[-4000:]
    report = json.loads((out / "report.json").read_text())

    def load(name):
        rep = report[name]
        assert rep["error"] is None, rep["error"]
        with np.load(out / f"{name}.npz") as z:
            return rep, {k: z[k] for k in z.files}
    return load, out


def _within(got, want, tol=TOL, what=""):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    assert err <= tol * max(float(np.abs(w).max()), 1e-30), (what, err)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_without_jax_and_closes_as_the_reference(ran, name):
    load, _ = ran
    rep, _ = load(name)
    lines = rep["stdout"].rstrip("\n").splitlines()
    assert lines and re.fullmatch(CLOSING[name], lines[-1]), lines[-3:]


REFUSE = r"""
import importlib.util, json, sys
import torch
torch.cuda.is_available = lambda: False
examples, said = sys.argv[1], {}
for name, argv in json.loads(sys.argv[2]):
    spec = importlib.util.spec_from_file_location(
        "example_" + name, f"{examples}/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        mod.main(argv)
        said[" ".join([name] + argv)] = "ran"
    except RuntimeError as e:
        said[" ".join([name] + argv)] = str(e)
print(json.dumps(said))
"""

# (example, argv) run where torch sees no card: each must raise
NO_CARD = sorted([(e, []) for e in {e for e, _ in RUNS.values()}]
                 + [("distributed_stencil", ["--devices"])])


@pytest.fixture(scope="module")
def refusals():
    """What each run of NO_CARD raised, in one subprocess whose torch has
    no card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", REFUSE, str(EXAMPLES),
                          json.dumps(NO_CARD)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("example,argv", NO_CARD,
                         ids=[" ".join([e] + a) for e, a in NO_CARD])
def test_example_needs_a_card_or_the_cpu(refusals, example, argv):
    """Without ``--device`` an example takes the card, and raises before
    any work where there is none (``--devices``: a card a shard)."""
    said = refusals[" ".join([example] + argv)]
    want = ("a mesh of 8 shards needs 8 CUDA devices" if argv
            else "no CUDA device is available")
    assert said.startswith(want), said


# --------------------------------------------------------------------------
# the numbers, against the reference on the same inputs
# --------------------------------------------------------------------------

def _pw_inputs(grid):
    rng = np.random.default_rng(0)
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in ("u", "v", "w")}
    scalars = {"tcx": np.float32(0.05), "tcy": np.float32(0.05)}
    coeffs = {c: np.linspace(0.9, 1.1, grid[2]).astype(np.float32)
              for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
    return fields, scalars, coeffs


def _tracer_inputs(grid):
    rng = np.random.default_rng(1)
    fields = {
        "t": rng.normal(size=grid).astype(np.float32) + 15.0,
        "un": rng.normal(size=grid).astype(np.float32) * 0.2,
        "vn": rng.normal(size=grid).astype(np.float32) * 0.2,
        "wn": rng.normal(size=grid).astype(np.float32) * 0.05,
        "e3t": np.abs(rng.normal(size=grid)).astype(np.float32) + 1.0,
        "msk": (rng.uniform(size=grid) > 0.05).astype(np.float32),
    }
    scalars = {"rdt": np.float32(0.05), "zeps": np.float32(1e-6)}
    coeffs = {"ztfreez": np.full(grid[2], -1.8, np.float32)}
    return fields, scalars, coeffs


def test_quickstart_matches_the_reference(ran):
    _, got = ran[0]("quickstart")
    grid = (8, 8, 32)
    b = ProgramBuilder("diffusion", ndim=3)
    u = b.input("u")
    alpha = b.scalar("alpha")
    b.define(b.output("u_next"), u[0, 0, 0] + alpha * (
        u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0]
        + u[0, 0, 1] + u[0, 0, -1] - 6.0 * u[0, 0, 0]))
    fields = {"u": np.random.default_rng(0).normal(size=grid)
              .astype(np.float32)}
    want = ref_compile(b.build(), grid, backend="jnp_naive")(
        fields, {"alpha": np.float32(0.1)})["u_next"]
    assert set(got) == {"torch_naive", "torch_fused", "cuda"}
    for k, v in got.items():
        _within(v, want, what=k)


def test_pw_advection_matches_the_reference(ran):
    _, got = ran[0]("pw_advection")
    grid = (16, 16, 64)
    f, s, c = _pw_inputs(grid)
    want = ref_loop(ref_compile(pw_advection(), grid, backend="jnp_naive"),
                    f, s, c, 3, pw_advection_update(0.1))
    for k in ("u", "v", "w"):
        _within(got[k], want[k], what=k)
    _, loop = ran[0]("pw_advection_fused")
    want = ref_compile(pw_advection(), grid, backend="jnp_fused", steps=3,
                       update=pw_advection_update(0.1))(f, s, c)
    for mode in ("host loop", "fused loop"):
        for k in ("u", "v", "w"):
            _within(loop[f"{mode}/{k}"], want[k], what=(mode, k))


def test_tracer_advection_matches_the_reference(ran):
    _, got = ran[0]("tracer_advection")
    grid = (16, 16, 64)
    f, s, c = _tracer_inputs(grid)
    one = ref_compile(tracer_advection(), grid, backend="jnp_naive")
    want = one(f, s, c)["ta"]
    for k in ("fused", "per_field", "auto"):
        _within(got[k], want, what=k)
    tr = f["t"]
    for _ in range(2):
        tr = np.asarray(one(dict(f, t=tr), s, c)["ta"])
    _within(got["t"], tr, what="t")
    _, loop = ran[0]("tracer_advection_fused")
    want = ref_compile(tracer_advection(), grid, backend="jnp_fused",
                       steps=2, update=tracer_advection_update())(f, s, c)
    for mode in ("host loop", "fused loop"):
        _within(loop[mode], want["t"], what=mode)


def _pw_loop(grid, steps, dt, boundary="zero"):
    rng = np.random.default_rng(0)
    p = pw_advection(boundary=boundary)
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in p.input_fields()}
    scalars = {sc: np.float32(0.05) for sc in p.scalars}
    coeffs = {c: np.linspace(0.9, 1.1, grid[ax]).astype(np.float32)
              for c, ax in p.coeffs.items()}
    return ref_compile(p, grid, backend="jnp_fused", steps=steps,
                       update=pw_advection_update(dt))(fields, scalars,
                                                       coeffs)


def test_stream_schedule_matches_the_reference(ran):
    _, got = ran[0]("stream_schedule")
    want = _pw_loop((8, 8, 32), 5, 0.1)
    labels = {k.split("/u")[0] for k in got if k.endswith("/u")}
    assert labels == {"block", "stream", "stream/T=2", "stream/P=2",
                      "stream/P=2/T=2"}
    for label in labels:
        for k in ("u", "v", "w"):
            _within(got[f"{label}/{k}"], want[k], what=(label, k))


def test_autotune_matches_the_reference(ran):
    _, got = ran[0]("autotune")
    want = _pw_loop((8, 8, 32), 3, 0.1)
    for k in ("u", "v", "w"):
        _within(got[k], want[k], what=k)


def test_distributed_stencil_matches_the_reference(ran):
    _, got = ran[0]("distributed_stencil")
    grid = (8, 8, 32)
    f, s, c = _pw_inputs(grid)
    one = ref_compile(pw_advection(), grid, backend="jnp_naive")(f, s, c)
    for k in one:
        _within(got[f"single/{k}"], one[k], 1e-4, what=k)
    for boundary in ("zero", "periodic"):
        want = ref_compile(pw_advection(boundary=boundary), grid,
                           backend="jnp_fused", steps=4,
                           update=pw_advection_update(0.05))(f, s, c)
        for k in ("u", "v", "w"):
            _within(got[f"{boundary}/{k}"], want[k], what=(boundary, k))


def test_serve_stencils_matches_the_reference(ran):
    _, got = ran[0]("serve_stencils")
    grids = [(16, 16, 16), (12, 14, 16), (16, 16, 24), (10, 16, 16)]
    rng = np.random.default_rng(0)
    for i, grid in enumerate(grids):
        fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
                  for f in ("u", "v", "w")}
        coeffs = {c: np.linspace(0.9, 1.1, grid[2]).astype(np.float32)
                  for c in ("tzc1", "tzc2", "tzd1", "tzd2")}
        want = ref_compile(pw_advection(), grid, backend="jnp_fused",
                           steps=2, update=pw_advection_update(0.1))(
            fields, {"tcx": 0.05, "tcy": 0.05}, coeffs)
        for k in ("u", "v", "w"):
            _within(got[f"{i}/{k}"], want[k], what=(grid, k))


def test_trace_compile_matches_the_reference(ran):
    rep, got = ran[0]("trace_compile")
    out = ran[1]
    trace = json.loads((out / "TRACE.json").read_text())
    assert trace
    grid = (16, 16, 16)
    want = _pw_loop(grid, 3, 0.1)
    for k in ("u", "v", "w"):
        _within(got[f"tuned/{k}"], want[k], what=k)
    rng = np.random.default_rng(0)
    p = pw_advection()
    fields = {f: rng.normal(size=grid).astype(np.float32) * 0.1
              for f in p.input_fields()}
    one = ref_compile(p, grid, backend="jnp_naive")(
        fields, {sc: np.float32(0.05) for sc in p.scalars},
        {c: np.linspace(0.9, 1.1, grid[ax]).astype(np.float32)
         for c, ax in p.coeffs.items()})
    for i in range(4):
        for k in one:
            _within(got[f"served/{i}/{k}"], one[k], what=(i, k))
    summary = json.loads(rep["stdout"][rep["stdout"].index("{"):])
    assert summary["tune_candidates"] >= 2 and summary["serve_batches"] >= 1


def _port_lm(cfg):
    """The examples' weights: the port's ``init_lm`` from a generator
    seeded 0, on the CPU, as the reference's tree."""
    import torch

    from repro_torch.interop import lm_tree_to_reference
    from repro_torch.models import init_lm

    lm = init_lm(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    return lm_tree_to_reference(cfg, dict(lm.named_parameters()))


@pytest.mark.parametrize("name,arch,batch", [("serve_lm", "gemma2_2b", 4),
                                             ("serve_lm_swa", "gemma3_1b",
                                              2)])
def test_serve_lm_matches_the_reference(ran, name, arch, batch):
    """Greedy ids equal the reference ``ServeEngine``'s on the same
    weights and prompts."""
    import jax

    from repro.configs import get_smoke as ref_smoke
    from repro.models import ServeEngine as RefServeEngine
    from repro_torch.configs import get_smoke

    _, got = ran[0](name)
    tree = jax.tree.map(jax.numpy.asarray, _port_lm(get_smoke(arch)))
    cfg = ref_smoke(arch)
    eng = RefServeEngine(cfg, tree, batch=batch, max_len=256,
                         temperature=0.0)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, 12)).astype(np.int32)
    want = eng.generate(prompts, max_new_tokens=6, seed=1)
    np.testing.assert_array_equal(got["result"], np.asarray(want))


def test_train_lm_matches_the_reference(ran, tmp_path):
    """Three steps of the tiny preset (bfloat16 over float32 masters):
    each step's loss and grad norm equal the reference ``Trainer``'s from
    the same initial weights on the same synthetic batches, at the LM's
    bfloat16 tolerance, 2e-2."""
    import jax

    from repro.configs.base import ModelConfig as RefModelConfig
    from repro.data import BatchSpec as RefBatchSpec
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro.train import OptConfig as RefOptConfig
    from repro.train import TrainConfig as RefTrainConfig
    from repro.train import Trainer as RefTrainer
    from repro_torch.configs.base import ModelConfig

    _, got = ran[0]("train_lm")
    shape = dict(name="tiny-lm", n_layers=2, d_model=128, n_heads=4,
                 n_kv_heads=2, d_ff=256, vocab=2048, window=64,
                 layer_pattern=("local",))
    tree = _port_lm(ModelConfig(**shape))
    ref = RefTrainer(RefModelConfig(**shape), RefTrainConfig(
        opt=RefOptConfig(lr=3e-4, warmup_steps=20, total_steps=100),
        ckpt_every=50, ckpt_dir=str(tmp_path / "ref"), log_every=10),
        RefSyntheticLM(RefBatchSpec(global_batch=8, seq_len=64, vocab=2048),
                       seed=0))
    ref.state["params"] = jax.tree.map(jax.numpy.asarray, tree)
    want = ref.run(3)
    for step, w in enumerate(want):
        for k in ("loss", "grad_norm"):
            g = float(got[f"{step}/{k}"])
            assert abs(g - w[k]) <= 2e-2 * abs(w[k]), (step, k, g, w[k])
