"""Structure of the PyTorch port: fingerprints equal to the reference's, no
JAX anywhere in the port, the planner's groups and shared-memory fit, the
generated CUDA source, and the entry points' device and capability gates.

The tests that need the card are in ``tests/test_torch_cuda.py``.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.apps import pw_advection as ref_pw
from repro.apps import tracer_advection as ref_tracer
from repro.core.schedule import auto_plan as ref_auto_plan
from repro.core.schedule import program_fingerprint as ref_fingerprint
from repro_torch import compile_program, hw
from repro_torch.apps import pw_advection, tracer_advection
from repro_torch.core import ir
from repro_torch.core.schedule import (BLOCK_REGS, DataflowPlan, auto_plan,
                                       plan_from_dict, plan_to_dict,
                                       program_fingerprint, resident_threads,
                                       smem_cost)
from repro_torch.kernels import stencil3d

ROOT = pathlib.Path(__file__).resolve().parents[1]
APPS = [(ref_pw, pw_advection), (ref_tracer, tracer_advection)]
BOUNDARIES = ("zero", "periodic")
# the grids of the parity tests and of chip_smoke.py (the paper's 8M / 32M)
PLAN_GRIDS = [(8, 8, 32), (12, 10, 130), (256, 256, 128), (512, 256, 256)]


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("apps", APPS, ids=["pw", "tracer"])
def test_program_fingerprint_equals_reference(apps, boundary):
    """(a) The copied IR, frontend and app modules have not drifted."""
    ref_app, app = apps
    assert program_fingerprint(app(boundary)) == \
        ref_fingerprint(ref_app(boundary))


def test_port_imports_and_compiles_without_jax():
    """(b) With JAX made unimportable, the port imports and compiles both
    apps on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "from repro_torch.apps import pw_advection, tracer_advection\n"
        "for app in (pw_advection, tracer_advection):\n"
        "    p = app(); grid = (6, 8, 32)\n"
        "    rng = np.random.default_rng(0)\n"
        "    f = {k: rng.normal(size=grid).astype(np.float32) + 2\n"
        "         for k in p.input_fields()}\n"
        "    s = {k: 0.1 for k in p.scalars}\n"
        "    c = {k: np.ones(grid[a], np.float32)\n"
        "         for k, a in p.coeffs.items()}\n"
        "    out = repro_torch.compile_program(p, grid, device='cpu')(f, s, c)\n"
        "    assert all(v.shape == grid for v in out.values())\n"
        "assert 'repro' not in sys.modules and 'repro.core' not in sys.modules\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_sources_import_neither_jax_nor_the_reference():
    """(b) Static check over every port file, chip_smoke.py and
    tools/lm_turns.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    # the serving and mesh packages are scanned with the rest
    assert {"bucket.py", "engine.py", "stats.py", "__init__.py"} <= {
        f.name for f in files if f.parent.name == "serve"}
    assert {"sharding.py", "__init__.py"} <= {
        f.name for f in files if f.parent.name == "dist"}
    assert "distribute.py" in {f.name for f in files}
    # so are the training, data and checkpoint packages
    for pkg, names in (("train", {"optimizer.py", "compress.py", "loop.py"}),
                       ("data", {"pipeline.py"}),
                       ("checkpoint", {"store.py"}),
                       # and the dry run's, the LM roofline and Whisper
                       ("launch", {"dryrun.py", "mesh.py", "specs.py"}),
                       ("analysis", {"roofline.py"}),
                       ("models", {"whisper.py"})):
        assert names | {"__init__.py"} <= {
            f.name for f in files if f.parent.name == pkg}, pkg
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "lm_turns.py"]
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


@pytest.mark.parametrize("grid", PLAN_GRIDS)
@pytest.mark.parametrize("apps", APPS, ids=["pw", "tracer"])
def test_auto_plan_keeps_reference_groups_and_fits_shared_memory(apps, grid):
    """(e) Fuse groups equal the reference planner's; only the tile
    differs, and its staged windows fit one CTA's 227 KB."""
    ref_app, app = apps
    p = app()
    plan = auto_plan(p, grid)
    assert plan.groups == [list(g) for g in ref_auto_plan(ref_app(),
                                                          grid).groups]
    assert smem_cost(p, plan, grid) <= hw.H100.smem_per_block
    blk = tuple(min(b, g) for b, g in zip(plan.block, grid))
    assert blk[-1] == grid[-1] or blk[-1] % 32 == 0


def test_resident_threads_follow_the_h100_limits():
    """Occupancy as shared memory (1 KB kept per CTA), the 2048-thread
    limit and, given the registers a thread holds, the register file
    allow; the planner keeps the SM as full as the registers it plans the
    block kernel with (64 a thread: 1024 threads) let it."""
    assert resident_threads((8, 8, 64), 79_200) == 2 * 512      # smem
    assert resident_threads((4, 16, 32), 44_064) == 4 * 512     # threads
    assert resident_threads((1, 4, 64), 186_624) == 256         # one CTA
    assert resident_threads((4, 16, 32), 44_064, 64) == 2 * 512  # registers
    assert resident_threads((4, 8, 32), 44_064, 128) == 2 * 256
    for grid in [(256, 256, 128), (512, 256, 256)]:
        p = pw_advection()
        plan = auto_plan(p, grid)
        assert resident_threads(plan.block, smem_cost(p, plan, grid),
                                BLOCK_REGS) \
            == hw.H100.registers_per_sm // BLOCK_REGS
        p = tracer_advection()
        plan = auto_plan(p, grid)
        assert resident_threads(plan.block, smem_cost(p, plan, grid),
                                BLOCK_REGS) >= 512


def test_smem_cost_counts_dtype_bytes():
    """The CTA's byte count is right for every dtype (float64 is 8 B).
    pw_advection reads no op at an offset, so its CTA holds one ring per
    input (3): 4 planes (axis-0 reads at -1..+1 and the plane in flight)
    of 10 rows (the tile's 8 and a halo row each side) by 66 columns (64
    and a halo column each side) padded to a multiple of 16 bytes."""
    p = pw_advection()
    grid = (64, 64, 128)
    costs = {dt: smem_cost(p, DataflowPlan(groups=[[0, 1, 2]],
                                           block=(8, 8, 64), dtype=dt), grid)
             for dt in ("bfloat16", "float32", "float64")}
    want = {dt: 3 * 4 * 10 * (-(-66 * isz // 16) * 16)
            for dt, isz in (("bfloat16", 2), ("float32", 4), ("float64", 8))}
    assert costs == want == {"bfloat16": 17_280, "float32": 32_640,
                             "float64": 63_360}


def test_plan_dict_round_trip():
    plan = auto_plan(tracer_advection(), (256, 256, 128))
    assert plan_from_dict(plan_to_dict(plan)) == plan


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("app", [pw_advection, tracer_advection])
def test_generated_source_maps_every_op_and_has_no_double_literals(app,
                                                                   boundary):
    """(g) The emitter produces the kernel without nvcc: one kernel and one
    C entry per group, every float literal ``f``-suffixed, no fast-math
    intrinsics."""
    p = app(boundary)
    grid = (256, 256, 128)
    plan = auto_plan(p, grid)
    calls = [stencil3d.build_group_call(p, g, plan.block, grid)
             for g in plan.groups]
    src = stencil3d.KernelModule(calls).source
    for i in range(len(calls)):
        assert f"g{i}_kernel(" in src and f'extern "C" int g{i}_launch(' in src
    assert "cudaGetLastError()" in src
    code = re.sub(r"//[^\n]*", "", src)
    floats = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[+-]?\d+)?|\d+e[+-]?\d+)(f?)",
                        code)
    assert floats and all(suffix == "f" for _, suffix in floats), \
        [x for x, s in floats if s != "f"][:5]
    assert not re.search(r"__(?:expf|logf|fdividef|sinf|powf)\b", code)


def test_emitter_maps_every_op_kind():
    """(g) Every BinOpKind, UnOpKind and CmpKind has an exact C++ form:
    a program using all of them emits, and the ops appear."""
    from repro_torch.core.frontend import ProgramBuilder

    b = ProgramBuilder("all_ops", ndim=3)
    x, y = b.inputs("x", "y")
    o = b.output("o")
    e = x[0, 0, 0]
    r = y[1, 0, -1]
    terms = [ir.BinOp(k, e.expr, r.expr) for k in ir.BinOpKind]
    terms += [ir.UnOp(k, e.expr) for k in ir.UnOpKind]
    terms += [ir.Select(ir.Cmp(k, e.expr, r.expr), ir.Const(1.5),
                        ir.Const(-0.25)) for k in ir.CmpKind]
    acc = terms[0]
    for t in terms[1:]:
        acc = ir.BinOp(ir.BinOpKind.ADD, acc, t)
    b.define(o, acc)
    p = b.build()
    call = stencil3d.build_group_call(p, [0], (4, 4, 32), (8, 8, 64))
    src = call.source()
    for frag in ("powf(", "rmin(", "rmax(", "fabsf(", "sqrtf(", "expf(",
                 "logf(", "tanhf(", "rsign(", " < ", " <= ", " > ",
                 " >= ", " == ", "1.5f", "(-0.25f)"):
        assert frag in src, frag


def test_float_literals_are_float32():
    assert stencil3d.float_literal(0.5) == "0.5f"
    assert stencil3d.float_literal(-2) == "(-2.0f)"
    assert stencil3d.float_literal(1e-6) == "1e-06f"
    for v in (0.1, 1 / 3, 2.5e-7, 123456.789):
        # the literal parses back to exactly the float32 the value rounds to
        assert np.float32(stencil3d.float_literal(v)[:-1]) == np.float32(v)


def test_entry_points_default_to_the_card():
    """Without device='cpu' a compile runs on the card, and raises rather
    than fall back to the CPU when no card is present."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_program(pw_advection(), (8, 8, 32))


def test_mesh_entry_points_never_fall_back_to_the_cpu():
    """A mesh whose shards sit on the card raises without one, and
    ``make_auto_mesh`` without ``devices=`` takes cards only; neither
    places a shard on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh's devices are usable")
    from repro_torch.dist import make_auto_mesh
    mesh = make_auto_mesh((2, 2), ("X", "Y"), devices=["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_program(pw_advection(), (8, 8, 32), mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA devices, found 0"):
        make_auto_mesh((1,), ("X",))


def test_tuned_strategy_compiles_on_the_cpu(tmp_path):
    """``strategy="tuned"`` searches on the CPU (plain versions, host
    clock) and stores its winner where ``plan_cache`` says."""
    from repro_torch.core import PlanCache, TuneConfig

    path = tmp_path / "plans.json"
    ex = compile_program(pw_advection(), (8, 8, 32), device="cpu",
                         strategy="tuned",
                         tune_config=TuneConfig(max_measured=2, repeats=1),
                         plan_cache=PlanCache(str(path)))
    assert ex.plan.backend == "cuda" and path.exists()


def test_unknown_option_and_backend_are_rejected():
    with pytest.raises(TypeError, match="unknown compile option"):
        compile_program(pw_advection(), (8, 8, 32), device="cpu",
                        interpret=True)
    with pytest.raises(ValueError, match="unknown backend"):
        compile_program(pw_advection(), (8, 8, 32), device="cpu",
                        backend="pallas")


def test_plain_version_counts_no_launches():
    p = pw_advection()
    before = stencil3d.launches
    rng = np.random.default_rng(0)
    grid = (4, 6, 32)
    f = {k: rng.normal(size=grid).astype(np.float32) for k in "uvw"}
    compile_program(p, grid, device="cpu")(
        f, {"tcx": 0.1, "tcy": 0.1},
        {c: np.ones(32, np.float32) for c in p.coeffs})
    assert stencil3d.launches == before
