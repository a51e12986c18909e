"""Sharded LM training on a real ``torch.distributed`` mesh: the port's
``Trainer(rules=)``, ``make_train_step(rules=)``,
``restore_checkpoint(shardings=)`` and compression over DTensors, on 4
gloo ranks of a (2, 2) ``("data", "model")`` CPU mesh under the dry run's
train rules (TP over ``model``, FSDP over ``data``, the batch over
``data``).

Two launches, started together by module-scoped fixtures:

* the reference: one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` running
  ``repro.train.Trainer(rules=)`` on a (2, 2) mesh of fake XLA CPU devices,
  Danube and mixtral smoke in float32, three steps;
* the port: this file run as a script, which starts 4 rank processes
  (``torch.multiprocessing``, a ``file://`` store under the test's
  directory, one thread a rank) and, while they run, the port's unsharded
  runs they are held to and the dry run's trace of the same step on a fake
  world of 4.  Rank 0 writes what the ranks ran.

The cases: Danube and mixtral sharded from the reference's initial
parameters against the reference's sharded run; hymba, xlstm and whisper's
config, ``microbatches=2`` and ``compress_grads=True`` sharded against the
port's unsharded ``Trainer`` (held to the reference by
``tests/test_torch_train.py``); one step from non-zero moments; a sharded
``Trainer`` that fails and resumes; checkpoints across meshes; the SWA
call's placements; a mesh that is not the world; and the collectives of
one real step against the dry run's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESH = ((2, 2), ("data", "model"))
TOL, LR_TOL, STEP_TOL = 1e-5, 1e-6, 1e-5
SPEC = dict(global_batch=4, seq_len=32)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40)
STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)
#: (arch, steps) held against the reference's sharded Trainer, and against
#: the port's unsharded one (the step counts of
#: test_trainer_matches_reference_step_for_step_per_family)
REF_RUNS = (("h2o_danube_1_8b", 3), ("mixtral_8x7b", 3))
OWN_RUNS = (("hymba_1_5b", 3), ("xlstm_350m", 1), ("whisper_small", 3))
#: run again with the residual stream sequence-sharded (3 steps, as above)
SEQ_RUN = "hymba_1_5b"
#: Danube runs with an option, sharded against unsharded
OPTION_RUNS = {"microbatches": dict(microbatches=2),
               "compress": dict(compress=True)}
ARCH = "h2o_danube_1_8b"
FAIL_AT, CKPT_EVERY, RESUME_STEPS = 5, 2, 8
METRICS = ("loss", "grad_norm", "ce", "aux", "z", "ppl")

REFERENCE = r"""
import dataclasses, json, sys
import jax
from repro import configs
from repro.data import BatchSpec, SyntheticLM
from repro.dist.sharding import ShardingRules, make_auto_mesh
from repro.train import OptConfig, TrainConfig, Trainer

spec, opt, runs, out = json.loads(sys.argv[1])
mesh = make_auto_mesh((2, 2), ("data", "model"))
rules = ShardingRules(mesh=mesh, tp="model", fsdp="data", dp=("data",))
res = {"devices": len(jax.devices())}
for arch, steps in runs:
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    tr = Trainer(cfg, TrainConfig(opt=OptConfig(**opt), ckpt_every=10**9,
                                  ckpt_dir=out + "/ckpt_" + arch,
                                  log_every=1000),
                 SyntheticLM(BatchSpec(vocab=cfg.vocab, **spec), seed=0),
                 rules=rules)
    hist = tr.run(steps)
    leaf = tr.state["params"]["blocks"]["attn"]["wq"]
    res[arch] = {"history": hist, "wq_spec": str(leaf.sharding.spec)}
print("REFERENCE " + json.dumps(res))
"""


# --------------------------------------------------------------------------
# the rank processes (this file run as a script)
# --------------------------------------------------------------------------

def _cfg(arch):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


def _tcfg(ckpt_dir, opt=OPT, compress=False, **kw):
    from repro_torch.train import OptConfig, TrainConfig

    kw.setdefault("ckpt_every", 10**9)
    return TrainConfig(opt=OptConfig(compress_grads=compress, **opt),
                       ckpt_dir=str(ckpt_dir), log_every=1000, **kw)


def _data(cfg, batch=SPEC["global_batch"]):
    from repro_torch.data import BatchSpec, SyntheticLM

    return SyntheticLM(BatchSpec(global_batch=batch,
                                 seq_len=SPEC["seq_len"], vocab=cfg.vocab),
                       seed=0)


def _history(hist):
    return [{k: v for k, v in h.items() if k != "time_s"} for h in hist]


def _gathered(named) -> dict:
    """Every leaf whole, as numpy (a DTensor gathered: a collective)."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v
                ).detach().cpu().numpy() for k, v in named.items()}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = a
    return tree


def _set_params(tr, full: dict):
    """Copy whole tensors into a Trainer's (placed) parameters."""
    from repro_torch.dist.sharding import NamedSharding, place
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        for k, p in tr.state["params"].named_parameters():
            t = full[k]
            if isinstance(p, DTensor):
                t = place(t, NamedSharding(p.device_mesh, p.placements))
            p.copy_(t)


def _start_moments(named, seed=1):
    """Non-zero moments (count 5), the same numbers for every layout."""
    rng = np.random.default_rng(seed)
    mu = {k: rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-2
          for k, p in named.items()}
    nu = {k: (rng.standard_normal(tuple(p.shape)) ** 2 * 1e-4 + 1e-6
              ).astype(np.float32) for k, p in named.items()}
    return mu, nu


def _one_step(cfg, tr, rules):
    """One ``make_train_step`` call from ``tr``'s parameters and
    :func:`_start_moments`, on batch 3 of the data: the params after it
    and the metrics."""
    from repro_torch.dist.sharding import NamedSharding, place, place_batch
    from repro_torch.train import make_train_step
    from torch.distributed.tensor import DTensor

    named = dict(tr.state["params"].named_parameters())
    mu, nu = _start_moments(named)

    def put(a, p):
        t = torch.as_tensor(a)
        if isinstance(p, DTensor):
            return place(t, NamedSharding(p.device_mesh, p.placements))
        return t
    state = {"mu": {k: put(mu[k], p) for k, p in named.items()},
             "nu": {k: put(nu[k], p) for k, p in named.items()},
             "count": torch.tensor(5, dtype=torch.int32)}
    batch = {k: torch.as_tensor(v).long()
             for k, v in _data(cfg).batch_at(3).items()}
    if rules is not None:
        batch = place_batch(batch, rules)
    step = make_train_step(cfg, _tcfg(tr.tcfg.ckpt_dir, opt=STEP_OPT),
                           rules)
    _, state, _, m = step(tr.state["params"], state, torch.zeros(()), batch)
    from repro_torch.train.loop import _scalar
    return (_gathered(named), {k: _scalar(v) for k, v in m.items()},
            int(state["count"]))


def _swa_case(rules, heads, kv, batch):
    """The SWA call's placements on a (batch, 32, heads, 16) q, and its
    output and gradients on DTensors against the plain tensors'."""
    from repro_torch.dist.sharding import (NamedSharding, activation_context,
                                           place, placements)
    from repro_torch.models.layers import AttnSpec, attend

    mesh = rules.mesh
    spec = AttnSpec(n_heads=heads, n_kv_heads=kv, d_head=16, window=16,
                    chunk=64)
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(batch, 32, heads, 16, generator=gen)
    k, v = (torch.randn(batch, 32, kv, 16, generator=gen) for _ in "kv")
    w = torch.randn(batch, 32, heads, 16, generator=gen)
    # as the projections hand them over: batch over data, TP on the head
    # dim (each axis only where it divides)
    arrive = placements(("data" if batch % 2 == 0 else None, None, None,
                         "model"), mesh)
    leaves = [place(t, NamedSharding(mesh, arrive)).requires_grad_(True)
              for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with activation_context(rules):
        out = attend(*leaves, spec)
    (out * place(w, NamedSharding(mesh, out.placements))).sum().backward()
    want = attend(*plain, spec)
    (want * w).sum().backward()
    rel = max(float((a.full_tensor() - b).abs().max() / b.abs().max())
              for a, b in [(out, want)] + [(x.grad, y.grad) for x, y in
                                           zip(leaves, plain)])
    return {"out": [repr(p) for p in out.placements],
            "grads": [[repr(p) for p in t.grad.placements] for t in leaves],
            "arrived": [repr(p) for p in arrive],
            "max_rel_err": rel}


def _rank_cases(rank, rules, work: Path) -> tuple:
    """Every case, on every rank in the same order: (json record, arrays);
    rank 0's are kept."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.dist.sharding import (ShardingRules, named_shardings)
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.launch.dryrun import CollectiveLog
    from repro_torch.train import Trainer
    from torch.distributed.device_mesh import init_device_mesh

    rec, arrays = {}, {}

    def case(name, fn):
        t0 = time.perf_counter()
        try:
            rec[name] = fn()
        except Exception:
            rec[name] = {"error": traceback.format_exc()}
        rec[name + "_s"] = time.perf_counter() - t0

    def sharded(arch, steps, start=None, on=rules, **kw):
        cfg = _cfg(arch)
        tr = Trainer(cfg, _tcfg(work / f"ck_{arch}_{len(rec)}", **kw),
                     _data(cfg), rules=on)
        if start is not None:
            _set_params(tr, start)
        return tr, _history(tr.run(steps))

    ref = np.load(work / "reference_init.npz")
    for arch, steps in REF_RUNS:
        cfg = _cfg(arch)
        start = lm_params_from_reference(cfg, _unflatten(
            {k[len(arch) + 1:]: ref[k] for k in ref.files
             if k.startswith(arch + "/")}), device="cpu").state_dict()
        case(arch, lambda: sharded(arch, steps, start)[1])
    for arch, steps in OWN_RUNS:
        case(arch, lambda: sharded(arch, steps)[1])
    for name, kw in OPTION_RUNS.items():
        case(name, lambda: sharded(ARCH, 3, **kw)[1])

    def seq_case():
        # Megatron-SP: the residual stream, and so the Mamba scan's input,
        # sequence-sharded over model
        from repro_torch.models import ssm

        arrived, apply = [], ssm.mamba_apply

        def seen(p, x, *a, **k):
            arrived.append([repr(pl) for pl in x.placements])
            return apply(p, x, *a, **k)
        ssm.mamba_apply = seen
        try:
            hist = sharded(SEQ_RUN, 3, on=dataclasses.replace(
                rules, seq_sharding=True))[1]
        finally:
            ssm.mamba_apply = apply
        return {"history": hist, "scan_input": arrived[0]}
    case("seq_sharded", seq_case)

    def step_case():
        cfg = _cfg(ARCH)
        tr = Trainer(cfg, _tcfg(work / "ck_step"), _data(cfg), rules=rules)
        params, metrics, count = _one_step(cfg, tr, rules)
        arrays.update({"step/" + k: v for k, v in params.items()})
        return {"metrics": metrics, "count": count}
    case("step", step_case)

    def resume_case():
        cfg = _cfg(ARCH)
        tcfg = _tcfg(work / "ck_resume", ckpt_every=CKPT_EVERY)
        try:
            Trainer(cfg, tcfg, _data(cfg), rules=rules,
                    fail_at_step=FAIL_AT).run(RESUME_STEPS)
            return {"error": "no simulated failure"}
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        last = latest_step(tcfg.ckpt_dir)
        tr = Trainer(cfg, tcfg, _data(cfg), rules=rules)
        start = tr.step
        got = _history(tr.run(RESUME_STEPS - start))
        whole = Trainer(cfg, _tcfg(work / "ck_whole"), _data(cfg),
                        rules=rules)
        want = _history(whole.run(RESUME_STEPS))
        named = dict(tr.state["params"].named_parameters())
        arrays.update({"resumed/" + k: v
                       for k, v in _gathered(named).items()})
        arrays.update({"whole/" + k: v for k, v in _gathered(dict(
            whole.state["params"].named_parameters())).items()})
        return {"latest_after_failure": last, "resumed_at": start,
                "got": got, "want": want[start:],
                "latest": latest_step(tcfg.ckpt_dir),
                "ckpt_dir": str(tcfg.ckpt_dir)}
    case("resume", resume_case)

    def restore_case():
        # a checkpoint the launcher wrote unsharded, onto a (4, 1) mesh
        mesh41 = init_device_mesh("cpu", (4, 1),
                                  mesh_dim_names=("data", "model"))
        rules41 = ShardingRules(mesh=mesh41, tp="model", fsdp="data",
                                dp=("data",))
        cfg = _cfg(ARCH)
        tcfg = _tcfg(work / "ck_unsharded", ckpt_every=CKPT_EVERY)
        tr = Trainer(cfg, tcfg, _data(cfg), rules=rules41)
        named = dict(tr.state["params"].named_parameters())
        ps = named_shardings(cfg, tr.state["params"], rules41)
        like = {"params": named, "opt": tr.state["opt"],
                "ef": tr.state["ef"]}
        step = latest_step(tcfg.ckpt_dir)
        tree, extra, _ = restore_checkpoint(
            tcfg.ckpt_dir, step, like,
            {"params": ps, "opt": {"mu": ps, "nu": ps}})
        arrays.update({"restored/params/" + k: v
                       for k, v in _gathered(tree["params"]).items()})
        arrays.update({"restored/mu/" + k: v
                       for k, v in _gathered(tree["opt"]["mu"]).items()})
        places = {k: [repr(p) for p in t.placements]
                  for k, t in tree["params"].items()}
        arrays.update({"trainer41/" + k: v
                       for k, v in _gathered(named).items()})
        return {"step": step, "trainer_step": tr.step, "extra": extra,
                "placements": places,
                "count": int(tree["opt"]["count"]),
                "mu_placements": [repr(p) for p in
                                  tree["opt"]["mu"]["embed"].placements],
                "ef_whole": type(tree["ef"]).__name__}
    case("restore", restore_case)

    def swa_case():
        return {"divides": _swa_case(rules, 4, 2, 4),
                "heads_do_not_divide": _swa_case(rules, 6, 3, 4),
                "batch_does_not_divide": _swa_case(rules, 4, 2, 3)}
    case("swa", swa_case)

    def mesh_error_case():
        small = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        cfg = _cfg(ARCH)
        out = {}
        for name, mesh in (("smaller", small),):
            try:
                Trainer(cfg, _tcfg(work / "ck_err"), _data(cfg),
                        rules=ShardingRules(mesh=mesh, dp=("data",)))
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        return out
    case("mesh_error", mesh_error_case)

    def comms_case():
        cfg = _cfg(ARCH)
        tr = Trainer(cfg, _tcfg(work / "ck_comms", remat=True), _data(cfg),
                     rules=rules)
        inner, logs = tr.step_fn, []

        def logged(*a):
            with CollectiveLog(rules.mesh) as log:
                out = inner(*a)
            logs.append(log.by_op_axis())
            return out
        tr.step_fn = logged
        tr.run(1)
        return logs[0]
    case("comms", comms_case)
    return rec, arrays


def _rank_main(rank: int, work: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.dist.sharding import ShardingRules
    from torch.distributed.device_mesh import init_device_mesh

    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    rules = ShardingRules(mesh=mesh, tp="model", fsdp="data", dp=("data",))
    rec, arrays = _rank_cases(rank, rules, work)
    dist.barrier()
    if rank == 0:
        np.savez(work / "port.npz", **arrays)
        (work / "port.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the launcher: the ranks, and meanwhile the unsharded runs and the trace
# --------------------------------------------------------------------------

def _unsharded(work: Path) -> tuple:
    from repro_torch.train import Trainer

    rec, arrays = {}, {}
    for arch, steps in OWN_RUNS:
        cfg = _cfg(arch)
        rec[arch] = _history(Trainer(cfg, _tcfg(work / f"u_{arch}"),
                                     _data(cfg), device="cpu").run(steps))
    for name, kw in OPTION_RUNS.items():
        cfg = _cfg(ARCH)
        rec[name] = _history(Trainer(cfg, _tcfg(work / f"u_{name}", **kw),
                                     _data(cfg), device="cpu").run(3))
    cfg = _cfg(ARCH)
    tr = Trainer(cfg, _tcfg(work / "u_step"), _data(cfg), device="cpu")
    params, metrics, count = _one_step(cfg, tr, None)
    arrays.update({"step/" + k: v for k, v in params.items()})
    rec["step"] = {"metrics": metrics, "count": count}
    return rec, arrays


def _dry_run_comms() -> dict:
    """The dry run's collectives of the comms case's step (Danube smoke,
    float32, remat, a batch of 4 x 32), traced on a fake world of 4 over a
    CPU mesh, the device type of the ranks' (a CUDA mesh takes all-to-alls
    where a CPU one all-gathers and chunks)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.dryrun import StepTrace, fake_world
    from repro_torch.launch.specs import build_train_step
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(WORLD):
        mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
        rules = ShardingRules(mesh=mesh, tp="model", fsdp="data",
                              dp=("data",))
        step, args = build_train_step(
            _cfg(ARCH), ShapeConfig("t", SPEC["seq_len"],
                                    SPEC["global_batch"], "train"),
            rules, remat=True, microbatches=1)
        trace = StepTrace(mesh)
        with trace:
            step(*args)
    return {"comms": trace.comms.by_op_axis(),
            "fallbacks": trace.fallbacks}


def launch(work: Path) -> None:
    import torch.multiprocessing as mp
    from repro_torch.train import Trainer

    torch.set_num_threads(1)
    # an unsharded checkpoint for the ranks to restore onto a (4, 1) mesh
    cfg = _cfg(ARCH)
    Trainer(cfg, _tcfg(work / "ck_unsharded", ckpt_every=CKPT_EVERY),
            _data(cfg), device="cpu").run(CKPT_EVERY)
    ctx = mp.start_processes(_rank_main, args=(str(work),), nprocs=WORLD,
                             join=False, start_method="spawn")
    rec, arrays = _unsharded(work)
    rec["dry_run"] = _dry_run_comms()
    while not ctx.join():
        pass
    np.savez(work / "unsharded.npz", **arrays)
    (work / "unsharded.json").write_text(json.dumps(rec))


if __name__ == "__main__":
    launch(Path(sys.argv[1]))
    sys.exit(0)


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

def _env(**extra):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get(
        "PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "TMPDIR": os.environ.get("TMPDIR", tempfile.gettempdir())}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_train")


@pytest.fixture(scope="module")
def reference_proc(work):
    """The reference's initial parameters (written here, for the ranks),
    and its sharded runs started in a subprocess."""
    import jax

    from repro import configs as ref_configs
    from repro.models import init_lm as ref_init_lm

    flat = {}
    for arch, _ in REF_RUNS:
        rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                                   dtype="float32")
        leaves = jax.tree_util.tree_flatten_with_path(
            ref_init_lm(rcfg, jax.random.PRNGKey(0)))[0]
        for kp, a in leaves:
            path = "/".join(str(getattr(k, "key", k)) for k in kp)
            flat[f"{arch}/{path}"] = np.asarray(a)
    np.savez(work / "reference_init.npz", **flat)
    arg = json.dumps([SPEC, OPT, REF_RUNS, str(work)])
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arg],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference_runs(reference_proc):
    out, err = reference_proc.communicate(timeout=600)
    assert reference_proc.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


@pytest.fixture(scope="module")
def port_runs(work, reference_proc):
    res = subprocess.run([sys.executable, __file__, str(work)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads((work / "port.json").read_text())
    base = json.loads((work / "unsharded.json").read_text())
    return (rec, dict(np.load(work / "port.npz")), base,
            dict(np.load(work / "unsharded.npz")))


def _case(port_runs, name):
    rec = port_runs[0][name]
    assert not (isinstance(rec, dict) and "error" in rec), rec.get("error")
    return rec


def _step_for_step(got, want, steps):
    assert [h["step"] for h in got] == list(range(steps))
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g), set(w))
        for k in METRICS:
            if k in w:
                assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (g["step"], k,
                                                             g[k], w[k])
        assert g["lr"] == pytest.approx(w["lr"], rel=LR_TOL)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,steps", REF_RUNS)
def test_sharded_trainer_matches_reference_sharded_trainer(
        port_runs, reference_runs, arch, steps):
    """The port's Trainer(rules=) on 4 gloo ranks, from the reference's
    initial parameters, against the reference's Trainer(rules=) on 4 fake
    XLA devices: losses, grad norms and loss metrics at 1e-5, lr at 1e-6,
    step for step (the bar of ``_trainer_step_for_step`` in
    ``tests/test_torch_train.py``)."""
    assert reference_runs["devices"] == WORLD
    want = [{k: v for k, v in h.items() if k != "time_s"}
            for h in reference_runs[arch]["history"]]
    _step_for_step(_case(port_runs, arch), want, steps)


def test_reference_leaves_are_sharded(reference_runs):
    """The reference's run is really sharded: its stacked wq carries the
    FSDP and TP axes."""
    spec = reference_runs["h2o_danube_1_8b"]["wq_spec"]
    assert "data" in spec and "model" in spec, spec


@pytest.mark.parametrize("arch,steps", OWN_RUNS)
def test_sharded_trainer_matches_unsharded_per_family(port_runs, arch,
                                                      steps):
    """hymba (the Mamba scan), xlstm (both cells) and whisper's config (a
    learned-position decoder LM) sharded against the port's unsharded
    Trainer, at the same bar."""
    _step_for_step(_case(port_runs, arch), port_runs[2][arch], steps)


def test_sharded_scan_input_sequence_sharded_matches_unsharded(port_runs):
    """hymba under the train rules with Megatron-SP (``seq_sharding``):
    the Mamba scan's input arrives with its sequence sharded over
    ``model``, which the scan moves to the channels before its chunk
    views; three steps against the port's unsharded Trainer at 1e-5."""
    rec = _case(port_runs, "seq_sharded")
    assert rec["scan_input"] == ["Shard(dim=0)", "Shard(dim=1)"]
    _step_for_step(rec["history"], port_runs[2][SEQ_RUN], 3)


@pytest.mark.parametrize("name", sorted(OPTION_RUNS))
def test_sharded_options_match_unsharded(port_runs, name):
    """``microbatches=2`` (each rank's local rows) and
    ``compress_grads=True`` (a leaf's scale reduced over every shard)
    sharded against unsharded, three steps."""
    _step_for_step(_case(port_runs, name), port_runs[2][name], 3)


def test_sharded_step_from_moments_matches_unsharded(port_runs):
    """One ``make_train_step(rules=)`` call from non-zero moments: the
    gathered params at 1e-5 of each leaf's max abs, the metrics at 1e-5,
    the count."""
    rec, arrays, base, base_arrays = port_runs
    got = _case(port_runs, "step")
    assert got["count"] == base["step"]["count"] == 6
    for k, v in base["step"]["metrics"].items():
        assert abs(got["metrics"][k] - v) <= TOL * abs(v), k
    keys = [k for k in base_arrays if k.startswith("step/")]
    assert keys and set(keys) == {k for k in arrays if k.startswith("step/")}
    for k in keys:
        assert _rel(arrays[k], base_arrays[k]) <= STEP_TOL, k


def test_sharded_trainer_resumes_after_failure(port_runs):
    """A sharded Trainer fails at step 5 (checkpoints every 2, written by
    rank 0 from gathered shards); the next resumes at 4 and matches an
    uninterrupted sharded run, losses at 1e-5 and params at 1e-5."""
    rec = _case(port_runs, "resume")
    arrays = port_runs[1]
    assert rec["latest_after_failure"] == 4 and rec["resumed_at"] == 4
    assert rec["latest"] == RESUME_STEPS
    assert [h["step"] for h in rec["got"]] == list(range(4, RESUME_STEPS))
    for g, w in zip(rec["got"], rec["want"]):
        assert g["step"] == w["step"]
        for k in METRICS:
            assert abs(g[k] - w[k]) <= TOL * abs(w[k]), (g["step"], k)
    keys = [k[len("whole/"):] for k in arrays if k.startswith("whole/")]
    assert keys
    for k in keys:
        assert _rel(arrays["resumed/" + k], arrays["whole/" + k]) <= 1e-5, k


def test_sharded_checkpoint_restores_unsharded(port_runs):
    """The checkpoint the sharded run wrote (under the (2, 2) mesh) has the
    unsharded layout (the manifest's leaves, shapes and dtypes as an
    unsharded Trainer writes them, one ``host0000.npz`` of whole arrays)
    and restores into an unsharded Trainer: its parameters are the
    sharded run's gathered ones."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.train import Trainer

    rec = _case(port_runs, "resume")
    arrays = port_runs[1]
    sharded_dir = Path(rec["ckpt_dir"])
    step = latest_step(str(sharded_dir))
    mine = json.loads((sharded_dir / f"step_{step:08d}" / "manifest.json"
                       ).read_text())["leaves"]
    udir = Path(rec["ckpt_dir"]).parent / "ck_unsharded"
    ustep = latest_step(str(udir))
    theirs = json.loads((udir / f"step_{ustep:08d}" / "manifest.json"
                         ).read_text())["leaves"]
    assert mine == theirs
    assert sorted(os.listdir(sharded_dir / f"step_{step:08d}")) == [
        "host0000.npz", "manifest.json"]
    cfg = _cfg(ARCH)
    tr = Trainer(cfg, _tcfg(sharded_dir, ckpt_every=CKPT_EVERY), _data(cfg),
                 device="cpu")
    assert tr.step == RESUME_STEPS
    for k, p in tr.state["params"].named_parameters():
        assert np.array_equal(p.detach().numpy(), arrays["resumed/" + k]), k


def test_unsharded_checkpoint_restores_onto_another_mesh(port_runs):
    """A checkpoint written unsharded restores onto a (4, 1) mesh through
    ``restore_checkpoint(shardings=)``: every parameter and moment placed
    by its sharding and equal to the file's leaf; the count and the
    unsharded ``ef`` leaf stay whole; a Trainer over that mesh resumes
    from it with the same parameters."""
    from repro_torch.checkpoint import latest_step

    rec = _case(port_runs, "restore")
    arrays = port_runs[1]
    udir = Path(port_runs[0]["resume"]["ckpt_dir"]).parent / "ck_unsharded"
    assert rec["step"] == latest_step(str(udir)) == CKPT_EVERY
    assert rec["trainer_step"] == CKPT_EVERY
    assert rec["count"] == CKPT_EVERY and rec["ef_whole"] == "Tensor"
    assert rec["placements"]["embed"][0] == "Shard(dim=0)"
    assert rec["mu_placements"] == rec["placements"]["embed"]
    data = np.load(udir / f"step_{CKPT_EVERY:08d}" / "host0000.npz")
    n = 0
    for k in data.files:
        kind, _, name = k.partition("__")
        if kind == "params":
            assert np.array_equal(arrays["restored/params/" + name], data[k])
            assert np.array_equal(arrays["trainer41/" + name], data[k])
            n += 1
        elif kind == "opt" and name.startswith("mu__"):
            assert np.array_equal(arrays["restored/mu/" + name[4:]],
                                  data[k])
    assert n == len([k for k in arrays if k.startswith("trainer41/")])


@pytest.mark.parametrize("case,want", [
    ("divides", ["Shard(dim=0)", "Shard(dim=2)"]),
    ("heads_do_not_divide", ["Shard(dim=0)", "Replicate()"]),
    ("batch_does_not_divide", ["Replicate()", "Shard(dim=2)"])])
def test_swa_wrapper_placements(port_runs, case, want):
    """The SWA call on DTensors (``ops.on_shards``): q, k and v arrive with
    TP on the head dim; the call runs at batch over ``data`` and heads
    over ``model`` where they divide (both H and KV for the heads),
    ``Replicate`` where not; the output carries those placements, the
    gradients come back in the placements q, k and v arrived with, and
    output and gradients equal the plain tensors' at 1e-5."""
    rec = _case(port_runs, "swa")[case]
    assert rec["out"] == want
    assert all(g == rec["arrived"] for g in rec["grads"]), rec
    assert rec["max_rel_err"] <= TOL


def test_mesh_that_is_not_the_world_raises(port_runs):
    """A mesh of 2 ranks in a world of 4: Trainer(rules=) raises a
    ValueError that names both sizes."""
    msg = _case(port_runs, "mesh_error")["smaller"]
    assert msg and "2 ranks" in msg and "world 4" in msg


def test_collectives_match_the_dry_run(port_runs):
    """The collectives one real sharded step issues on the 4 gloo ranks
    (rank 0, by op and mesh axis: count and result bytes) equal those the
    dry run's ``StepTrace`` records for the same step (config, rules,
    batch, remat) on a fake world of 4 over a CPU mesh, with no
    replication fallback."""
    got = _case(port_runs, "comms")
    want = port_runs[2]["dry_run"]
    assert want["fallbacks"] == []
    assert got == want["comms"]
    assert {"all-gather over data", "reduce-scatter over data",
            "all-reduce over model"} <= set(got)


FAKE_NVCC = """#!{python}
import os, sys, time
out, src = sys.argv[sys.argv.index("-o") + 1], sys.argv[-1]
before = os.stat(src).st_mtime_ns
with open(src) as f:
    head = f.read(64)
    time.sleep(0.3)
    text = head + f.read()
if os.stat(src).st_mtime_ns != before:
    sys.exit("the source was rewritten while it compiled")
with open(out, "w") as f:
    f.write(text)
"""

BUILD = """
import sys
from repro_torch.kernels import build
print(build.build_many([sys.argv[1]], tag="swa")[0])
"""


def test_ranks_building_one_kernel_at_once_do_not_race(tmp_path):
    """Four processes (the ranks of a sharded run) build one kernel source
    into one build directory at once, through a stand-in ``nvcc`` that
    reads its input slowly and fails if it is rewritten meanwhile: each
    publishes the same library, whose
    contents are the whole source, with the source and the compiler's log
    beside it and no temporary file left."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    out = tmp_path / "build"
    source = "// a kernel\n" + "int x;\n" * 4000
    env = _env(NVCC=str(nvcc), REPRO_TORCH_BUILD=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, source], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(WORLD)]
    paths = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    so = Path(paths.pop())
    assert so.read_text() == source
    assert so.with_suffix(".cu").read_text() == source
    assert so.with_suffix(".log").exists()
    assert not [f for f in os.listdir(out) if ".tmp" in f]
