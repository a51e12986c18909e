"""The port's training slice against the JAX package, on the CPU.

* ``data``: ``SyntheticLM`` and ``MemmapCorpus`` batches bit-equal to the
  reference's;
* ``train.optimizer`` and ``train.compress`` against the reference's on
  random trees (float32: 1e-6 of each leaf's max abs, and exact where the
  arithmetic is the same op for op);
* ``checkpoint``: round trip, atomic publish, structure checks, the async
  writer's snapshot and gc, a bfloat16 leaf;
* ``lm_loss`` and every parameter gradient against ``jax.grad`` of the
  reference's ``lm_loss`` on the smoke config of every decoder arch the
  port runs (the ``h2o_danube_1_8b`` one has S 64 > window 16, so the SWA
  path runs; mixtral and grok add the MoE aux loss; hymba the Mamba scan;
  xlstm both cells, the unused one's gradient zero), in float32: the loss
  and metrics (``ce``, ``aux``, ``z``, ``ppl``) at 1e-5, each gradient at
  1e-4 of its leaf's max abs;
* one ``make_train_step`` step (remat off and on, two microbatches and
  compressed gradients on Danube; a plain and a compressed step on
  mixtral, hymba and xlstm) from the same params and moments, carried
  across by ``interop``: params, moments and error buffers at 1e-5 of
  each leaf's max abs;
* the ``Trainer`` on ``device="cpu"``: the reference's losses step for
  step (Danube, mixtral, hymba, xlstm), recovery from a checkpoint, loss
  falls, the straggler count, and train-then-serve.

Reference inputs and weights are made from seeds (numpy, ``jax.random``)
and handed to both packages.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.data import BatchSpec as RefBatchSpec
from repro.data import MemmapCorpus as RefMemmapCorpus
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import init_lm as ref_init_lm
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro.train.compress import compress_decompress as ref_compress
from repro.train.loop import make_train_step as ref_make_train_step
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.optimizer import clip_by_global_norm as ref_clip
from repro.train.optimizer import cosine_schedule as ref_cosine
from repro_torch import configs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import (BatchSpec, MemmapCorpus, SyntheticLM,
                              make_batches, write_corpus)
from repro_torch.interop import (lm_params_from_reference,
                                 lm_tree_to_reference,
                                 opt_state_from_reference)
from repro_torch.dist import ShardingRules
from repro_torch.models import ServeEngine, lm_loss
from repro_torch.train import (OptConfig, TrainConfig, Trainer, adamw_init,
                               adamw_update, clip_by_global_norm,
                               compress_decompress, cosine_schedule,
                               ef_compress_grads, ef_init, make_train_step)
from repro_torch.train.optimizer import leaf_rank

ARCH = "h2o_danube_1_8b"
LM_ARCHS = [a for a in ref_configs.ARCHS
            if ref_configs.get_smoke(a).family != "encdec"]
B, S = 4, 64
GRAD_TOL, STEP_TOL = 1e-4, 1e-5


def _cases(archs, values, ids):
    """(arch, *value) cases: Danube's keep the ids they had before the
    other archs joined (``ids``), the others ``<arch>-<id>``."""
    return [pytest.param(a, *v, id=i if a == ARCH else f"{a}-{i}")
            for a in archs for v, i in zip(values, ids)]


def _rel(got, want) -> float:
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    return err / scale if scale > 0 else err


def _leaves(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(got, want, tol, what):
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        assert _rel(g[k], w[k]) <= tol, (what, k, _rel(g[k], w[k]))


def _cfgs(arch=ARCH, dtype="float32"):
    return (dataclasses.replace(ref_configs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _reference_params(arch=ARCH):
    rcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, ref_init_lm(rcfg, jax.random.PRNGKey(0)))


def _batch(vocab, seed=0, mask_prefix=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lbls = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lbls[0, :mask_prefix] = -100
    return toks, lbls


def _moments(params, seed):
    """A reference AdamW state with non-zero moments (count 5), so one
    update is smooth in the gradients."""
    rng = np.random.default_rng(seed)

    def mk(f):
        return jax.tree.map(lambda a: f(a.shape).astype(np.float32), params)
    return {"mu": mk(lambda s: rng.standard_normal(s) * 1e-2),
            "nu": mk(lambda s: rng.standard_normal(s) ** 2 * 1e-4 + 1e-6),
            "count": np.int32(5)}


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_synthetic_batches_bit_equal_to_reference(n_hosts, host_id):
    spec = dict(global_batch=8, seq_len=33, vocab=1000, n_hosts=n_hosts,
                host_id=host_id)
    mine = SyntheticLM(BatchSpec(**spec), seed=3)
    ref = RefSyntheticLM(RefBatchSpec(**spec), seed=3)
    for step in (0, 1, 7, 123):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    steps = [s for s, _ in zip(make_batches(mine, 5), range(3))]
    assert [s for s, _ in steps] == [5, 6, 7]
    np.testing.assert_array_equal(steps[1][1]["tokens"],
                                  ref.batch_at(6)["tokens"])


def test_memmap_corpus_bit_equal_to_reference(tmp_path):
    path = str(tmp_path / "corpus.bin")
    toks = np.random.default_rng(0).integers(0, 60000, 5000)
    write_corpus(path, toks)
    spec = dict(global_batch=4, seq_len=16, vocab=50000)
    mine = MemmapCorpus(path, BatchSpec(**spec), seed=2)
    ref = RefMemmapCorpus(path, RefBatchSpec(**spec), seed=2)
    for step in (0, 9):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(mine.batch_at(step)[k],
                                          ref.batch_at(step)[k])
    with pytest.raises(ValueError, match="shorter"):
        MemmapCorpus(path, BatchSpec(1, 6000, 10))


# --------------------------------------------------------------------------
# optimizer and compression
# --------------------------------------------------------------------------

SCHED = RefOptConfig(lr=2e-3, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.1)


@pytest.mark.parametrize("step", [0, 4, 10, 55, 100, 130])
def test_cosine_schedule_matches_reference(step):
    """0, warm-up, its end, the middle of the cosine, its end, beyond."""
    cfg = OptConfig(**dataclasses.asdict(SCHED))
    got = cosine_schedule(cfg)(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.dim() == 0
    want = float(ref_cosine(SCHED)(step))
    assert abs(float(got) - want) <= 1e-6 * SCHED.lr


def _random_tree(seed):
    """Leaves of rank 0-3, one a "blocks." name (decayed as rank + 1)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2), "s": (),
              "blocks.0.scale": (7,)}
    return {k: (rng.standard_normal(s) * 3).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _random_tree(1)
    got, gnorm = clip_by_global_norm(
        {k: torch.as_tensor(v) for k, v in g.items()}, max_norm)
    want, wnorm = ref_clip({k: jnp.asarray(v) for k, v in g.items()},
                           max_norm)
    assert abs(float(gnorm) - float(wnorm)) <= 1e-6 * float(wnorm)
    for k in g:
        assert _rel(got[k], want[k]) <= 1e-6, k


def test_adamw_update_matches_reference():
    """Three updates on a random tree (clipping active, weight decay on
    leaves of rank >= 2 in the reference's tree) at 1e-6."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=2.0,
               weight_decay=0.1)
    params = _random_tree(2)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_p["blocks"] = {"scale": ref_p.pop("blocks.0.scale")[None]}
    ref_state = {"mu": jax.tree.map(jnp.zeros_like, ref_p),
                 "nu": jax.tree.map(jnp.zeros_like, ref_p),
                 "count": jnp.zeros((), jnp.int32)}
    mine = {k: torch.as_tensor(v).clone() for k, v in params.items()}
    state = adamw_init(mine)
    assert leaf_rank("blocks.0.scale", mine["blocks.0.scale"]) == 2
    for i in range(3):
        g = _random_tree(10 + i)
        ref_g = {k: jnp.asarray(v) for k, v in g.items()}
        ref_g["blocks"] = {"scale": ref_g.pop("blocks.0.scale")[None]}
        ref_p, ref_state, rm = ref_adamw_update(RefOptConfig(**cfg), ref_p,
                                                ref_g, ref_state)
        mine, state, m = adamw_update(
            OptConfig(**cfg), mine,
            {k: torch.as_tensor(v) for k, v in g.items()}, state)
        assert int(state["count"]) == int(ref_state["count"]) == i + 1
        assert abs(float(m["lr"]) - float(rm["lr"])) <= 1e-6 * cfg["lr"]
        assert _rel(m["grad_norm"], rm["grad_norm"]) <= 1e-6
    want = dict(ref_p)
    want["blocks.0.scale"] = want.pop("blocks")["scale"][0]
    for k in params:
        assert _rel(mine[k], want[k]) <= 1e-6, k
    assert _rel(state["mu"]["w"], ref_state["mu"]["w"]) <= 1e-6
    assert _rel(state["nu"]["blocks.0.scale"],
                ref_state["nu"]["blocks"]["scale"][0]) <= 1e-6


def test_adamw_update_writes_in_place():
    p = {"w": torch.ones(3, 3)}
    ptr = p["w"].data_ptr()
    state = adamw_init(p)
    mu_ptr = state["mu"]["w"].data_ptr()
    p2, state, _ = adamw_update(OptConfig(lr=0.1, warmup_steps=0), p,
                                {"w": torch.ones(3, 3)}, state)
    assert p2["w"].data_ptr() == ptr and state["mu"]["w"].data_ptr() == mu_ptr
    assert float(p["w"].max()) < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_matches_reference(seed):
    """Exact levels: the dequantised gradient is an integer multiple of
    its scale in [-127, 127]; the error buffer carries the rest, as the
    reference's does, over five rounds."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(257) * rng.uniform(0.1, 10)).astype(np.float32)
    err, ref_err = torch.zeros(257), jnp.zeros(257)
    for _ in range(5):
        scale = float((torch.as_tensor(g) + err).abs().max()) / 127.0
        deq, err = compress_decompress(torch.as_tensor(g), err)
        ref_deq, ref_err = ref_compress(jnp.asarray(g), ref_err)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(ref_deq))
        np.testing.assert_array_equal(err.numpy(), np.asarray(ref_err))
        levels = deq.numpy() / scale
        np.testing.assert_allclose(levels, np.round(levels), atol=1e-3)
        assert np.abs(levels).max() <= 127 + 1e-3
        # the EF invariant: the residual stays within half a level
        assert float(err.abs().max()) <= scale * 0.5 + 1e-6
    grads = {"a": torch.as_tensor(g), "b": torch.ones(2, 2)}
    deq, new = ef_compress_grads(grads, ef_init(grads))
    assert set(deq) == set(new) == {"a", "b"}
    torch.testing.assert_close(deq["a"] + new["a"], grads["a"])


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_round_trip_and_atomicity(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"count": torch.tensor(5, dtype=torch.int32)},
            "list": [torch.ones(2), np.zeros(3, np.float32)]}
    d = str(tmp_path / "ck")
    final = save_checkpoint(d, 3, tree, {"next_step": 3})
    assert final.endswith("step_00000003")
    assert sorted(os.listdir(final)) == ["host0000.npz", "manifest.json"]
    assert latest_step(d) == 3
    # partial .tmp dirs are never visible as checkpoints
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) == 3
    restored, extra, step = restore_checkpoint(d, 3, tree)
    assert step == 3 and extra["next_step"] == 3
    torch.testing.assert_close(restored["params"]["w"], tree["params"]["w"])
    assert restored["opt"]["count"].dtype == torch.int32
    assert int(restored["opt"]["count"]) == 5
    assert isinstance(restored["list"], list) and len(restored["list"]) == 2
    # the layout is the reference's: its restore reads the port's files
    ref_tree = {"params": {"w": jnp.zeros((2, 3))},
                "opt": {"count": jnp.int32(0)},
                "list": [jnp.zeros(2), jnp.zeros(3)]}
    back, rextra, rstep = ref_restore(d, 3, ref_tree)
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  np.arange(6.0).reshape(2, 3))
    assert rstep == 3 and rextra == {"next_step": 3}
    assert latest_step(str(tmp_path / "none")) is None


def test_checkpoint_integrity_checks(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    man = os.path.join(d, "step_00000001", "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m["leaves"]["a"]["shape"] = [4]
    with open(man, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="corrupt shard"):
        restore_checkpoint(d, 1, {"a": torch.zeros(3)})
    m["leaves"]["a"] = {"shape": [3], "dtype": "int32"}
    with open(man, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="corrupt shard"):
        restore_checkpoint(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(TypeError, match="NamedSharding"):
        restore_checkpoint(d, 1, {"a": torch.zeros(3)}, shardings={"a": 0})


def test_checkpoint_bfloat16_leaf(tmp_path):
    """Stored as its uint16 bits, recorded as bfloat16, restored bit for
    bit."""
    x = torch.randn(5, 3).to(torch.bfloat16)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, {"x": x, "y": torch.ones(2)})
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        assert json.load(f)["leaves"]["x"] == {"shape": [5, 3],
                                               "dtype": "bfloat16"}
    with np.load(os.path.join(d, "step_00000002", "host0000.npz")) as z:
        assert z["x"].dtype == np.uint16
    got, _, _ = restore_checkpoint(d, 2, {"x": torch.zeros(5, 3,
                                                           dtype=torch.bfloat16),
                                          "y": torch.zeros(2)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_async_checkpointer_snapshots_and_gcs(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d, keep=2)
    x = torch.zeros(4)
    for s in [1, 2, 3, 4]:
        x.fill_(float(s))
        ck.save(s, {"x": x})
        x.fill_(-1.0)   # in place, as a train step writes its masters
    ck.wait()
    assert latest_step(d) == 4
    kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]   # gc keeps the last 2
    got, _, _ = restore_checkpoint(d, 4, {"x": torch.zeros(4)})
    torch.testing.assert_close(got["x"], torch.full((4,), 4.0))


# --------------------------------------------------------------------------
# the training forward, loss and gradients
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_grads(arch=ARCH):
    rcfg, _ = _cfgs(arch)
    toks, lbls = _batch(rcfg.vocab, mask_prefix=5)
    fn = jax.jit(jax.value_and_grad(
        lambda p: ref_lm_loss(rcfg, p, jnp.asarray(toks), jnp.asarray(lbls)),
        has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray,
                                             _reference_params(arch)))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("arch,remat", _cases(
    [ARCH] + [a for a in LM_ARCHS if a != ARCH], [(False,), (True,)],
    ["False", "True"]))
def test_lm_loss_and_every_gradient_match_reference(arch, remat):
    """Each smoke LM in float32 (Danube's S 64 > window 16: the SWA layers
    run ``swa_attention``, differentiated by autograd): loss and metrics
    at 1e-5, each parameter's gradient at 1e-4 of the reference leaf's max
    abs (an xlstm layer's unused cell: zero, as the reference's), and the
    attention projections' gradients non-zero, output projection included
    (xlstm: the mLSTM's q/k/v and ``w_down``)."""
    rcfg, cfg = _cfgs(arch)
    if arch == ARCH:
        assert S > cfg.window and cfg.layer_pattern == ("local",)
    loss, metrics, grads = _reference_grads(arch)
    lm = lm_params_from_reference(cfg, _reference_params(arch),
                                  device="cpu").requires_grad_(True)
    toks, lbls = _batch(cfg.vocab, mask_prefix=5)
    named = dict(lm.named_parameters())
    got, got_m = lm_loss(cfg, lm, torch.as_tensor(toks).long(),
                         torch.as_tensor(lbls).long(), remat=remat)
    assert abs(got.item() - loss) <= 1e-5 * abs(loss)
    assert set(got_m) == set(metrics)
    for k, v in metrics.items():
        assert abs(got_m[k].item() - v) <= 1e-5 * max(abs(v), 1e-30), k
    g = torch.autograd.grad(got, list(named.values()), allow_unused=True)
    mine = lm_tree_to_reference(cfg, {
        k: torch.zeros_like(p) if d is None else d
        for (k, p), d in zip(named.items(), g)})
    _assert_trees_close(mine, grads, GRAD_TOL, "grads")
    if cfg.family == "xlstm":
        proj, names = mine["blocks"]["mlstm"], ("wq", "wk", "wv", "w_down")
    else:
        proj, names = mine["blocks"]["attn"], ("wq", "wk", "wv", "wo")
    for w in names:
        assert float(np.abs(proj[w]).max()) > 1e-3, w
    if cfg.n_experts:
        assert metrics["aux"] > 0


def test_lm_loss_masks_and_counts_tokens():
    """-100 labels drop out of ce and z; an all-masked batch gives 0."""
    _, cfg = _cfgs()
    lm = lm_params_from_reference(cfg, _reference_params(), device="cpu")
    toks, lbls = _batch(cfg.vocab)
    t = torch.as_tensor(toks).long()
    lb = torch.as_tensor(lbls).long()
    full, _ = lm_loss(cfg, lm, t, lb)
    lb2 = lb.clone()
    lb2[1:] = -100
    part, _ = lm_loss(cfg, lm, t, lb2)
    one, _ = lm_loss(cfg, lm, t[:1], lb[:1])
    assert abs(float(part) - float(one)) <= 1e-5 * float(one)
    none, m = lm_loss(cfg, lm, t, torch.full_like(lb, -100))
    assert float(none) == 0.0 and float(m["ce"]) == 0.0
    assert float(full) != float(part)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)


@functools.lru_cache(maxsize=None)
def _reference_step(remat, microbatches, compress, arch=ARCH):
    rcfg, _ = _cfgs(arch)
    tcfg = RefTrainConfig(opt=RefOptConfig(compress_grads=compress,
                                           **STEP_OPT),
                          remat=remat, microbatches=microbatches)
    params = _reference_params(arch)
    opt = _moments(params, 1)
    rng = np.random.default_rng(2)
    ef = (jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3
                                  ).astype(np.float32), params)
          if compress else np.zeros((), np.float32))
    toks, lbls = _batch(rcfg.vocab, seed=3)
    step = ref_make_train_step(rcfg, tcfg)
    with jax.default_device(jax.devices("cpu")[0]):
        out = step(jax.tree.map(jnp.asarray, params),
                   jax.tree.map(jnp.asarray, opt),
                   jax.tree.map(jnp.asarray, ef),
                   {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lbls)})
    p, o, e, m = jax.tree.map(np.asarray, out)
    return (params, opt, ef), (p, o, e, {k: float(v) for k, v in m.items()})


def _port_step(cfg, start, remat, microbatches, compress):
    params, opt, ef = start
    lm = lm_params_from_reference(cfg, params,
                                  device="cpu").requires_grad_(True)
    state = opt_state_from_reference(cfg, opt, device="cpu")
    if compress:
        ef = lm_params_from_reference(cfg, ef, device="cpu").state_dict()
    else:
        ef = torch.zeros(())
    tcfg = TrainConfig(opt=OptConfig(compress_grads=compress, **STEP_OPT),
                       remat=remat, microbatches=microbatches)
    toks, lbls = _batch(cfg.vocab, seed=3)
    batch = {"tokens": torch.as_tensor(toks).long(),
             "labels": torch.as_tensor(lbls).long()}
    return make_train_step(cfg, tcfg)(lm, state, ef, batch)


@pytest.mark.parametrize("arch,remat,microbatches", _cases(
    [ARCH], [(False, 1), (True, 1), (False, 2)],
    ["False-1", "True-1", "False-2"]) + _cases(
        ["mixtral_8x7b", "hymba_1_5b", "xlstm_350m"], [(False, 1)],
        ["False-1"]))
def test_train_step_matches_reference(arch, remat, microbatches):
    """One step from the same params and non-zero moments on the same
    batch: params, moments and count at 1e-5 of each leaf's max abs; loss,
    grad norm, lr and the loss metrics at 1e-5 (mixtral: with the aux
    loss; xlstm: AdamW decays each layer's unused cell, as the
    reference's does)."""
    _, cfg = _cfgs(arch)
    start, (p, o, _, m) = _reference_step(remat, microbatches, False, arch)
    lm, state, _, metrics = _port_step(cfg, start, remat, microbatches,
                                       False)
    named = dict(lm.named_parameters())
    _assert_trees_close(lm_tree_to_reference(cfg, named), p, STEP_TOL,
                        "params")
    for key in ("mu", "nu"):
        _assert_trees_close(lm_tree_to_reference(cfg, state[key]), o[key],
                            STEP_TOL, key)
    assert int(state["count"]) == int(o["count"]) == 6
    assert set(metrics) == set(m)
    for k, v in m.items():
        assert abs(float(metrics[k]) - v) <= 1e-5 * abs(v), k
    # the step moved the params
    proj = "mlstm" if cfg.family == "xlstm" else "attn"
    assert _rel(p["blocks"][proj]["wq"],
                start[0]["blocks"][proj]["wq"]) > 1e-3


def test_compressed_step_matches_reference():
    """``compress_grads``: int8 rounding is discontinuous, so gradients
    that agree to 1e-6 may land one level apart and the reference's whole
    step is not a fixed target.  The port's step is held to the
    reference's compression (a scale a stacked leaf) and AdamW applied to
    the port's own float32 gradients (params, moments, error buffers at
    1e-5 of each leaf's max abs), and its loss to the reference's
    compressed step at 1e-5."""
    _compressed_step(ARCH)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "hymba_1_5b",
                                  "xlstm_350m"])
def test_compressed_step_matches_reference_per_family(arch):
    """As ``test_compressed_step_matches_reference``, for the MoE, hybrid
    and xLSTM families (an xlstm layer's unused cell: a zero gradient,
    compressed and decayed as the reference's)."""
    _compressed_step(arch)


def _compressed_step(arch):
    from repro.train.compress import ef_compress_grads as ref_ef_compress

    _, cfg = _cfgs(arch)
    start, (_, _, _, m) = _reference_step(False, 1, True, arch)
    params, opt, ef = start
    lm = lm_params_from_reference(cfg, params,
                                  device="cpu").requires_grad_(True)
    toks, lbls = _batch(cfg.vocab, seed=3)
    named = dict(lm.named_parameters())
    loss, _ = lm_loss(cfg, lm, torch.as_tensor(toks).long(),
                      torch.as_tensor(lbls).long())
    g = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = lm_tree_to_reference(cfg, {
        k: torch.zeros_like(p) if d is None else d
        for (k, p), d in zip(named.items(), g)})
    tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    deq, want_ef = ref_ef_compress(tree(grads), tree(ef))
    want_p, want_o, wm = ref_adamw_update(
        RefOptConfig(compress_grads=True, **STEP_OPT), tree(params), deq,
        tree(opt))
    lm, state, got_ef, metrics = _port_step(cfg, start, False, 1, True)
    _assert_trees_close(lm_tree_to_reference(cfg, dict(lm.named_parameters())),
                        jax.tree.map(np.asarray, want_p), STEP_TOL, "params")
    for key in ("mu", "nu"):
        _assert_trees_close(lm_tree_to_reference(cfg, state[key]),
                            jax.tree.map(np.asarray, want_o[key]), STEP_TOL,
                            key)
    _assert_trees_close(lm_tree_to_reference(cfg, got_ef),
                        jax.tree.map(np.asarray, want_ef), STEP_TOL, "ef")
    assert abs(float(metrics["grad_norm"]) - float(wm["grad_norm"])) <= \
        1e-5 * float(wm["grad_norm"])
    assert abs(float(metrics["loss"]) - m["loss"]) <= 1e-5 * m["loss"]


def test_microbatches_equal_the_large_batch():
    """Two microbatches of 2 against one batch of 4 (no masked labels, so
    the mean of the microbatch means is the batch mean)."""
    _, cfg = _cfgs()
    start, _ = _reference_step(False, 2, False)
    big = _port_step(cfg, start, False, 1, False)
    two = _port_step(cfg, start, False, 2, False)
    _assert_trees_close(lm_tree_to_reference(cfg, dict(
        two[0].named_parameters())), lm_tree_to_reference(cfg, dict(
            big[0].named_parameters())), STEP_TOL, "params")
    assert abs(float(two[3]["loss"]) - float(big[3]["loss"])) <= \
        1e-5 * float(big[3]["loss"])


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

def _tcfg(tmp_path, **kw):
    opt = kw.pop("opt", OptConfig(lr=1e-3, total_steps=40))
    return TrainConfig(opt=opt, ckpt_dir=str(tmp_path / "ck"),
                       log_every=1000, **kw)


def test_trainer_matches_reference_step_for_step(tmp_path):
    """The reference's Trainer and the port's from the same initial
    params, three steps on the same SyntheticLM: losses, grad norms and
    loss metrics at 1e-5, each step's lr at 1e-6.  (The first AdamW step
    from zero moments is sign-like, so a gradient element near 0 may move
    its weight by up to lr on either side; the params after a step are
    held to the reference from non-zero moments in
    ``test_train_step_matches_reference``, and here through the losses of
    the steps that follow.)"""
    _trainer_step_for_step(tmp_path, ARCH, 3)


@pytest.mark.parametrize("arch,steps", [("mixtral_8x7b", 3),
                                        ("hymba_1_5b", 3),
                                        ("xlstm_350m", 1),
                                        ("whisper_small", 3)])
def test_trainer_matches_reference_step_for_step_per_family(tmp_path, arch,
                                                            steps):
    """As ``test_trainer_matches_reference_step_for_step``, for the MoE
    model (the aux loss in every step's loss), hymba (the Mamba scan's
    gradients), xlstm (both cells) and whisper's config, which both
    packages' ``init_lm`` build as a decoder LM with learned positions.
    xlstm is held over its first step: that sign-like step moves four of
    its weights whose gradients are near 0 by up to 4.6e-5 apart, and the
    next step's grad norm by 2.1e-4 of itself (the step from non-zero
    moments is held in ``test_train_step_matches_reference``)."""
    _trainer_step_for_step(tmp_path, arch, steps)


def _trainer_step_for_step(tmp_path, arch, steps):
    rcfg, cfg = _cfgs(arch)
    spec = dict(global_batch=4, seq_len=32, vocab=cfg.vocab)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=40)
    ref = RefTrainer(rcfg, RefTrainConfig(
        opt=RefOptConfig(**opt), ckpt_every=10**9,
        ckpt_dir=str(tmp_path / "ref"), log_every=1000),
        RefSyntheticLM(RefBatchSpec(**spec), seed=0))
    tr = Trainer(cfg, _tcfg(tmp_path, opt=OptConfig(**opt),
                            ckpt_every=10**9),
                 SyntheticLM(BatchSpec(**spec), seed=0), device="cpu")
    start = jax.tree.map(np.asarray, ref.state["params"])
    with torch.no_grad():
        for k, t in lm_params_from_reference(cfg, start, device="cpu"
                                             ).state_dict().items():
            tr.state["params"].get_parameter(k).copy_(t)
    want = ref.run(steps)
    got = tr.run(steps)
    assert [h["step"] for h in got] == list(range(steps))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "grad_norm", "ce", "aux", "z", "ppl"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (g["step"], k)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)


def test_trainer_failure_recovery(tmp_path):
    """A failure at step 12 (checkpoints every 5): the next Trainer resumes
    from step 10 and its steps match an uninterrupted run's."""
    cfg = configs.get_smoke("nemotron_4_340b")
    spec = BatchSpec(global_batch=4, seq_len=16, vocab=cfg.vocab)
    data = SyntheticLM(spec, seed=0)
    tcfg = _tcfg(tmp_path, ckpt_every=5)
    tr = Trainer(cfg, tcfg, data, fail_at_step=12, device="cpu")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(20)
    assert latest_step(tcfg.ckpt_dir) == 10
    tr2 = Trainer(cfg, tcfg, data, device="cpu")     # auto-resume
    assert tr2.step == 10                            # latest complete one
    hist = tr2.run(5)
    assert [h["step"] for h in hist] == list(range(10, 15))
    assert all(np.isfinite(h["loss"]) for h in hist)
    whole = Trainer(cfg, _tcfg(tmp_path / "whole", ckpt_every=10**9), data,
                    device="cpu").run(15)
    for a, b in zip(hist, whole[10:]):
        assert a["step"] == b["step"]
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])


def test_trainer_loss_falls(tmp_path):
    cfg = configs.get_smoke(ARCH)
    spec = BatchSpec(global_batch=8, seq_len=32, vocab=cfg.vocab)
    tcfg = _tcfg(tmp_path, opt=OptConfig(lr=2e-3, warmup_steps=5,
                                         total_steps=60),
                 ckpt_every=10**9)
    tr = Trainer(cfg, tcfg, SyntheticLM(spec, seed=0), device="cpu")
    hist = tr.run(40)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.3, f"loss did not fall: {first} -> {last}"
    assert {"step", "time_s", "loss", "grad_norm", "lr", "ce", "aux", "z",
            "ppl"} <= set(hist[0])


def test_straggler_deadline_counts(tmp_path):
    """Every step past the deadline counts, except a run's first."""
    cfg = configs.get_smoke(ARCH)
    spec = BatchSpec(global_batch=2, seq_len=16, vocab=cfg.vocab)
    tcfg = _tcfg(tmp_path, ckpt_every=10**9, step_deadline_s=1e-9)
    tr = Trainer(cfg, tcfg, SyntheticLM(spec), device="cpu")
    tr.run(3)
    assert tr.straggler_events == 2


def test_full_lm_system_train_then_serve(tmp_path):
    """Train a smoke model through the Trainer (with a checkpoint), then
    serve from the trained weights — the whole substrate in one path."""
    cfg = configs.get_smoke("gemma3_1b")
    spec = BatchSpec(global_batch=4, seq_len=24, vocab=cfg.vocab)
    tcfg = _tcfg(tmp_path, opt=OptConfig(lr=1e-3, total_steps=20),
                 ckpt_every=4)
    tr = Trainer(cfg, tcfg, SyntheticLM(spec, seed=0), device="cpu")
    hist = tr.run(6)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert latest_step(tcfg.ckpt_dir) == 4
    eng = ServeEngine(cfg, tr.state["params"], batch=2, max_len=64,
                      device="cpu")
    out = eng.generate(np.zeros((2, 6), np.int32), max_new_tokens=4)
    assert out.shape == (2, 4)
    assert (out >= 0).all() and (out < cfg.vocab).all()


def test_trainer_entry_points_need_a_card_or_the_cpu(tmp_path, monkeypatch):
    """Without a card and without ``device="cpu"`` the Trainer raises, as
    every entry point does; ``rules=`` over a mesh that is not the world
    (here a mesh of 4 ranks in a process with no process group) raises
    before anything is built, from the Trainer and from make_train_step
    (sharded training itself: ``tests/test_torch_sharded_train.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke(ARCH)
    data = SyntheticLM(BatchSpec(2, 16, cfg.vocab))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, _tcfg(tmp_path), data)
    mesh = types.SimpleNamespace(size=lambda: 4, device_type="cpu",
                                 mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    rules = ShardingRules(mesh=mesh, tp="model", fsdp="data", dp=("data",))
    with pytest.raises(ValueError, match="4 ranks and the world 1"):
        Trainer(cfg, _tcfg(tmp_path), data, rules=rules)
    with pytest.raises(ValueError, match="4 ranks and the world 1"):
        make_train_step(cfg, _tcfg(tmp_path), rules=rules)


def test_training_imports_and_runs_without_jax(tmp_path):
    """With JAX made unimportable, the training, data and checkpoint
    packages import, and a Trainer takes two steps on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.configs import get_smoke\n"
        "from repro_torch.data import BatchSpec, SyntheticLM\n"
        "from repro_torch.train import OptConfig, TrainConfig, Trainer\n"
        "import repro_torch.checkpoint\n"
        "cfg = get_smoke('h2o_danube_1_8b')\n"
        f"tcfg = TrainConfig(ckpt_every=1, ckpt_dir={str(tmp_path)!r})\n"
        "data = SyntheticLM(BatchSpec(2, 32, cfg.vocab))\n"
        "h = Trainer(cfg, tcfg, data, device='cpu').run(2)\n"
        "assert len(h) == 2 and 'repro' not in sys.modules\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert latest_step(str(tmp_path)) == 2
