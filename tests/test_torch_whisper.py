"""The port's Whisper encoder-decoder, and the decoder LM with learned
positions, against the JAX package on the CPU.

Whisper's smoke config (2 + 2 layers, d 64, 4 heads, 32 frames, vocab
256), in float32 and in its bfloat16: the reference's ``init_whisper``
tree is carried across with ``interop.whisper_params_from_reference``, and
frames and tokens are made from a numpy seed, so both packages run the
same model on the same inputs.  Held: ``encode`` at LAYER_TOL, ``decode``
and ``whisper_forward`` logits at LOGIT_TOL, ``whisper_loss`` with its aux
and every gradient against ``jax.grad`` (float32: 1e-5 and 1e-4 of each
leaf's max abs; bfloat16: LOGIT_TOL), ``whisper_prefill`` and decode steps
(logits and caches) fed the reference's greedy tokens, the port's cached
decode against its own teacher-forced forward, and a vocabulary of 250
(padded to 256), where the reference's serving pair leaves the padded ids
unmasked and the port masks them.

The LM half: ``init_lm`` on an ``encdec`` config builds the reference's
decoder LM (learned ``pos_emb``); its forward, prefill and loss gradients
match the reference's, and its decode, which adds ``pos_emb[pos]`` where
the reference's adds ``pos_emb[0]``, equals its own forward.

Tolerances are relative to the compared tensor's own max abs, as in
``tests/test_torch_lm.py``.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import init_lm as ref_init_lm
from repro.models import whisper as ref_whisper
from repro.models.transformer import decode_step as ref_lm_decode_step
from repro.models.transformer import lm_forward as ref_lm_forward
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.models.transformer import prefill as ref_lm_prefill
from repro_torch import configs
from repro_torch.interop import (lm_params_from_reference,
                                 lm_tree_to_reference,
                                 whisper_params_from_reference)
from repro_torch.models import (ServeEngine, decode_step, init_lm,
                                init_whisper, lm_forward, lm_loss, prefill,
                                whisper_forward, whisper_loss)
from repro_torch.models.whisper import (Whisper, decode, encode,
                                        whisper_decode_step, whisper_prefill)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_small"
DTYPES = ["float32", "bfloat16"]
B, S, MAX_LEN, STEPS = 2, 16, 24, 6
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    g = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _cfgs(dtype, **kw):
    return (dataclasses.replace(ref_configs.get_smoke(ARCH), dtype=dtype,
                                **kw),
            dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype, **kw))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    return frames, tokens, labels


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _reference(dtype, vocab=None):
    """The JAX package's Whisper on the smoke config: encoder output,
    forward logits, loss and gradients, prefill + STEPS greedy decode
    steps (logits, caches, tokens)."""
    kw = {} if vocab is None else {"vocab": vocab}
    rcfg, _ = _cfgs(dtype, **kw)
    params = ref_whisper.init_whisper(rcfg, jax.random.PRNGKey(0))
    frames, tokens, labels = _inputs(rcfg)
    fr, tk, lb = map(jnp.asarray, (frames, tokens, labels))
    run = {"params": jax.tree.map(np.asarray, params),
           "inputs": (frames, tokens, labels)}
    enc = jax.jit(functools.partial(ref_whisper.encode, rcfg))(params, fr)
    run["enc"] = np.asarray(enc)
    run["decode"] = np.asarray(jax.jit(functools.partial(
        ref_whisper.decode, rcfg))(params, enc, tk))
    run["forward"] = np.asarray(jax.jit(functools.partial(
        ref_whisper.whisper_forward, rcfg))(params, fr, tk))
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_whisper.whisper_loss(rcfg, p, fr, tk, lb),
        has_aux=True))(params)
    run["loss"] = (float(loss), {k: float(v) for k, v in aux.items()})
    run["grads"] = jax.tree.map(np.asarray, grads)
    pre = jax.jit(functools.partial(ref_whisper.whisper_prefill, rcfg,
                                    max_len=MAX_LEN))
    dec = jax.jit(functools.partial(ref_whisper.whisper_decode_step, rcfg))
    logits, cache = pre(params, fr, tk)
    run["logits"], run["cache"], run["tokens"] = [np.asarray(logits)], [
        jax.tree.map(np.asarray, cache)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, :rcfg.vocab], -1).astype(jnp.int32)
        run["tokens"].append(np.asarray(tok))
        logits, cache = dec(params, cache, tok, jnp.int32(S + i))
        run["logits"].append(np.asarray(logits))
        run["cache"].append(jax.tree.map(np.asarray, cache))
    return run


def _port(dtype, vocab=None):
    kw = {} if vocab is None else {"vocab": vocab}
    cfg = _cfgs(dtype, **kw)[1]
    ref = _reference(dtype, vocab)
    model = whisper_params_from_reference(cfg, ref["params"], device="cpu")
    frames, tokens, labels = (torch.as_tensor(a) for a in ref["inputs"])
    return cfg, model, ref, frames, tokens.long(), labels.long()


# --------------------------------------------------------------------------
# the training forward and loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    cfg, model, ref, frames, _, _ = _port(dtype)
    with torch.no_grad():
        got = encode(cfg, model, frames)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, ref["enc"]) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_and_forward_match_reference(dtype):
    """``decode`` on the reference's encoder output, and the whole
    forward: float32 logits (B, S, vocab_padded) at LOGIT_TOL; in float32
    the same argmax everywhere (in bfloat16, random weights leave near
    ties that rounding may flip: 2 of 32 positions here)."""
    cfg, model, ref, frames, tokens, _ = _port(dtype)
    with torch.no_grad():
        dec = decode(cfg, model, torch.as_tensor(
            ref["enc"].astype(np.float32)).to(getattr(torch, dtype)), tokens)
        fwd = whisper_forward(cfg, model, frames, tokens)
    for got, want in ((dec, ref["decode"]), (fwd, ref["forward"])):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= LOGIT_TOL[dtype]
        if dtype == "float32":
            assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


@pytest.mark.parametrize("dtype,remat", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", False)])
def test_whisper_loss_and_every_gradient_match_reference(dtype, remat):
    """The loss and its ``ce`` aux, and the gradient of every parameter
    (encoder, decoder, cross-attention, frontend and positions) against
    ``jax.grad`` of the reference's ``whisper_loss``; the cross
    attention's projections get non-zero gradients."""
    cfg, model, ref, frames, tokens, labels = _port(dtype)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, aux = whisper_loss(cfg, model, frames, tokens, labels, remat=remat)
    want, want_aux = ref["loss"]
    assert set(aux) == set(want_aux) == {"ce"}
    assert abs(loss.item() - want) <= LOSS_TOL[dtype] * abs(want)
    assert abs(aux["ce"].item() - want_aux["ce"]) <= \
        LOSS_TOL[dtype] * abs(want)
    grads = torch.autograd.grad(loss, list(named.values()))
    mine = _leaves(lm_tree_to_reference(cfg, dict(zip(named, grads))))
    theirs = _leaves(ref["grads"])
    assert set(mine) == set(theirs)
    for k, w in theirs.items():
        assert mine[k].shape == w.shape, k
        assert _rel(mine[k], w) <= GRAD_TOL[dtype], (k, _rel(mine[k], w))
    for w in ("wq", "wk", "wv", "wo"):
        assert np.abs(mine[f"dec_blocks/xattn/{w}"]).max() > 1e-3, w


def test_whisper_loss_masks_labels():
    """-100 labels drop out of the mean; an all-masked batch gives 0."""
    cfg, model, _, frames, tokens, labels = _port("float32")
    with torch.no_grad():
        logits = whisper_forward(cfg, model, frames, tokens)
        ce, _ = whisper_loss(cfg, model, frames, tokens, labels)
        none, _ = whisper_loss(cfg, model, frames, tokens,
                               torch.full_like(labels, -100))
    keep = labels >= 0
    ll = torch.log_softmax(logits, -1).gather(
        -1, torch.where(keep, labels, 0)[..., None])[..., 0]
    assert abs(ce.item() + ll[keep].mean().item()) <= 1e-5 * ce.item()
    assert none.item() == 0.0


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_reference(dtype):
    """Prefill logits and all four caches, then STEPS decode steps fed the
    reference's greedy tokens: logits and caches at LOGIT_TOL, and the
    port's greedy choice equal to the reference's at every step."""
    cfg, model, ref, frames, tokens, _ = _port(dtype)
    with torch.no_grad():
        logits, cache = whisper_prefill(cfg, model, frames, tokens, MAX_LEN)
        for step in range(STEPS + 1):
            want = ref["logits"][step]
            assert logits.dtype == torch.float32
            assert logits.shape == want.shape
            assert _rel(logits, want) <= LOGIT_TOL[dtype], step
            assert (logits.argmax(-1).numpy() == want.argmax(-1)).all()
            for layer, entry in enumerate(cache):
                for k, w in ref["cache"][step][layer].items():
                    assert tuple(entry[k].shape) == w.shape, (step, k)
                    assert _rel(entry[k], w) <= LOGIT_TOL[dtype], \
                        (step, layer, k)
            if step < STEPS:
                tok = torch.as_tensor(ref["tokens"][step]).long()
                logits, cache = whisper_decode_step(cfg, model, cache, tok,
                                                    S + step)


@pytest.mark.parametrize("dtype", DTYPES)
def test_teacher_forced_decode_equals_forward(dtype):
    """The port's prefill and cached decode steps, fed fixed tokens, give
    the logits its own ``whisper_forward`` gives at each position."""
    cfg, model, _, frames, tokens, _ = _port(dtype)
    rng = np.random.default_rng(1)
    more = torch.as_tensor(rng.integers(0, cfg.vocab, (B, STEPS))).long()
    with torch.no_grad():
        full = whisper_forward(cfg, model, frames,
                               torch.cat([tokens, more], 1))
        logits, cache = whisper_prefill(cfg, model, frames, tokens, MAX_LEN)
        got = [logits]
        for i in range(STEPS - 1):
            logits, cache = whisper_decode_step(cfg, model, cache, more[:, i],
                                                S + i)
            got.append(logits)
    want = full[:, S - 1:S - 1 + STEPS]
    assert _rel(torch.stack(got, 1), want) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_padded_vocabulary_is_masked_where_the_reference_leaves_it(dtype):
    """vocab 250 pads to 256.  The first 250 columns of the prefill and
    decode logits equal the reference's; the port's padded columns are
    -1e30, as the reference's own ``decode`` makes them, where the
    reference's serving pair leaves them unmasked (ROADMAP section C)."""
    cfg, model, ref, frames, tokens, _ = _port(dtype, vocab=250)
    assert cfg.vocab_padded == 256
    with torch.no_grad():
        logits, cache = whisper_prefill(cfg, model, frames, tokens, MAX_LEN)
        steps = [logits]
        for step in range(STEPS):
            tok = torch.as_tensor(ref["tokens"][step]).long()
            logits, cache = whisper_decode_step(cfg, model, cache, tok,
                                                S + step)
            steps.append(logits)
        fwd = whisper_forward(cfg, model, frames, tokens)
    for got, want in zip(steps, ref["logits"]):
        assert _rel(got[:, :250], want[:, :250]) <= LOGIT_TOL[dtype]
        assert (got[:, 250:] == -1e30).all()
        assert (np.abs(want[:, 250:]) < 1e3).all()     # the fault
    assert (fwd[..., 250:] == -1e30).all()
    np.testing.assert_array_equal(ref["forward"][..., 250:],
                                  np.float32(-1e30))


# --------------------------------------------------------------------------
# parameters, interop, devices
# --------------------------------------------------------------------------

def test_init_whisper_has_the_reference_names_and_shapes():
    rcfg, cfg = _cfgs("bfloat16")
    model = init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(functools.partial(ref_whisper.init_whisper, rcfg),
                         jax.random.PRNGKey(0))
    want = {}
    for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
        name = ".".join(str(k.key) for k in path)
        stack = name.split(".", 1)[0]
        if stack in ("enc_blocks", "dec_blocks"):
            for i in range(a.shape[0]):
                want[name.replace(f"{stack}.", f"{stack}.{i}.", 1)] = \
                    a.shape[1:]
        else:
            want[name] = a.shape
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert all(p.dtype == torch.float32 for p in model.parameters())
    again = init_whisper(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again.dec_blocks[1].xattn.wq,
                               model.dec_blocks[1].xattn.wq)


def test_interop_carries_the_reference_tree_both_ways():
    cfg, model, ref, *_ = _port("float32")
    back = _leaves(lm_tree_to_reference(cfg, dict(model.named_parameters())))
    want = _leaves(ref["params"])
    assert set(back) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)
    with pytest.raises(ValueError, match="encdec"):
        Whisper(configs.get_smoke("h2o_danube_1_8b"), device="meta")


def test_whisper_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_whisper(cfg, torch.Generator())
    with pytest.raises(ValueError, match="generator is on"):
        init_whisper(cfg, torch.Generator(), device="meta")


def test_whisper_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import torch\n"
            "from repro_torch.configs import get_smoke\n"
            "from repro_torch.models.whisper import init_whisper, "
            "whisper_prefill\n"
            "cfg = get_smoke('whisper_small')\n"
            "m = init_whisper(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
            "fr = torch.zeros(1, cfg.enc_seq, cfg.d_model)\n"
            "lg, _ = whisper_prefill(cfg, m, fr, torch.zeros(1, 3, "
            "dtype=torch.long), 8)\n"
            "assert lg.shape == (1, cfg.vocab_padded)\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# --------------------------------------------------------------------------
# the decoder LM with learned positions (an encdec config's init_lm)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_lm(dtype):
    rcfg, _ = _cfgs(dtype)
    params = ref_init_lm(rcfg, jax.random.PRNGKey(0))
    _, tokens, labels = _inputs(rcfg)
    tk, lb = jnp.asarray(tokens), jnp.asarray(labels)
    fwd, _ = jax.jit(functools.partial(ref_lm_forward, rcfg))(params, tk)
    logits, cache = jax.jit(functools.partial(
        ref_lm_prefill, rcfg, max_len=MAX_LEN))(params, tk)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm_loss(rcfg, p, tk, lb), has_aux=True))(params)
    return {"params": jax.tree.map(np.asarray, params),
            "tokens": tokens, "labels": labels, "forward": np.asarray(fwd),
            "prefill": np.asarray(logits),
            "cache": jax.tree.map(np.asarray, cache),
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


def _port_lm(dtype):
    cfg = _cfgs(dtype)[1]
    ref = _reference_lm(dtype)
    return cfg, lm_params_from_reference(cfg, ref["params"], device="cpu"), \
        ref


def test_init_lm_on_an_encdec_config_builds_the_reference_decoder():
    """``init_lm`` on whisper's config builds what the reference's builds:
    a decoder LM with learned positions (``pos_emb`` (max_seq, d)) and no
    encoder."""
    rcfg, cfg = _cfgs("bfloat16")
    lm = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(functools.partial(ref_init_lm, rcfg),
                         jax.random.PRNGKey(0))
    want = {}
    for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
        name = ".".join(str(k.key) for k in path)
        if name.startswith("blocks."):
            for i in range(a.shape[0]):
                want[name.replace("blocks.", f"blocks.{i}.", 1)] = a.shape[1:]
        else:
            want[name] = a.shape
    assert {k: tuple(v.shape) for k, v in lm.state_dict().items()} == want
    assert tuple(lm.pos_emb.shape) == (cfg.max_seq, cfg.d_model)


@pytest.mark.parametrize("dtype", DTYPES)
def test_learned_position_lm_forward_and_prefill_match_reference(dtype):
    cfg, lm, ref = _port_lm(dtype)
    tokens = torch.as_tensor(ref["tokens"]).long()
    with torch.no_grad():
        fwd, _ = lm_forward(cfg, lm, tokens)
        logits, cache = prefill(cfg, lm, tokens, MAX_LEN)
    assert _rel(fwd, ref["forward"]) <= LOGIT_TOL[dtype]
    assert _rel(logits, ref["prefill"]) <= LOGIT_TOL[dtype]
    for layer, entry in enumerate(cache):
        for k in ("k", "v"):
            assert _rel(entry[k], ref["cache"][layer][k]) <= \
                LOGIT_TOL[dtype], (layer, k)


def test_learned_position_lm_loss_and_every_gradient_match_reference():
    cfg, lm, ref = _port_lm("float32")
    lm.requires_grad_(True)
    named = dict(lm.named_parameters())
    loss, _ = lm_loss(cfg, lm, torch.as_tensor(ref["tokens"]).long(),
                      torch.as_tensor(ref["labels"]).long())
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    grads = torch.autograd.grad(loss, list(named.values()))
    mine = _leaves(lm_tree_to_reference(cfg, dict(zip(named, grads))))
    theirs = _leaves(ref["grads"])
    assert set(mine) == set(theirs) and "pos_emb" in theirs
    for k, w in theirs.items():
        assert _rel(mine[k], w) <= GRAD_TOL["float32"], k


@pytest.mark.parametrize("dtype", DTYPES)
def test_learned_position_decode_equals_forward(dtype):
    """The port's prefill and decode steps give its own forward's logits
    at each position: the decode adds ``pos_emb[pos]``.  The reference's
    decode adds ``pos_emb[0]`` at every step, so it departs from its own
    forward (ROADMAP section C); that is shown here too."""
    cfg, lm, ref = _port_lm(dtype)
    rcfg = _cfgs(dtype)[0]
    prompt = torch.as_tensor(ref["tokens"]).long()
    more = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, STEPS))).long()
    with torch.no_grad():
        full, _ = lm_forward(cfg, lm, torch.cat([prompt, more], 1))
        logits, cache = prefill(cfg, lm, prompt, MAX_LEN)
        got = [logits]
        for i in range(STEPS - 1):
            logits, cache = decode_step(cfg, lm, cache, more[:, i], S + i)
            got.append(logits)
    want = full[:, S - 1:S - 1 + STEPS]
    assert _rel(torch.stack(got, 1), want) <= LOGIT_TOL[dtype]
    theirs, _ = jax.jit(functools.partial(ref_lm_decode_step, rcfg))(
        jax.tree.map(jnp.asarray, ref["params"]),
        jax.tree.map(jnp.asarray, ref["cache"]),
        jnp.asarray(more[:, 0].numpy().astype(np.int32)), jnp.int32(S))
    assert _rel(theirs, want[:, 1].numpy()) > 10 * LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_engine_on_a_learned_position_lm_matches_its_forward(dtype):
    """``ServeEngine`` keeps the master positions beside the master rows,
    so its greedy ids are the argmax of the port's own forward, step by
    step."""
    cfg, lm, ref = _port_lm(dtype)
    prompt = ref["tokens"]
    eng = ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN, device="cpu")
    if dtype == "bfloat16":        # a cast copy, the master rows shared
        assert eng.params.pos_emb_master.data_ptr() == lm.pos_emb.data_ptr()
    ids = eng.generate(prompt, 4)
    seq = torch.as_tensor(prompt).long()
    with torch.no_grad():
        for i in range(4):
            logits, _ = lm_forward(cfg, lm, seq)
            nxt = logits[:, -1].argmax(-1)
            assert (nxt.numpy() == ids[:, i]).all(), i
            seq = torch.cat([seq, nxt[:, None]], 1)
