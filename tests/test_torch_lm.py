"""The port's LM serving path against the JAX package, on the CPU, at the
smoke config of every decoder arch the port runs (``LM_ARCHS``: the dense
decoders, the MoE decoders mixtral and grok, hymba's attention + Mamba
blocks and xlstm's mLSTM/sLSTM blocks; 2 layers, d 64), and per layer on
``h2o_danube_1_8b``'s (4 heads over 2 KV heads, window 16).

The reference's ``init_lm`` tree is carried across with
``interop.lm_params_from_reference``, and prompts are made from a numpy
seed, so both packages run the same model on the same tokens.  The slice
runs twice: with ``dtype="float32"``, where any convention error (RoPE
pairing, ring slots, masks, GQA grouping, capacity order, scan carries)
shows above float32 rounding, and with the config's bfloat16.

An MoE model's routing is discontinuous, so it is held first, layer by
layer: the router's input at LAYER_TOL of the reference's, and the port's
top-k experts equal to what the reference's router picks from the port's
own input.  In float32 they must also equal the reference's own picks.  In
bfloat16 a token whose two candidate experts are tied within the rounding
of that input may flip (grok's smoke model, prefill, layer 1, token 40:
probabilities 0.19300 and 0.19229); such flips are counted and named in
any later failure, so they show as routing, not as a logit error.

Hymba's Mamba state ``h`` is a float32 sum over the prompt of products of
three factors computed from the layer's bfloat16 input, so it carries
that input's rounding threefold: after layer 0 the two packages' inputs
differ by a few bf16 ulps and the two states by up to 3.8e-2 (the
reference's own state is up to 3.5e-2 from the float32 model's, the
port's up to 3.7e-2).  In bfloat16 it is held like the routing: each
hybrid layer's state at LOGIT_TOL of the reference's ``mamba_apply`` run
on the port's own input and incoming state, that input held through the
layer's k and v caches.  Tolerances are relative to the compared
tensor's own max abs: float32 logits 1e-4 (prefill and eight decode steps
of float32 sums in another order), per-layer float32 1e-5, bfloat16 2e-2
(a few ulps of bf16 activations); greedy ids must be equal.  The JAX model
runs once per dtype, jitted, in a module fixture.
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

import repro.models.transformer as ref_transformer
import repro_torch.models.transformer as transformer
from repro import configs as ref_configs
from repro.models import ServeEngine as RefServeEngine
from repro.models import init_lm as ref_init_lm
from repro.models import layers as ref_layers
from repro.models.transformer import _attn_spec as ref_attn_spec
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import prefill as ref_prefill
from repro_torch import configs
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import (LMServeStats, ServeEngine, decode_step,
                                init_lm, prefill, sample_token)
from repro_torch.models import layers
from repro_torch.models.transformer import _attn_spec

ROOT = Path(__file__).resolve().parents[1]
ARCH = "h2o_danube_1_8b"
LM_ARCHS = [a for a in ref_configs.ARCHS
            if ref_configs.get_smoke(a).family != "encdec"]
# (arch, dtype) cases; Danube's keep the ids they had before the others
ARCH_DTYPES = [pytest.param(a, d, id=d if a == ARCH else f"{a}-{d}")
               for a in [ARCH] + [a for a in LM_ARCHS if a != ARCH]
               for d in ("float32", "bfloat16")]
B, S, MAX_LEN, STEPS = 2, 64, 80, 8
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    g = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor)
                   else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _cfgs(dtype, arch=ARCH):
    return (dataclasses.replace(ref_configs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


def _ref_route(x, router, top_k):
    """The reference's router: top-k of softmax(x (float32) @ router)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, router), -1)
    return jax.lax.top_k(probs, top_k)[1]


def _recording_ref_moe(store):
    """The reference's ``moe_apply``, recording each call's input (float32)
    and top-k expert ids through an ordered callback."""
    moe_apply = ref_layers.moe_apply

    def moe(p, x, top_k=2, act="silu", capacity_factor=1.25, no_drop=False):
        jax.debug.callback(
            lambda a, t: store.append((np.asarray(a, np.float32),
                                       np.asarray(t))),
            x.astype(jnp.float32), _ref_route(x, p["router"], top_k),
            ordered=True)
        return moe_apply(p, x, top_k, act, capacity_factor, no_drop)
    return moe


def _recording_moe(store):
    """The port's ``moe_apply``, recording each call's input, router and
    top-k expert ids."""
    moe_apply = layers.moe_apply

    def moe(p, x, top_k=2, *a, **kw):
        stats = {}
        out = moe_apply(p, x, top_k, *a, stats=stats, **kw)
        store.append((x.float().numpy(), p.router.float().numpy(),
                      stats["top_i"].numpy()))
        return out
    return moe


def _check_routing(got, want, dtype, what):
    """Each MoE call of one step: the router's input within LAYER_TOL of
    the reference's, and the port's picks equal to the reference's router
    on the port's input; in float32 equal to the reference's picks.
    Returns the bfloat16 flips, (layer, token) pairs."""
    assert len(got) == len(want), what
    flips = []
    for layer, ((x, router, top_i), (wx, wtop)) in enumerate(zip(got,
                                                                 want)):
        assert _rel(x, wx) <= LAYER_TOL[dtype], (what, layer)
        k = top_i.shape[1]
        np.testing.assert_array_equal(
            top_i, np.asarray(_ref_route(
                jnp.asarray(x).astype(getattr(jnp, dtype)), router, k)),
            err_msg=f"{what}, layer {layer}: not the reference's router")
        if dtype == "float32":
            np.testing.assert_array_equal(
                top_i, wtop, err_msg=f"routing flip at {what}, layer {layer}")
        moved = (np.sort(top_i, 1) != np.sort(wtop, 1)).any(1)
        flips += [(layer, int(t)) for t in np.nonzero(moved)[0]]
    return flips


def _recording_mamba(store):
    """The port's ``mamba_apply``, recording each call's input, incoming
    state and new scan state."""
    mamba_apply = transformer.ssm.mamba_apply

    def mamba(p, x, state=None):
        out, new = mamba_apply(p, x, state)
        store.append((x, state, new[0]))
        return out, new
    return mamba


def _check_scans(calls, params, tol, what):
    """Each hybrid layer's new scan state against the reference's
    ``mamba_apply`` on the same (bfloat16) input and incoming state, with
    the layer's weights cast as the reference casts them."""
    from repro.models import ssm as ref_ssm

    assert len(calls) == len(params["blocks"]["ssm"]["w_in"]), what
    for layer, (x, state, h) in enumerate(calls):
        rp = jax.tree.map(lambda a: jnp.asarray(a[layer]).astype(
            jnp.bfloat16), params["blocks"]["ssm"])
        jst = None if state is None else tuple(
            jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])
            for t in state)
        _, (want, _) = ref_ssm.mamba_apply(
            rp, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jst)
        assert _rel(h, want) <= tol, (what, layer, _rel(h, want))


def _take(store):
    out = list(store)
    store.clear()
    return out


@functools.lru_cache(maxsize=None)
def _reference_run(dtype, arch=ARCH):
    """The JAX package's run: prefill over S tokens, then STEPS greedy
    decode steps (jitted as its engine jits them), each one's routing (the
    top-k expert ids of every MoE layer), and its engine's ``generate``
    ids.  Cached: each (dtype, arch) runs once per test process."""
    rcfg, cfg = _cfgs(dtype, arch)
    params = ref_init_lm(rcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (B, S)).astype(np.int32)
    store = []
    saved = ref_transformer.moe_apply
    ref_transformer.moe_apply = _recording_ref_moe(store)
    try:
        pre = jax.jit(functools.partial(ref_prefill, rcfg, max_len=MAX_LEN))
        dec = jax.jit(functools.partial(ref_decode_step, rcfg))
        logits, cache = pre(params, jnp.asarray(tokens))
        jax.effects_barrier()
        run = {"logits": [np.asarray(logits)],
               "cache": [jax.tree.map(np.asarray, cache)], "tokens": [],
               "routing": [_take(store)]}
        for i in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            run["tokens"].append(np.asarray(tok))
            logits, cache = dec(params, cache, tok, jnp.int32(S + i))
            jax.effects_barrier()
            run["logits"].append(np.asarray(logits))
            run["cache"].append(jax.tree.map(np.asarray, cache))
            run["routing"].append(_take(store))
    finally:
        ref_transformer.moe_apply = saved
    eng = RefServeEngine(rcfg, params, batch=B, max_len=MAX_LEN)
    run["ids"] = eng.generate(tokens, STEPS + 1)
    run["stats"] = dataclasses.asdict(eng.stats)
    run["params"] = jax.tree.map(np.asarray, params)
    run["prompt"] = tokens
    return run


def _port(dtype, arch=ARCH):
    ref = _reference_run(dtype, arch)
    cfg = _cfgs(dtype, arch)[1]
    return cfg, lm_params_from_reference(cfg, ref["params"], device="cpu")


def _cache_leaves(entry):
    """{name: array} of one layer's cache: k and v, hybrid's ``ssm`` (h,
    conv_tail), an xlstm cell's ``state`` tuple."""
    out = {}
    for k, v in entry.items():
        if isinstance(v, (tuple, list)):
            out.update({f"{k}.{i}": x for i, x in enumerate(v)})
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", ARCH_DTYPES)
def test_prefill_and_decode_match_reference(arch, dtype, monkeypatch):
    """Prefill logits and caches (S = 64 >= window: the rotated-slot
    write; hybrid's scan state and conv tail; xlstm's cell states), then
    eight decode steps fed the reference's greedy tokens: each MoE layer's
    routing first, then logits, caches and the port's own greedy choice
    at every step."""
    ref = _reference_run(dtype, arch)
    cfg, lm = _port(dtype, arch)
    tol = LOGIT_TOL[dtype]
    prompt = torch.as_tensor(ref["prompt"]).long()
    # hymba's bf16 scan state: the reference's mamba_apply on each layer's
    # input and incoming state, as the port ran them
    scans = []
    per_call = dtype == "bfloat16" and cfg.family == "hybrid"
    if per_call:
        monkeypatch.setattr(transformer.ssm, "mamba_apply",
                            _recording_mamba(scans))
    routing, flips = [], []
    monkeypatch.setattr(transformer, "moe_apply", _recording_moe(routing))
    logits, cache = prefill(cfg, lm, prompt, MAX_LEN)
    for step in range(STEPS + 1):
        assert len(ref["routing"][step]) == (
            cfg.n_layers if cfg.n_experts else 0), step
        flips += [(step, *f) for f in _check_routing(
            _take(routing), ref["routing"][step], dtype, f"step {step}")]
        want = ref["logits"][step]
        assert logits.shape == want.shape and logits.dtype == torch.float32
        assert _rel(logits, want) <= tol, (step, "routing flips", flips)
        assert (logits.argmax(-1).numpy() == want.argmax(-1)).all(), \
            (step, "routing flips", flips)
        if per_call:
            _check_scans(_take(scans), ref["params"], tol, f"step {step}")
        for layer, entry in enumerate(cache):
            got_c = _cache_leaves(entry)
            want_c = _cache_leaves(ref["cache"][step][layer])
            assert set(got_c) == set(want_c), layer
            for k, w in want_c.items():
                assert tuple(got_c[k].shape) == w.shape, (step, layer, k)
                if per_call and k == "ssm.0":
                    continue              # held by _check_scans
                assert _rel(got_c[k], w) <= tol, (step, layer, k, flips)
        if step < STEPS:
            tok = torch.tensor(ref["tokens"][step]).long()
            logits, cache = decode_step(cfg, lm, cache, tok, S + step)


@pytest.mark.parametrize("arch,dtype", ARCH_DTYPES)
def test_serve_engine_generate_matches_reference(arch, dtype):
    ref = _reference_run(dtype, arch)
    cfg, lm = _port(dtype, arch)
    eng = ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN, device="cpu")
    ids = eng.generate(ref["prompt"], STEPS + 1)
    assert ids.dtype == np.int32 and ids.shape == (B, STEPS + 1)
    np.testing.assert_array_equal(ids, ref["ids"])
    assert dataclasses.asdict(eng.stats) == ref["stats"]


def test_serve_engine_stops_at_eos_and_checks_batch():
    cfg, lm = _port("bfloat16")
    ref = _reference_run("bfloat16")
    eos = int(ref["ids"][0, 0])
    eng = ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN, eos=eos,
                      device="cpu")
    prompt = np.repeat(ref["prompt"][:1], B, axis=0)
    ids = eng.generate(prompt, STEPS + 1)
    # as the reference's loop does, one decode step runs before the check
    assert ids.shape == (B, 2) and eng.stats == LMServeStats(B * S, B)
    with pytest.raises(ValueError, match="batch"):
        eng.generate(ref["prompt"][:1], 2)


def test_serve_engine_casts_weights_once():
    """The engine keeps a ``cfg.dtype`` copy; the float32 masters stay."""
    cfg, lm = _port("bfloat16")
    eng = ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN, device="cpu")
    assert {p.dtype for p in eng.params.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in lm.parameters()} == {torch.float32}
    torch.testing.assert_close(eng.params.blocks[1].mlp.w_gate,
                               lm.blocks[1].mlp.w_gate.to(torch.bfloat16))


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if configs.get_smoke(a).emb_scale])
def test_serve_engine_with_emb_scale_casts_the_table_once(arch):
    """With ``emb_scale`` the engine's weights, the unembed's table
    included, are all ``cfg.dtype``; the lookup reads the master rows,
    shared with the caller's parameters, not copied."""
    cfg, lm = _port("bfloat16", arch)
    eng = ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN, device="cpu")
    assert {p.dtype for p in eng.params.parameters()} == {torch.bfloat16}
    master = eng.params.embed_master
    assert master.dtype == torch.float32
    assert master.data_ptr() == lm.embed.data_ptr()


# --------------------------------------------------------------------------
# per layer, on the carried-across weights
# --------------------------------------------------------------------------

def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.as_tensor(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)), t


def _layer0(dtype):
    """Layer 0's reference params (numpy, cast to ``dtype`` as prefill
    casts them) and the port's block in ``dtype``."""
    ref = _reference_run(dtype)
    cfg, lm = _port(dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]).astype(getattr(jnp, dtype)),
                      ref["params"]["blocks"])
    return cfg, rp, lm.blocks[0].to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_reference(kind, dtype):
    rng = np.random.default_rng(5)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    rp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    p = layers.Norm(64, kind)
    p.scale.data = torch.as_tensor(scale)
    if kind == "layernorm":
        p.bias.data = torch.as_tensor(bias)
    jx, tx = _x((B, 7, 64), 6, dtype)
    want = ref_layers.norm_apply(rp, jx, kind)
    got = layers.norm_apply(p, tx, kind)
    assert got.dtype == tx.dtype
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_apply_rope_matches_reference(positions, dtype):
    """Interleaved channel pairs, absolute positions past 10k."""
    jx, tx = _x((B, 9, 4, 16), 7, dtype)
    pos = np.arange(10_000, 10_009)
    if positions == "2d":
        pos = np.stack([pos, pos[::-1]])
    want = ref_layers.apply_rope(jx, jnp.asarray(pos), 1e4)
    got = layers.apply_rope(tx, torch.as_tensor(pos), 1e4)
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_sliding_window_matches_reference(dtype):
    """S = 64 > window 16: the SWA branch (the torch slab path on the
    CPU)."""
    cfg, rp, bp = _layer0(dtype)
    jx, tx = _x((B, S, cfg.d_model), 8, dtype)
    rspec = ref_attn_spec(_cfgs(dtype)[0], "local")
    want = ref_layers.attention_apply(rp["attn"], jx, rspec,
                                      jnp.arange(S), cfg.rope_theta)
    got = layers.attention_apply(bp.attn, tx, _attn_spec(cfg, "local"),
                                 torch.arange(S), cfg.rope_theta)
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("path,window,chunk", [("dense", 0, 1024),
                                               ("dense", 48, 1024),
                                               ("flash", 48, 32),
                                               ("swa", 48, 64)])
def test_attention_paths_match_reference(path, window, chunk, softcap):
    """Each attention path on GQA inputs (float32), with and without a
    logit softcap: dense (global and windowed), flash over 32-key chunks,
    and the SWA slab path, which the card also takes for a softcap."""
    (jq, tq), (jk, tk), (jv, tv) = (_x((B, 128, h, 16), 13 + h, "float32")
                                    for h in (4, 2, 2))
    kw = dict(n_heads=4, n_kv_heads=2, d_head=16, window=window,
              softcap=softcap, chunk=chunk)
    name = f"{path}_attention"
    want = getattr(ref_layers, name)(jq, jk, jv, ref_layers.AttnSpec(**kw))
    got = getattr(layers, name)(tq, tk, tv, layers.AttnSpec(**kw))
    assert _rel(got, want) <= LAYER_TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring,pos", [(True, 5), (True, 40), (False, 40)])
def test_decode_attention_matches_reference(ring, pos, dtype):
    """One token against a cache: a ring before and after it wraps (the
    mask is dropped once ``pos >= L``), and a full cache."""
    cfg, rp, bp = _layer0(dtype)
    L = cfg.window if ring else MAX_LEN
    shape = (B, L, cfg.n_kv_heads, cfg.d_head)
    jk, tk = _x(shape, 9, dtype)
    jv, tv = _x(shape, 10, dtype)
    jx, tx = _x((B, cfg.d_model), 11, dtype)
    kind = "local" if ring else "global"
    want, wk, wv = ref_layers.decode_attention(
        rp["attn"], jx, jk, jv, pos, ref_attn_spec(_cfgs(dtype)[0], kind),
        cfg.rope_theta, ring=ring)
    got, gk, gv = layers.decode_attention(
        bp.attn, tx, tk, tv, pos, _attn_spec(cfg, kind), cfg.rope_theta,
        ring=ring)
    tol = LAYER_TOL[dtype]
    assert _rel(got, want.astype(jnp.float32)) <= tol
    assert _rel(gk, wk.astype(jnp.float32)) <= tol
    assert _rel(gv, wv.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(dtype):
    cfg, rp, bp = _layer0(dtype)
    jx, tx = _x((B, 5, cfg.d_model), 12, dtype)
    want = ref_layers.mlp_apply(rp["mlp"], jx, cfg.act)
    got = layers.mlp_apply(bp.mlp, tx, cfg.act)
    assert _rel(got, want.astype(jnp.float32)) <= LAYER_TOL[dtype]


# --------------------------------------------------------------------------
# structure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_registry_matches_reference(arch):
    """The copied configs have not drifted, field by field."""
    assert configs.ARCHS == ref_configs.ARCHS
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke, ref_configs.get_smoke)):
        mine, ref = dataclasses.asdict(get(arch)), dataclasses.asdict(
            ref_get(arch))
        assert mine == ref
        assert get(arch).num_params() == ref_get(arch).num_params()
    assert configs.SHAPES.keys() == ref_configs.SHAPES.keys()
    for k, v in ref_configs.SHAPES.items():
        assert dataclasses.asdict(configs.SHAPES[k]) == dataclasses.asdict(v)


def test_lm_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.models, repro_torch.kernels.ops\n"
            "import repro_torch.interop\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules)\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a ``device`` the engine and ``init_lm`` go to the card, and
    raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, lm = _port("bfloat16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, lm, batch=B, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg, torch.Generator())


@pytest.mark.parametrize("field,value", [("family", "vision"),
                                         ("pos", "alibi")])
def test_unknown_family_or_position_scheme_raises(field, value):
    """Every family and position scheme of the reference's configs runs
    (whisper's ``encdec`` config builds a learned-position decoder LM,
    ``tests/test_torch_whisper.py``); anything else is refused."""
    cfg = dataclasses.replace(configs.get_smoke("whisper_small"),
                              **{field: value})
    with pytest.raises(ValueError, match=value):
        init_lm(cfg, torch.Generator(), device="cpu")


def test_init_lm_has_the_reference_names_and_shapes():
    cfg = configs.get_smoke("gemma3_1b")      # qk-norm and sandwich norms
    lm = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.eval_shape(functools.partial(
        ref_init_lm, ref_configs.get_smoke("gemma3_1b")),
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
    again = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again.blocks[1].attn.wq, lm.blocks[1].attn.wq)


def test_sample_token_greedy_and_seeded():
    logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 1.0]])
    assert sample_token(logits).tolist() == [1, 0]
    draws = [sample_token(logits, torch.Generator().manual_seed(3), 1.0)
             for _ in range(2)]
    assert draws[0].tolist() == draws[1].tolist()
