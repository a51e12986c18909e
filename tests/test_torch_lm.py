"""The port's LM serving path against the JAX package, on the CPU, at the
``h2o_danube_1_8b`` smoke config (2 layers, d 64, 4 heads over 2 KV heads,
window 16).

The reference's ``init_lm`` tree is carried across with
``interop.lm_params_from_reference``, and prompts are made from a numpy
seed, so both packages run the same model on the same tokens.  The slice
runs twice: with ``dtype="float32"``, where any convention error (RoPE
pairing, ring slots, masks, GQA grouping) shows above float32 rounding, and
with the config's bfloat16.  Tolerances are relative to the compared
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
B, S, MAX_LEN, STEPS = 2, 64, 80, 8
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want) -> float:
    g = np.asarray(torch.as_tensor(got).float() if isinstance(got, torch.Tensor)
                   else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _cfgs(dtype):
    return (dataclasses.replace(ref_configs.get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _reference_run(dtype):
    """The JAX package's run: prefill over S tokens, then STEPS greedy
    decode steps (jitted as its engine jits them), and its engine's
    ``generate`` ids.  Cached: each dtype runs once per test process."""
    rcfg, cfg = _cfgs(dtype)
    params = ref_init_lm(rcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab, (B, S)).astype(np.int32)
    pre = jax.jit(functools.partial(ref_prefill, rcfg, max_len=MAX_LEN))
    dec = jax.jit(functools.partial(ref_decode_step, rcfg))
    logits, cache = pre(params, jnp.asarray(tokens))
    run = {"logits": [np.asarray(logits)],
           "cache": [jax.tree.map(np.asarray, cache)], "tokens": []}
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        run["tokens"].append(np.asarray(tok))
        logits, cache = dec(params, cache, tok, jnp.int32(S + i))
        run["logits"].append(np.asarray(logits))
        run["cache"].append(jax.tree.map(np.asarray, cache))
    eng = RefServeEngine(rcfg, params, batch=B, max_len=MAX_LEN)
    run["ids"] = eng.generate(tokens, STEPS + 1)
    run["stats"] = dataclasses.asdict(eng.stats)
    run["params"] = jax.tree.map(np.asarray, params)
    run["prompt"] = tokens
    return run


def _port(dtype):
    ref = _reference_run(dtype)
    cfg = _cfgs(dtype)[1]
    return cfg, lm_params_from_reference(cfg, ref["params"], device="cpu")


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and ring caches (S = 64 >= window: the rotated-slot
    write), then eight decode steps fed the reference's greedy tokens:
    logits, caches and the port's own greedy choice at every step."""
    ref = _reference_run(dtype)
    cfg, lm = _port(dtype)
    tol = LOGIT_TOL[dtype]
    logits, cache = prefill(cfg, lm, torch.as_tensor(ref["prompt"]).long(),
                            MAX_LEN)
    for step in range(STEPS + 1):
        want = ref["logits"][step]
        assert logits.shape == want.shape and logits.dtype == torch.float32
        assert _rel(logits, want) <= tol, step
        assert (logits.argmax(-1).numpy() == want.argmax(-1)).all(), step
        for layer, entry in enumerate(cache):
            for kv in ("k", "v"):
                w = ref["cache"][step][layer][kv]
                assert entry[kv].shape == w.shape
                assert _rel(entry[kv], w) <= tol, (step, layer, kv)
        if step < STEPS:
            tok = torch.tensor(ref["tokens"][step]).long()
            logits, cache = decode_step(cfg, lm, cache, tok, S + step)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_generate_matches_reference(dtype):
    ref = _reference_run(dtype)
    cfg, lm = _port(dtype)
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


@pytest.mark.parametrize("arch,item", [("hymba_1_5b", "A12"),
                                       ("xlstm_350m", "A13"),
                                       ("whisper_small", "A14"),
                                       ("mixtral_8x7b", "A11")])
def test_unported_families_raise_naming_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        init_lm(configs.get_smoke(arch), torch.Generator(), device="cpu")


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
