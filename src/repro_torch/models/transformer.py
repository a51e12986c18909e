"""The decoder LM in PyTorch: parameters, the training forward and loss,
prefill and decode.

The port of ``repro.models.transformer`` for its three families:

* ``decoder``: (GQA | MQA) x (global | SWA | alternating local:global) x
  (dense | MoE), with the softcaps, qk-norm, sandwich norms and
  activations of the configs, RoPE or learned positions (``pos_emb``);
  an ``encdec`` config builds this decoder too, as the reference's
  ``init_lm`` does (the encoder-decoder itself is :mod:`.whisper`);
* ``hybrid`` (hymba): attention and a Mamba head in parallel in every
  block, their outputs summed;
* ``xlstm``: mLSTM blocks with an sLSTM every ``slstm_every``-th layer,
  no MLP.  As in the reference every xlstm layer carries both cells'
  weights (the reference stacks a uniform tree); a layer runs its kind's.

* training / scoring: :func:`lm_forward` and :func:`lm_loss`, a Python
  loop over the blocks in place of the reference's ``lax.scan``, each
  block under ``torch.utils.checkpoint`` with ``remat`` (the reference's
  ``nothing_saveable``: only a block's input is kept, the rest recomputed
  in the backward).  :func:`block_apply` casts a block's master weights to
  ``cfg.dtype`` through autograd (:func:`train_cast`), so the gradients
  reach the float32 masters, as the reference differentiates through its
  ``astype``.
* prefill / decode: local (SWA) layers keep *ring-buffer* KV caches of
  length ``window``; global layers keep full caches; hybrid layers add
  the Mamba state ``(h, conv_tail)`` and xlstm layers hold only their
  cell's state.  Decode runs the MoE without drops (``no_drop``).

Parameters are an :class:`LM` module whose ``blocks`` are per-layer
:class:`Block` modules: the reference's serving layout
(``unstack_params``), so no stacked copy exists here.  Master weights are
``cfg.param_dtype``; :func:`cast_params` gives the ``cfg.dtype`` compute
copy for serving (detached).

Learned positions differ from the reference in one place, on purpose:
its ``decode_step`` embeds the new token through ``embed_tokens(tokens[:,
None])``, which adds ``pos_emb[0]`` at every step; here a decode step adds
``pos_emb[pos]``, so the decode of a learned-position LM equals its own
forward.  The residual stream and the logits pass through
:func:`~repro_torch.dist.sharding.shard_activation` where the reference's
do: a no-op outside an ``activation_context`` (the dry run's DTensor
trace, :mod:`repro_torch.launch`).
"""

from __future__ import annotations

import copy
import math
import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.pipeline import resolve_device
from ..dist.sharding import (cache_zeros, fsdp_gather, keep_rules,
                             shard_activation)
from . import ssm
from .layers import (MLP, Attention, AttnSpec, MoE, Norm, _is_dtensor,
                     attend, attention_apply, decode_attention, mlp_apply,
                     moe_apply, norm_apply, project_qkv)

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_FAMILIES = ("decoder", "hybrid", "xlstm", "encdec")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family or position scheme no config of
    the reference has."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.pos not in ("rope", "none", "learned"):
        raise ValueError(f"unknown position scheme {cfg.pos!r}")


def _attn_spec(cfg: ModelConfig, kind: str) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    d_head=cfg.d_head, causal=True,
                    window=cfg.window if kind == "local" else 0,
                    softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
                    chunk=2048)


def _is_ring(cfg: ModelConfig, kind: str) -> bool:
    return kind == "local" and cfg.window > 0


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2``, ``moe`` (with ``n_experts``)
    or ``mlp`` (when ``d_ff``), ``ssm`` (hybrid), and ``ln1_post``/
    ``ln2_post`` with ``post_norm``; an xlstm layer ``ln1``, ``mlstm`` and
    ``slstm`` (with ``slstm_every``), whatever its kind."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **init)
        if cfg.family == "xlstm":
            self.mlstm = ssm.MLSTM(cfg.d_model, cfg.n_heads, cfg.ssm_expand,
                                   generator, **init)
            if cfg.slstm_every:
                self.slstm = ssm.SLSTM(cfg.d_model, cfg.n_heads, generator,
                                       **init)
            return
        self.attn = Attention(cfg.d_model, _attn_spec(cfg, "global"),
                              generator, **init)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **init)
        if cfg.post_norm:
            self.ln1_post = Norm(cfg.d_model, cfg.norm, **init)
            self.ln2_post = Norm(cfg.d_model, cfg.norm, **init)
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.glu,
                           generator, **init)
        elif cfg.d_ff:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.glu, generator, **init)
        if cfg.family == "hybrid":
            self.ssm = ssm.Mamba(cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                                 cfg.ssm_conv, generator, **init)


class LM(nn.Module):
    """``embed`` (vocab_padded, d), ``ln_f``, ``lm_head`` (d, vocab_padded)
    unless the embeddings are tied, ``pos_emb`` (max_seq, d) with learned
    positions, and ``blocks``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        dtype = _DT[cfg.param_dtype]
        scale = 1.0 / math.sqrt(cfg.d_model)

        def table(shape):
            if generator is None:
                t = torch.empty(shape, dtype=dtype, device=device)
            else:
                t = (torch.randn(shape, generator=generator, device=device)
                     * scale).to(dtype)
            return nn.Parameter(t, requires_grad=False)

        self.embed = table((cfg.vocab_padded, cfg.d_model))
        self.ln_f = Norm(cfg.d_model, cfg.norm, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = table((cfg.d_model, cfg.vocab_padded))
        if cfg.pos == "learned":
            self.pos_emb = table((cfg.max_seq, cfg.d_model))
        self.blocks = nn.ModuleList(
            Block(cfg, generator, dtype, device) for _ in range(cfg.n_layers))


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """Random parameters from ``generator`` (on ``device``, the card by
    default).  The reference's shapes and names, not its values."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")
    return LM(cfg, generator, dev)


def cast_params(p: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Mixed precision: ``p`` with its floating parameters in ``dtype`` (a
    copy; ``p`` itself when they already are).  Master params stay."""
    params = [t for t in p.parameters() if t.is_floating_point()]
    if all(t.dtype == dtype for t in params):
        return p
    memo = {id(t): nn.Parameter(t.detach().to(dtype), requires_grad=False)
            for t in params}
    return copy.deepcopy(p, memo)


def train_cast(p: nn.Module, dtype: torch.dtype):
    """Mixed precision for training: ``p``'s structure (attribute by
    attribute) with every floating parameter ``.to(dtype)`` — a cast that
    autograd differentiates, so the gradients reach the masters.  Sharded,
    each cast parameter is gathered over the FSDP axes
    (``dist.sharding.fsdp_gather``), in ``dtype``."""
    out = types.SimpleNamespace()
    for name, t in p.named_parameters(recurse=False):
        setattr(out, name, fsdp_gather(t.to(dtype))
                if t.is_floating_point() else t)
    for name, child in p.named_children():
        setattr(out, name, train_cast(child, dtype))
    return out


# --------------------------------------------------------------------------
# embedding and logits
# --------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
                 pos: int | None = None):
    """tokens (B, S) -> (B, S, d) in ``cfg.dtype``, learned positions
    ``0..S-1`` added (``pos``, ``pos+1``, ... from ``pos`` on, for a
    decode step).  The scaling and the sum run in float32, as the
    reference's do on float32 master weights: on ``params.embed_master``
    and ``params.pos_emb_master`` where a server's cast copy keeps them."""
    table = getattr(params, "embed_master", params.embed)
    x = (_lookup_on_shards(table, tokens) if _is_dtensor(table)
         else table[tokens]).float()
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.pos == "learned":
        table = getattr(params, "pos_emb_master", params.pos_emb)
        start = 0 if pos is None else pos
        x = x + table[start:start + tokens.shape[1]].float()
    return x.to(_DT[cfg.dtype])


def _lookup_on_shards(table, tokens):
    """``table[tokens]`` for a DTensor table (V, d) and tokens (B, S), on
    each rank's shard: the table gathered over every mesh axis but those
    that shard its d (FSDP's gather, for this use), each rank's rows of
    tokens looked up in its columns; the table's gradient comes back
    ``Partial`` over the axes that split the batch and is reduced to the
    table's own placements (FSDP's reduce-scatter).  DTensor's own
    strategy for the index's backward failed on torch 2.11 (an unnormalised
    ``Shard(-1)``, then a ``Shard`` to ``Partial`` it cannot run)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tok = tokens.placements if _is_dtensor(tokens) else \
        (Replicate(),) * mesh.ndim
    t_in, out, grad = [], [], []
    for tp, kp in zip(table.placements, tok):
        batch = isinstance(kp, Shard) and kp.dim == 0
        cols = isinstance(tp, Shard) and tp.dim == 1 and not batch
        t_in.append(Shard(1) if cols else Replicate())
        out.append(Shard(2) if cols else Shard(0) if batch else Replicate())
        grad.append(Shard(1) if cols else Partial() if batch else
                    Replicate())
    table = table.redistribute(mesh, t_in)
    return local_map(lambda t, i: t[i], out_placements=out,
                     in_placements=(tuple(t_in), tuple(tok)),
                     in_grad_placements=(tuple(grad), tuple(tok)),
                     device_mesh=mesh)(table, tokens)


def unembed(cfg: ModelConfig, params: LM, x: torch.Tensor):
    """(B, S, d) -> float32 logits (B, S, vocab_padded): the product in
    ``x``'s dtype, the final softcap, padded vocab rows at -1e30."""
    x = norm_apply(train_cast(params.ln_f, _DT[cfg.dtype]), x, cfg.norm)
    if cfg.tie_embeddings:      # (v, d) as it is: no transposed view
        logits = torch.einsum("bsd,vd->bsv", x,
                              fsdp_gather(params.embed.to(x.dtype)))
    else:
        logits = torch.einsum("bsd,dv->bsv", x,
                              fsdp_gather(params.lm_head.to(x.dtype)))
    logits = logits.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return shard_activation(mask_padded_vocab(cfg, logits), "logits")


def logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(logits))) over the last dim, by its max and a sum: two
    reductions DTensor runs on a vocab-sharded row (``torch.logsumexp``
    gathers the whole row on every device first)."""
    m = logits.amax(-1, keepdim=True).detach()
    return (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[
        ..., 0]


def mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor):
    """``logits`` (..., vocab_padded) with the padded columns at -1e30, so
    that softmax and argmax never pick an id past ``cfg.vocab``."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    vid = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vid < cfg.vocab, logits, -1e30)


# --------------------------------------------------------------------------
# forward and loss (training / scoring)
# --------------------------------------------------------------------------

def block_apply(cfg: ModelConfig, bp: Block, x: torch.Tensor, kind: str,
                positions: torch.Tensor):
    """One layer on the residual stream ``x`` (B, S, d) in ``cfg.dtype``,
    the block's masters cast through autograd; returns (x, aux), aux the
    MoE load-balance term (0 without experts)."""
    check_supported(cfg)
    bp = train_cast(bp, _DT[cfg.dtype])
    h = norm_apply(bp.ln1, x, cfg.norm)
    if cfg.family == "xlstm":
        y, _ = _cell(bp, kind, h)
        return x + y, _no_aux(x)
    attn = attention_apply(bp.attn, h, _attn_spec(cfg, kind), positions,
                           cfg.rope_theta, use_rope=(cfg.pos == "rope"),
                           norm_kind=cfg.norm)
    if cfg.family == "hybrid":
        attn = attn + ssm.mamba_apply(bp.ssm, h)[0]
    x, aux = _mlp_half(cfg, bp, x, attn)
    return x, _no_aux(x) if aux is None else aux


def lm_forward(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
               remat: bool = False):
    """tokens (B, S) -> (float32 logits (B, S, vocab_padded), aux): the
    blocks in order, each recomputed in the backward with ``remat``."""
    check_supported(cfg)
    x = shard_activation(embed_tokens(cfg, params, tokens), "residual")
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    auxs = []
    for i, bp in enumerate(params.blocks):
        if remat:
            x, aux = checkpoint(keep_rules(block_apply), cfg, bp, x,
                                cfg.layer_kind(i), positions,
                                use_reentrant=False)
        else:
            x, aux = block_apply(cfg, bp, x, cfg.layer_kind(i), positions)
        auxs.append(aux)
    return unembed(cfg, params, x), torch.stack(auxs).mean()


def lm_loss(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            labels: torch.Tensor, remat: bool = False,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Next-token cross-entropy (labels are the tokens shifted by the
    caller; -100 masks) plus the aux and z losses; returns (loss, {"ce",
    "aux", "z", "ppl"})."""
    logits, aux = lm_forward(cfg, params, tokens, remat=remat)
    mask = labels >= 0
    lbl = torch.where(mask, labels, 0)
    logz = logsumexp(logits)
    # the label logit by a mask-sum, as the reference takes it
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(vocab == lbl[..., None], logits, 0.0).sum(-1)
    ll = picked - logz
    denom = torch.clamp(mask.sum(), min=1)
    ce = -(ll * mask).sum() / denom
    z_loss = ((logz * mask) ** 2).sum() / denom
    loss = ce + aux_weight * aux + z_weight * z_loss
    return loss, {"ce": ce, "aux": aux, "z": z_loss,
                  "ppl": torch.exp(torch.clamp(ce, max=20.0))}


# --------------------------------------------------------------------------
# KV caches, prefill and decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Per-layer caches: ``{"k", "v"}`` in ``cfg.dtype`` (local (SWA)
    layers get ring buffers of length ``window``), with ``"ssm"`` = (h
    float32, conv_tail ``cfg.dtype``) for hybrid layers; an xlstm layer's
    ``{"state"}`` is its cell's, float32.  Zeros, sharded by the cache
    rules inside an ``activation_context``."""
    check_supported(cfg)
    dev = resolve_device(device)
    adt = _DT[cfg.dtype]
    f32 = torch.float32
    di = cfg.ssm_expand * cfg.d_model
    cache = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if cfg.family == "xlstm":
            if kind == "slstm":
                state = tuple(cache_zeros((batch, cfg.d_model), f32, dev)
                              for _ in range(4))
            else:
                H, dh = cfg.n_heads, di // cfg.n_heads
                state = (cache_zeros((batch, H, dh, dh), f32, dev),
                         cache_zeros((batch, H, dh), f32, dev),
                         cache_zeros((batch, H), f32, dev))
            cache.append({"state": state})
            continue
        L = min(cfg.window, max_len) if _is_ring(cfg, kind) else max_len
        shape = (batch, L, cfg.n_kv_heads, cfg.d_head)
        entry = {"k": cache_zeros(shape, adt, dev),
                 "v": cache_zeros(shape, adt, dev)}
        if cfg.family == "hybrid":
            entry["ssm"] = (cache_zeros((batch, di, cfg.ssm_state), f32, dev),
                            cache_zeros((batch, cfg.ssm_conv - 1, di), adt,
                                        dev))
        cache.append(entry)
    return cache


def _no_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _cell(bp, kind: str, h, state=None):
    """An xlstm layer's cell of its kind on ``h``: (y, state)."""
    if kind == "slstm":
        return ssm.slstm_apply(bp.slstm, h, state)
    return ssm.mlstm_apply(bp.mlstm, h, state)


def _mlp_half(cfg: ModelConfig, bp: Block, x, attn, no_drop=False):
    """(the residual stream after a layer's attention output ``attn``,
    the MoE's aux or None without experts).  The stream after the
    attention passes :func:`shard_activation`, as in the reference's
    training block."""
    if cfg.post_norm:
        attn = norm_apply(bp.ln1_post, attn, cfg.norm)
    x = shard_activation(x + attn, "residual")
    h2 = norm_apply(bp.ln2, x, cfg.norm)
    aux = None
    if cfg.n_experts:
        y, aux = moe_apply(bp.moe, h2, cfg.top_k, cfg.act,
                           cfg.capacity_factor, no_drop=no_drop)
    elif cfg.d_ff:
        y = mlp_apply(bp.mlp, h2, cfg.act)
    else:
        y = torch.zeros_like(h2)
    if cfg.post_norm:
        y = norm_apply(bp.ln2_post, y, cfg.norm)
    return x + y, aux


def prefill(cfg: ModelConfig, params: LM, tokens: torch.Tensor,
            max_len: int):
    """Process a prompt (B, S); return (last-position logits (B, V), the
    filled cache)."""
    check_supported(cfg)
    B, S = tokens.shape
    dev = params.embed.device
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(S, device=dev)
    cache = init_cache(cfg, B, max_len, dev)
    for i, entry in enumerate(cache):
        bp = cast_params(params.blocks[i], _DT[cfg.dtype])
        kind = cfg.layer_kind(i)
        h = norm_apply(bp.ln1, x, cfg.norm)
        if cfg.family == "xlstm":
            y, entry["state"] = _cell(bp, kind, h)
            x = x + y
            continue
        spec = _attn_spec(cfg, kind)
        q, k, v = project_qkv(bp.attn, h, spec, positions, cfg.rope_theta,
                              use_rope=(cfg.pos == "rope"),
                              norm_kind=cfg.norm)
        attn = torch.einsum("bshk,hkd->bsd", attend(q, k, v, spec),
                            bp.attn.wo)
        kc, vc = entry["k"], entry["v"]
        L = kc.shape[1]
        if _is_ring(cfg, kind) and S >= L:
            # ring buffer smaller than the prompt: keep the last L KVs at
            # their rotated slots (slot = position % L)
            idx = torch.arange(S - L, S, device=dev) % L
            kc[:, idx] = k[:, -L:].to(kc.dtype)
            vc[:, idx] = v[:, -L:].to(vc.dtype)
        else:
            kc[:, :S] = k.to(kc.dtype)
            vc[:, :S] = v.to(vc.dtype)
        if cfg.family == "hybrid":
            smo, entry["ssm"] = ssm.mamba_apply(bp.ssm, h)
            attn = attn + smo
        x, _ = _mlp_half(cfg, bp, x, attn)
    logits = unembed(cfg, params, x[:, -1:])
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor,
                pos: int):
    """One decode step: tokens (B,), position ``pos`` -> (logits (B, V),
    cache).  The cache is updated in place and returned."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, tokens[:, None], pos)[:, 0]  # (B,D)
    for i, entry in enumerate(cache):
        bp = cast_params(params.blocks[i], _DT[cfg.dtype])
        kind = cfg.layer_kind(i)
        h = norm_apply(bp.ln1, x[:, None], cfg.norm)
        if cfg.family == "xlstm":
            y, entry["state"] = _cell(bp, kind, h, entry["state"])
            x = x + y[:, 0]
            continue
        attn, entry["k"], entry["v"] = decode_attention(
            bp.attn, h[:, 0], entry["k"], entry["v"], pos,
            _attn_spec(cfg, kind), cfg.rope_theta,
            use_rope=(cfg.pos == "rope"), ring=_is_ring(cfg, kind),
            norm_kind=cfg.norm)
        if cfg.family == "hybrid":
            smo, entry["ssm"] = ssm.mamba_apply(bp.ssm, h, entry["ssm"])
            attn = attn + smo[:, 0]
        x, _ = _mlp_half(cfg, bp, x[:, None], attn[:, None], no_drop=True)
        x = x[:, 0]
    logits = unembed(cfg, params, x[:, None])
    return logits[:, 0], cache
