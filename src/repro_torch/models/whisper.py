"""The Whisper-style encoder-decoder in PyTorch: parameters, the training
forward and loss, prefill and cached decode.

The port of ``repro.models.whisper``.  As there, the audio frontend is a
stub: the caller supplies precomputed frame embeddings (B, enc_seq, d),
and the conv1d x2 + log-mel stack is one learned projection
(``frontend_proj``).  The encoder runs bidirectional attention over the
frames; the decoder causal self-attention, then cross-attention over the
encoder's output; both add learned positions, and neither has RoPE.

* training / scoring: :func:`encode`, :func:`decode`,
  :func:`whisper_forward` and :func:`whisper_loss`, a Python loop over
  the blocks in place of the reference's ``lax.scan``; with ``remat``
  each block runs under ``torch.utils.checkpoint`` (the reference's
  ``nothing_saveable``).  Each block's weights are cast to ``cfg.dtype``
  through autograd (:func:`~.transformer.train_cast`), as the reference
  casts them, so the gradients reach the float32 masters.
* serving: :func:`whisper_prefill` encodes the audio, runs the decoder
  over the prompt and fills the caches (self k/v of length ``max_len``,
  cross ``xk``/``xv`` from the encoder); :func:`whisper_decode_step` runs
  one token.  Both mask the padded vocabulary to -1e30, as :func:`decode`
  does: the reference's serving pair does not (``whisper.py:208-210,
  241-243``), so a greedy pick there can land on an id past ``vocab``.

Attention is the plain PyTorch of :mod:`.layers` (dense, blockwise past
``chunk``), as the reference's is plain jnp: no kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.pipeline import resolve_device
from ..dist.sharding import (cache_zeros, fsdp_gather, keep_rules,
                             shard_activation)
from .layers import (MLP, Attention, AttnSpec, Norm, _is_dtensor, attend,
                     attention_apply, decode_attention, dense_attention,
                     mlp_apply, norm_apply, project_qkv, rows_ready,
                     to_heads)
from .transformer import (_DT, _lookup_on_shards, cast_params, logsumexp,
                          mask_padded_vocab, train_cast)


def _spec(cfg: ModelConfig, causal: bool) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    d_head=cfg.d_head, causal=causal, window=0, chunk=2048)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class EncBlock(nn.Module):
    """``ln1``, ``attn`` (bidirectional), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **init)
        self.attn = Attention(cfg.d_model, _spec(cfg, False), generator,
                              **init)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **init)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.glu, generator, **init)


class DecBlock(nn.Module):
    """``ln1``, ``attn`` (causal), ``ln_x``, ``xattn`` (cross), ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        init = dict(dtype=dtype, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **init)
        self.attn = Attention(cfg.d_model, _spec(cfg, True), generator,
                              **init)
        self.ln_x = Norm(cfg.d_model, cfg.norm, **init)
        self.xattn = Attention(cfg.d_model, _spec(cfg, False), generator,
                               **init)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **init)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.glu, generator, **init)


class Whisper(nn.Module):
    """``frontend_proj`` (d, d), ``enc_pos`` (enc_seq, d), ``embed``
    (vocab_padded, d; tied to the output), ``dec_pos`` (max_seq, d),
    ``ln_enc``, ``ln_f``, ``enc_blocks`` and ``dec_blocks``: the
    reference's names, its stacked blocks split per layer."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name} is a {cfg.family!r} config; "
                             "Whisper builds an encdec one")
        dtype = _DT[cfg.param_dtype]
        scale = 1.0 / math.sqrt(cfg.d_model)

        def table(shape):
            if generator is None:
                t = torch.empty(shape, dtype=dtype, device=device)
            else:
                t = (torch.randn(shape, generator=generator, device=device)
                     * scale).to(dtype)
            return nn.Parameter(t, requires_grad=False)

        self.frontend_proj = table((cfg.d_model, cfg.d_model))
        self.enc_pos = table((cfg.enc_seq, cfg.d_model))
        self.embed = table((cfg.vocab_padded, cfg.d_model))
        self.dec_pos = table((cfg.max_seq, cfg.d_model))
        self.ln_enc = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.ln_f = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, generator, dtype, device)
            for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, generator, dtype, device)
            for _ in range(cfg.n_layers))


def init_whisper(cfg: ModelConfig, generator: torch.Generator,
                 device=None) -> Whisper:
    """Random parameters from ``generator`` (on ``device``, the card by
    default).  The reference's shapes and names, not its values."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters "
                         f"go to {dev}")
    return Whisper(cfg, generator, dev)


# --------------------------------------------------------------------------
# forward and loss (training / scoring)
# --------------------------------------------------------------------------

def _enc_block(cfg: ModelConfig, bp: EncBlock, x):
    bp = train_cast(bp, x.dtype)
    h = norm_apply(bp.ln1, x, cfg.norm)
    x = x + attention_apply(bp.attn, h, _spec(cfg, False), use_rope=False,
                            norm_kind=cfg.norm)
    h = norm_apply(bp.ln2, x, cfg.norm)
    return shard_activation(x + mlp_apply(bp.mlp, h, cfg.act), "residual")


def _cross_kv(bp, enc_out):
    """The cross-attention's k and v (B, enc_seq, KV, Dh) of the encoder's
    output."""
    return to_heads(enc_out, bp.xattn.wk), to_heads(enc_out, bp.xattn.wv)


def _dec_block(cfg: ModelConfig, bp: DecBlock, x, enc_out):
    bp = train_cast(bp, x.dtype)
    spec = _spec(cfg, True)
    h = norm_apply(bp.ln1, x, cfg.norm)
    x = x + attention_apply(bp.attn, h, spec, use_rope=False,
                            norm_kind=cfg.norm)
    h = norm_apply(bp.ln_x, x, cfg.norm)
    # the causal self-spec: the override makes it non-causal, as there
    x = x + attention_apply(bp.xattn, h, spec, use_rope=False,
                            kv_override=_cross_kv(bp, enc_out),
                            norm_kind=cfg.norm)
    h = norm_apply(bp.ln2, x, cfg.norm)
    return shard_activation(x + mlp_apply(bp.mlp, h, cfg.act), "residual")


def _run(block, cfg, blocks, x, *extra, remat=False):
    for bp in blocks:
        if remat:
            x = checkpoint(keep_rules(block), cfg, bp, x, *extra,
                           use_reentrant=False)
        else:
            x = block(cfg, bp, x, *extra)
    return x


def encode(cfg: ModelConfig, params: Whisper, frames: torch.Tensor,
           remat: bool = False):
    """frames (B, enc_seq, d), precomputed embeddings (the frontend stub)
    -> the encoder's output (B, enc_seq, d) in ``cfg.dtype``."""
    dt = _DT[cfg.dtype]
    x = rows_ready(torch.einsum("bsd,de->bse", rows_ready(frames.to(dt)),
                                fsdp_gather(params.frontend_proj.to(dt))))
    x = x + _positions(params.enc_pos, 0, x.shape[1], dt)
    x = _run(_enc_block, cfg, params.enc_blocks, x, remat=remat)
    return norm_apply(train_cast(params.ln_enc, dt), x, cfg.norm)


def _embed(cfg: ModelConfig, params: Whisper, tokens, start: int = 0):
    """tokens (B, S) -> (B, S, d): the rows cast to ``cfg.dtype``, then
    the positions ``start..`` added in it, as the reference adds them."""
    dt = _DT[cfg.dtype]
    x = (_lookup_on_shards(params.embed, tokens) if _is_dtensor(params.embed)
         else params.embed[tokens]).to(dt)
    return x + _positions(params.dec_pos, start, tokens.shape[1], dt)


def _positions(table, start: int, n: int, dt):
    """Rows ``start..start+n`` of a learned position table in ``dt``; a
    DTensor table (FSDP shards its rows) cast and gathered first, as a
    layer's weights are (``train_cast``)."""
    if _is_dtensor(table):
        table = fsdp_gather(table.to(dt))
    return table[start:start + n].to(dt)


def _logits(cfg: ModelConfig, params: Whisper, x):
    """(B, S, d) -> float32 logits (B, S, vocab_padded), padded ids at
    -1e30, through the tied table."""
    x = norm_apply(train_cast(params.ln_f, x.dtype), x, cfg.norm)
    logits = torch.einsum("bsd,vd->bsv", x,
                          fsdp_gather(params.embed.to(x.dtype)))
    return mask_padded_vocab(cfg, rows_ready(logits).float())


def decode(cfg: ModelConfig, params: Whisper, enc_out: torch.Tensor,
           tokens: torch.Tensor, remat: bool = False):
    """The decoder over tokens (B, S) against ``enc_out`` -> float32
    logits (B, S, vocab_padded)."""
    x = _run(_dec_block, cfg, params.dec_blocks, _embed(cfg, params, tokens),
             enc_out, remat=remat)
    return shard_activation(_logits(cfg, params, x), "logits")


def whisper_forward(cfg: ModelConfig, params: Whisper, frames, tokens,
                    remat: bool = False):
    return decode(cfg, params, encode(cfg, params, frames, remat=remat),
                  tokens, remat=remat)


def whisper_loss(cfg: ModelConfig, params: Whisper, frames, tokens, labels,
                 remat: bool = False):
    """Cross-entropy of the decoder's logits against ``labels`` (-100
    masks; the mean over the others); returns (ce, {"ce": ce})."""
    logits = whisper_forward(cfg, params, frames, tokens, remat=remat)
    mask = labels >= 0
    lbl = torch.where(mask, labels, 0)
    logz = logsumexp(logits)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(vocab == lbl[..., None], logits, 0.0).sum(-1)
    ll = picked - logz
    denom = torch.clamp(mask.sum(), min=1)
    ce = -(ll * mask).sum() / denom
    return ce, {"ce": ce}


# --------------------------------------------------------------------------
# serving: prefill + cached decode
# --------------------------------------------------------------------------

def whisper_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                       device=None):
    """Per decoder layer ``{"k", "v"}`` (B, max_len, KV, Dh) and the
    cross-attention's ``{"xk", "xv"}`` (B, enc_seq, KV, Dh), zeros in
    ``cfg.dtype`` (sharded by the cache rules inside an
    ``activation_context``)."""
    dev = resolve_device(device)
    dt = _DT[cfg.dtype]
    self_shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    cross_shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)
    return [{"k": cache_zeros(self_shape, dt, dev),
             "v": cache_zeros(self_shape, dt, dev),
             "xk": cache_zeros(cross_shape, dt, dev),
             "xv": cache_zeros(cross_shape, dt, dev)}
            for _ in range(cfg.n_layers)]


def whisper_prefill(cfg: ModelConfig, params: Whisper, frames, tokens,
                    max_len: int):
    """Encode the audio, run the decoder over the prompt (B, S) and fill
    the caches; returns (last-position logits (B, vocab_padded), padded
    ids at -1e30; the cache)."""
    dt = _DT[cfg.dtype]
    B, S = tokens.shape
    enc_out = encode(cfg, params, frames)
    x = _embed(cfg, params, tokens)
    spec = _spec(cfg, True)
    cache = whisper_init_cache(cfg, B, max_len, enc_out.device)
    for bp, entry in zip(params.dec_blocks, cache):
        bp = cast_params(bp, dt)
        h = norm_apply(bp.ln1, x, cfg.norm)
        q, k, v = project_qkv(bp.attn, h, spec, use_rope=False,
                              norm_kind=cfg.norm)
        entry["k"][:, :S] = k
        entry["v"][:, :S] = v
        x = x + torch.einsum("bshk,hkd->bsd", attend(q, k, v, spec),
                             bp.attn.wo)
        h = norm_apply(bp.ln_x, x, cfg.norm)
        entry["xk"], entry["xv"] = _cross_kv(bp, enc_out)
        x = x + attention_apply(bp.xattn, h, spec, use_rope=False,
                                kv_override=(entry["xk"], entry["xv"]),
                                norm_kind=cfg.norm)
        h = norm_apply(bp.ln2, x, cfg.norm)
        x = x + mlp_apply(bp.mlp, h, cfg.act)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def whisper_decode_step(cfg: ModelConfig, params: Whisper, cache, tokens,
                        pos: int):
    """One decoder token (B,) at position ``pos`` against the self-attention
    cache (written in place) and the fixed cross k/v; returns (logits (B,
    vocab_padded), padded ids at -1e30; the cache)."""
    dt = _DT[cfg.dtype]
    x = _embed(cfg, params, tokens[:, None], pos)[:, 0]            # (B,d)
    spec = _spec(cfg, True)
    cross = dataclasses.replace(spec, causal=False)
    for bp, entry in zip(params.dec_blocks, cache):
        bp = cast_params(bp, dt)
        h = norm_apply(bp.ln1, x[:, None], cfg.norm)[:, 0]
        attn, entry["k"], entry["v"] = decode_attention(
            bp.attn, h, entry["k"], entry["v"], pos, spec, use_rope=False,
            norm_kind=cfg.norm)
        x = x + attn
        h = norm_apply(bp.ln_x, x[:, None], cfg.norm)
        out = dense_attention(torch.einsum("bsd,dhk->bshk", h, bp.xattn.wq),
                              entry["xk"], entry["xv"], cross)
        x = x + torch.einsum("bshk,hkd->bsd", out, bp.xattn.wo)[:, 0]
        h = norm_apply(bp.ln2, x[:, None], cfg.norm)
        x = x + mlp_apply(bp.mlp, h, cfg.act)[:, 0]
    return _logits(cfg, params, x[:, None])[:, 0], cache
