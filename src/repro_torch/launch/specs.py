"""Sharded step builders for the dry run (the port of
``repro.launch.specs``).

Everything here is allocation-free: parameters, optimizer moments, caches
and inputs are DTensors over a ``DeviceMesh`` whose local shards are
``"meta"`` tensors, placed by the :mod:`repro_torch.dist.sharding` rules,
and each step is the port's own program on them: ``lm_loss`` or
``whisper_loss`` through the train step that ``train.Trainer(rules=)``
runs (``train.loop.train_step``: gradients accumulated, AdamW),
``prefill`` / ``whisper_prefill``, or ``decode_step`` /
``whisper_decode_step``.  A step runs inside ``activation_context(rules)``
(the reference's ``with_sharding_constraint`` points) and DTensor's
``implicit_replication`` (the plain tensors a model makes: positions,
masks, zeros, count as replicated on every device).

The reference builds ``jax.ShapeDtypeStruct`` trees and ``NamedSharding``
trees for ``jax.jit(...).lower``; here the DTensors carry both.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from ..dist.sharding import (ShardingRules, activation_context,
                             param_specs, plain_replicated, replace_params,
                             sharded_empty)
from ..models.transformer import (LM, decode_step, init_cache, lm_loss,
                                  prefill)
from ..models.whisper import (Whisper, whisper_decode_step,
                              whisper_init_cache, whisper_loss,
                              whisper_prefill)
from ..train.loop import TrainConfig, train_step
from ..train.optimizer import OptConfig, adamw_init

#: the device of every local shard: shapes only, nothing allocated
META = torch.device("meta")


def params_shapes(cfg: ModelConfig, inference: bool = False) -> nn.Module:
    """The model (``LM``, or ``Whisper`` for an ``encdec`` config) on the
    meta device: names, shapes and dtypes, no storage; floating parameters
    in bfloat16 with ``inference`` (the served copy)."""
    model = (Whisper if cfg.family == "encdec" else LM)(cfg, device=META)
    return model.to(torch.bfloat16) if inference else model


def shard_params(cfg: ModelConfig, model: nn.Module, rules: ShardingRules,
                 per_layer: bool = False, requires_grad: bool = False):
    """``model`` with every parameter replaced by a DTensor placed by
    ``param_specs`` (meta local shards)."""
    specs = param_specs(cfg, model, rules, per_layer)
    model.requires_grad_(requires_grad)
    return replace_params(model, lambda name, p: sharded_empty(
        p.shape, p.dtype, META, specs[name], rules.mesh))


def _batch_axes_spec(rules: ShardingRules, batch: int):
    """Batch spec entry, guarding divisibility (B=1 cells)."""
    axes = rules.batch_axes()
    if axes and batch % rules.axis_size(axes) == 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> dict:
    """{name: (shape, dtype, spec)} of every model input of the cell;
    a decode cell's ``pos`` is a Python int, the cache's last slot."""
    B, S = shape.global_batch, shape.seq_len
    bspec = _batch_axes_spec(rules, B)
    out = {"tokens": ((B, S), torch.long, (bspec, None))}
    if shape.kind == "train":
        out["labels"] = out["tokens"]
    if cfg.family == "encdec":
        out["frames"] = ((B, cfg.enc_seq, cfg.d_model), torch.bfloat16,
                         (bspec, None, None))
    if shape.kind == "decode":
        out["tokens"] = ((B,), torch.long, (bspec,))
        out["pos"] = S - 1
    return out


def make_inputs(specs: dict, rules: ShardingRules) -> dict:
    """DTensors (meta local shards) for :func:`input_specs`' entries."""
    return {k: v if isinstance(v, int) else sharded_empty(
        v[0], v[1], META, v[2], rules.mesh) for k, v in specs.items()}


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      rules: ShardingRules, budget_bytes=6 * 2**30) -> int:
    """Gradient-accumulation factor so the per-layer saved residuals
    (L · B_loc/mb · S · D · 2 bytes) fit the activation budget."""
    dp = rules.axis_size(rules.batch_axes())
    b_loc = max(shape.global_batch // dp, 1)
    tp = rules.axis_size(rules.tp) if rules.tp else 1
    h_loc = (cfg.n_heads // tp) if cfg.n_heads % tp == 0 else cfg.n_heads
    mb = 1
    while mb < b_loc:
        saved = (cfg.n_layers * (b_loc / mb) * shape.seq_len
                 * cfg.d_model * 2)
        # flash-attention f32 score tiles (~3 live copies in the bwd
        # recompute); chunk = 2048 in AttnSpec
        chunk = min(2048, shape.seq_len)
        flash = 3 * (b_loc / mb) * h_loc * shape.seq_len * chunk * 4
        if saved + flash <= budget_bytes:
            break
        mb *= 2
    return mb


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     rules: ShardingRules, remat: bool = True,
                     microbatches: int | None = None):
    """Returns (step, args): ``step(*args)`` runs one AdamW step of the
    loss, gradients accumulated over ``step.microbatches``: the step
    ``Trainer(rules=)`` runs (``train.loop.train_step``), on meta shards."""
    mb = microbatches or auto_microbatches(cfg, shape, rules)
    params = shard_params(cfg, params_shapes(cfg), rules,
                          requires_grad=True)
    ins = make_inputs(input_specs(cfg, shape, rules), rules)
    if cfg.family == "encdec":
        names = ("frames", "tokens", "labels")

        def loss_fn(p, b):
            return whisper_loss(cfg, p, b["frames"], b["tokens"],
                                b["labels"], remat=remat)
    else:
        names = ("tokens", "labels")

        def loss_fn(p, b):
            return lm_loss(cfg, p, b["tokens"], b["labels"], remat=remat)
    body = train_step(loss_fn, TrainConfig(opt=OptConfig(), microbatches=mb,
                                           remat=remat), rules)

    def step(params, opt_state, *batch):
        params, opt_state, _, metrics = body(params, opt_state, None,
                                             dict(zip(names, batch)))
        return params, opt_state, metrics["loss"]

    step.microbatches = mb
    named = dict(params.named_parameters())
    return step, (params, adamw_init(named), *(ins[k] for k in names))


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: ShardingRules):
    params = shard_params(cfg, params_shapes(cfg, inference=True), rules)
    ins = make_inputs(input_specs(cfg, shape, rules), rules)
    max_len = shape.seq_len

    if cfg.family == "encdec":
        def step(params, frames, tokens):
            with activation_context(rules), plain_replicated():
                return whisper_prefill(cfg, params, frames, tokens, max_len)
        return step, (params, ins["frames"], ins["tokens"])

    def step(params, tokens):
        with activation_context(rules), plain_replicated():
            return prefill(cfg, params, tokens, max_len)
    return step, (params, ins["tokens"])


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      rules: ShardingRules):
    """serve_step: one new token against a KV cache of length seq_len.
    The LM's parameters take the serving layout's per-layer specs (the
    reference's ``unstacked`` tree); Whisper's stay stacked, as there."""
    encdec = cfg.family == "encdec"
    params = shard_params(cfg, params_shapes(cfg, inference=True), rules,
                          per_layer=not encdec)
    B, S = shape.global_batch, shape.seq_len
    with activation_context(rules):
        cache = (whisper_init_cache if encdec else init_cache)(
            cfg, B, S, device=META)
    ins = make_inputs(input_specs(cfg, shape, rules), rules)
    dec = whisper_decode_step if encdec else decode_step

    def step(params, cache, tokens, pos):
        with activation_context(rules), plain_replicated():
            return dec(cfg, params, cache, tokens, pos)

    return step, (params, cache, ins["tokens"], ins["pos"])


def build_step(cfg, shape, rules, remat=True):
    if shape.kind == "train":
        return build_train_step(cfg, shape, rules, remat=remat)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, rules)
    return build_decode_step(cfg, shape, rules)
