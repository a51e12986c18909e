"""AdamW + schedules + gradient utilities, from scratch (no ``torch.optim``).

The port of ``repro.train.optimizer``.  Parameters, gradients and moments
are dicts of tensors keyed by name (an LM's ``named_parameters()``), and
the moments live in float32 on the parameters' device.  Two points where
``torch.optim.AdamW`` would differ from the reference, and this module
does not:

* the learning rate is the schedule at ``count + 1``, and the bias
  corrections use that count;
* weight decay applies to leaves of rank >= 2 *in the reference's tree*,
  where a block's leaves are stacked on a leading layer axis: a block's
  norm scale is rank 1 here and rank 2 there, so it is decayed
  (:func:`leaf_rank`).

:func:`adamw_update` writes the parameters and moments in place under
``torch.no_grad`` (the reference donates its buffers to the jitted step),
so a step at full width never holds a second copy of the masters.

Sharded (DTensor parameters, ``train.loop`` under ``rules=``): the moments
are DTensors placed as their parameters (the reference's moments inherit
the parameter sharding); each gradient is first redistributed to its
parameter's placements (``dist.sharding.like_placements``: a gradient
still ``Partial`` over the batch axes is reduced there, the data-parallel
reduction), and the global norm is one replicated value on every rank.
The step count, learning rate and bias corrections stay plain 0-d
tensors, equal on every rank, which meet the DTensor moments under
DTensor's ``implicit_replication`` (``dist.sharding.plain_replicated``),
opened here for DTensor parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

from ..dist.sharding import (STACKS, like_placements, plain_replicated,
                             replicated)


@dataclasses.dataclass
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False     # int8 error-feedback compression


def cosine_schedule(cfg: OptConfig) -> Callable:
    """``lr(step)``: linear warm-up, then a cosine down to
    ``min_lr_ratio * lr``; a float32 0-d tensor on ``step``'s device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(
            cfg.total_steps - cfg.warmup_steps, 1)
        prog = prog.clamp(0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def stacked_leaf(name: str) -> str:
    """The reference's leaf that holds parameter ``name``: its blocks are
    stacked, so ``blocks.<i>.rest`` of every layer (a Whisper's
    ``enc_blocks``, ``dec_blocks``) is one leaf there."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return ".".join([parts[0], "*", *parts[2:]])
    return name


def leaf_rank(name: str, t: torch.Tensor) -> int:
    """The rank of leaf ``name`` in the reference's tree, where a block's
    leaves carry the stacked layer axis."""
    return t.dim() + (stacked_leaf(name) != name)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero float32 moments beside each parameter (placed as it is, when
    it is a DTensor), and a step count."""
    zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"mu": zeros,
            "nu": {k: z.clone() for k, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32 (over
    DTensors, one replicated value)."""
    return replicated(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                     for g in grads.values())))


def _clip_scale(gnorm: torch.Tensor, max_norm) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before clipping)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict,
                 lr_fn=None):
    """One AdamW step after clipping ``grads`` to ``cfg.clip_norm``.
    ``params`` and the moments are updated in place; returns (params, the
    state with its new count, {"grad_norm", "lr"})."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    grads = {k: like_placements(grads[k], p) for k, p in params.items()}
    with plain_replicated():
        return _adamw_update(cfg, params, grads, state, lr_fn)


def _adamw_update(cfg, params, grads, state, lr_fn):
    # clipped leaf by leaf below, so no second copy of the gradients
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = state["count"] + 1
    lr = lr_fn(count)
    b1, b2 = cfg.betas
    c = count.to(torch.float32)
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    for k, p in params.items():
        g = grads[k].float() * scale
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if leaf_rank(k, p) >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, state, {"grad_norm": gnorm, "lr": lr}
