"""Batched LM serving engine: prefill, then decode over KV caches.

The port of ``repro.models.lm_serve``.  Local (SWA) layers hold ring-buffer
caches (length = window), so decode state is bounded regardless of
generation length; global layers hold full caches up to ``max_len``.
Requests are served in fixed batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.pipeline import resolve_device
from .transformer import LM, _DT, cast_params, decode_step, prefill


def sample_token(logits: torch.Tensor, generator: torch.Generator | None
                 = None, temperature: float = 0.0) -> torch.Tensor:
    """Greedy ``argmax`` at temperature 0, else a draw from
    ``softmax(logits / temperature)`` with ``generator``."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass
class LMServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0


class ServeEngine:
    """Fixed-batch generation on ``device`` (the card by default).  The
    weights are cast to ``cfg.dtype`` once, here, which is what the
    reference's per-call ``cast_params`` computes; with ``emb_scale`` or
    learned positions the lookup also keeps the master embedding (and
    positions), since the reference scales and sums the master rows before
    it casts them."""

    def __init__(self, cfg: ModelConfig, params: LM, batch: int,
                 max_len: int, temperature: float = 0.0, eos: int = -1,
                 device=None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = cast_params(params, _DT[cfg.dtype])
        if (cfg.emb_scale or cfg.pos == "learned") \
                and self.params is not params:
            # the lookup scales the master rows and adds the master
            # positions (shared, not copied); the unembed reads the table
            # cast here
            self.params.embed_master = params.embed.detach()
            if cfg.pos == "learned":
                self.params.pos_emb_master = params.pos_emb.detach()
        self.batch, self.max_len = batch, max_len
        self.temperature, self.eos = temperature, eos
        self.stats = LMServeStats()

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, seed: int = 0):
        """prompts: (B, S) token ids (numpy or tensor; fixed-shape serving,
        padding is the caller's concern).  Returns (B, new) int32 ids."""
        prompts = torch.as_tensor(np.asarray(prompts), device=self.device,
                                  dtype=torch.long)
        B, S = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != the engine's {self.batch}")
        logits, cache = prefill(self.cfg, self.params, prompts, self.max_len)
        self.stats.prefill_tokens += B * S
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = sample_token(logits, gen, self.temperature)
        out = [tok]
        done = tok == self.eos
        for i in range(max_new_tokens - 1):
            logits, cache = decode_step(self.cfg, self.params, cache, tok,
                                        S + i)
            tok = sample_token(logits, gen, self.temperature)
            out.append(tok)
            self.stats.decode_tokens += B
            done = done | (tok == self.eos)
            if bool(done.all()):
                break
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
