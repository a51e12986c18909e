"""The decoder LM (``repro.models`` in PyTorch): training forward and loss,
and the serving path."""

from .lm_serve import LMServeStats, ServeEngine, sample_token
from .transformer import (LM, block_apply, cast_params, decode_step,
                          init_cache, init_lm, lm_forward, lm_loss, prefill,
                          train_cast)

__all__ = ["LM", "LMServeStats", "ServeEngine", "block_apply", "cast_params",
           "decode_step", "init_cache", "init_lm", "lm_forward", "lm_loss",
           "prefill", "sample_token", "train_cast"]
