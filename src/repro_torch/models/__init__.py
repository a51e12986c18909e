"""The models (``repro.models`` in PyTorch): the decoder LM's training
forward and loss and its serving path, and the Whisper encoder-decoder."""

from .lm_serve import LMServeStats, ServeEngine, sample_token
from .transformer import (LM, block_apply, cast_params, decode_step,
                          init_cache, init_lm, lm_forward, lm_loss, prefill,
                          train_cast)
from .whisper import Whisper, init_whisper, whisper_forward, whisper_loss

__all__ = ["LM", "LMServeStats", "ServeEngine", "Whisper", "block_apply",
           "cast_params", "decode_step", "init_cache", "init_lm",
           "init_whisper", "lm_forward", "lm_loss", "prefill", "sample_token",
           "train_cast", "whisper_forward", "whisper_loss"]
