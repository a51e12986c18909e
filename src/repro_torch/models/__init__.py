"""The decoder LM's serving path (``repro.models`` in PyTorch)."""

from .lm_serve import LMServeStats, ServeEngine, sample_token
from .transformer import (LM, cast_params, decode_step, init_cache, init_lm,
                          prefill)

__all__ = ["LM", "LMServeStats", "ServeEngine", "cast_params", "decode_step",
           "init_cache", "init_lm", "prefill", "sample_token"]
