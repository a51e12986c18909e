"""xLSTM 350M [arXiv:2405.04517; unverified tier].

24L d_model=1024 4H d_ff=0 vocab=50304 — mLSTM blocks (matrix memory,
internal up-projection x2, no separate FFN) with sLSTM every 8th layer
(~7:1 ratio).  No positional encoding (the recurrence orders the sequence).
Fully recurrent: long_500k decode carries O(1) state — the paper's
shift-buffer/streaming structure is the architecture itself.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="xlstm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        norm="layernorm", pos="none", glu=False,
        ssm_expand=2, slstm_every=8,
        layer_pattern=("mlstm",) * 7 + ("slstm",),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=256, norm="layernorm", pos="none", glu=False,
        ssm_expand=2, slstm_every=2, layer_pattern=("mlstm", "slstm"),
        max_seq=128,
    )
