"""Gemma-3 1B [hf:google/gemma-3-1b-pt; unverified tier].

26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global
pattern (window 512), qk-norm, sandwich norms, head_dim 256, 128k context.
Paper technique applies to the local layers (5/6 of the stack).
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="decoder",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
        d_ff=6912, vocab=262144,
        act="gelu_tanh", glu=True, norm="rmsnorm", post_norm=True,
        qk_norm=True,
        pos="rope", rope_theta=1e6,
        window=512,
        layer_pattern=("local", "local", "local", "local", "local", "global"),
        tie_embeddings=True, emb_scale=True, max_seq=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="decoder",
        n_layers=6, d_model=48, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=96, vocab=256, act="gelu_tanh", glu=True, post_norm=True,
        qk_norm=True, window=8,
        layer_pattern=("local", "local", "local", "local", "local", "global"),
        emb_scale=True, max_seq=128,
    )
