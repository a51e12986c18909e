"""Grok-1 314B [hf:xai-org/grok-1; unverified tier].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2, global attention with tanh logit softcap 30 (per released config).
Paper technique inapplicable to the attention (global); see DESIGN.md.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="decoder",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072,
        act="gelu", glu=True, norm="rmsnorm",
        pos="rope", rope_theta=10000.0,
        attn_softcap=30.0, final_softcap=30.0,
        n_experts=8, top_k=2,
        tie_embeddings=True, emb_scale=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=256, act="gelu", glu=True, attn_softcap=30.0,
        final_softcap=30.0, n_experts=4, top_k=2, emb_scale=True,
        max_seq=128,
    )
