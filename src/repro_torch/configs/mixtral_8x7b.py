"""Mixtral 8x7B [arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts top-2,
sliding-window attention (4096).  All layers are SWA — the paper technique
(shift-buffer windows over the sequence dim) applies to every layer.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="decoder",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        act="silu", glu=True, norm="rmsnorm",
        pos="rope", rope_theta=1e6,
        window=4096, layer_pattern=("local",),
        n_experts=8, top_k=2,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, act="silu", glu=True, window=16,
        layer_pattern=("local",), n_experts=4, top_k=2,
        tie_embeddings=False, max_seq=128,
    )
