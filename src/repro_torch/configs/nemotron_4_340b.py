"""Nemotron-4 340B [arXiv:2402.16819 family; unverified tier].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 — GQA,
squared-ReLU MLP (no gating), RoPE, untied embeddings.
Paper technique inapplicable (global attention); see DESIGN.md.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="decoder",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_ff=73728, vocab=256000,
        act="relu2", glu=False, norm="layernorm",
        pos="rope", rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab=256, act="relu2", glu=False, norm="layernorm",
        tie_embeddings=False, max_seq=128,
    )
