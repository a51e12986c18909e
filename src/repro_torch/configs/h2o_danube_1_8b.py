"""H2O-Danube 1.8B [arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 — llama+mistral mix
with sliding-window attention; the paper technique applies (SWA windows).
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="decoder",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab=32000,
        act="silu", glu=True, norm="rmsnorm",
        pos="rope", rope_theta=10000.0,
        window=4096, layer_pattern=("local",),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, act="silu", glu=True, window=16,
        layer_pattern=("local",), max_seq=128,
    )
