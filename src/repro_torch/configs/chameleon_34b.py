"""Chameleon 34B [arXiv:2405.09818; unverified tier].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 — early-fusion
mixed-modal: VQ image tokens share the text vocabulary, so the backbone is
a standard dense decoder (qk-norm per the paper).  The VQ tokenizer is the
modality frontend STUB: ``input_specs()`` provides token ids drawn from the
joint vocab.  Paper technique inapplicable (global attention).
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="decoder", modality="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=65536,
        act="silu", glu=True, norm="rmsnorm", qk_norm=True,
        pos="rope", rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family="decoder", modality="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=512, act="silu", glu=True, qk_norm=True,
        tie_embeddings=False, max_seq=128,
    )
