"""Whisper small [arXiv:2212.04356; unverified tier].

Enc-dec, 12+12L d_model=768 12H d_ff=3072 vocab=51865, conv frontend STUB
(``input_specs()`` provides precomputed frame embeddings, enc_seq=1500),
learned positions, LayerNorm, GELU (non-gated).  ``max_seq`` is raised from
the published 448 to cover the assigned decode shapes (documented deviation).
The conv frontend is a literal 1-D stencil (see DESIGN.md).
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", modality="audio",
        n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865,
        act="gelu", glu=False, norm="layernorm",
        pos="learned", enc_seq=1500,
        tie_embeddings=True, max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec", modality="audio",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, act="gelu", glu=False, norm="layernorm",
        pos="learned", enc_seq=32, max_seq=128,
    )
