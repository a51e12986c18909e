"""Gemma-2 2B [arXiv:2408.00118; hf:google/gemma-2-2b].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 — alternating
local(4096):global attention, attn logit softcap 50, final softcap 30,
sandwich (post) norms, GeGLU, head_dim 256, scaled embeddings.
Paper technique applies to the local layers.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="decoder",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
        d_ff=9216, vocab=256000,
        act="gelu_tanh", glu=True, norm="rmsnorm", post_norm=True,
        pos="rope", rope_theta=10000.0,
        window=4096, layer_pattern=("local", "global"),
        attn_softcap=50.0, final_softcap=30.0,
        tie_embeddings=True, emb_scale=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="decoder",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, act="gelu_tanh", glu=True, post_norm=True,
        window=16, layer_pattern=("local", "global"),
        attn_softcap=50.0, final_softcap=30.0, emb_scale=True, max_seq=128,
    )
