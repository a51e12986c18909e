"""Hymba 1.5B [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
hybrid-head: attention and Mamba heads run in PARALLEL in each block,
outputs summed.  Most layers use SWA (1024); a few are global (approximated
here as every 16th layer, the published model uses first/middle/last).
The paper technique applies twice: SWA windows + the streaming SSM state.
"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001,
        act="silu", glu=True, norm="rmsnorm",
        pos="rope", rope_theta=10000.0,
        window=1024,
        layer_pattern=("global",) + ("local",) * 15,
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, act="silu", glu=True, window=16,
        layer_pattern=("global", "local"),
        ssm_state=8, ssm_conv=4, ssm_expand=2, max_seq=128,
    )
