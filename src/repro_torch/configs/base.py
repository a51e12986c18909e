"""Model configuration schema for every assigned architecture.

One dataclass covers the whole pool: dense / MoE / hybrid(SSM+attn) / pure
recurrent / encoder-decoder.  Per-arch files under ``repro.configs``
instantiate the exact published configs plus a ``smoke()`` reduction of the
same family for CPU tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str = "decoder"          # decoder | encdec | hybrid | xlstm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0                  # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 32000
    act: str = "silu"                # silu | gelu | relu2 | gelu_tanh
    glu: bool = True                 # gated MLP (SwiGLU/GeGLU)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_norm: bool = False          # sandwich norm (gemma2)
    qk_norm: bool = False
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 10000.0
    max_seq: int = 131072

    # attention pattern
    window: int = 0                  # SWA width; 0 = global
    layer_pattern: Sequence[str] = ()  # e.g. ("local","global"); cycled.
    #                                  empty -> all local if window else global
    attn_softcap: float = 0.0        # tanh logit softcap (gemma2/grok)
    final_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0               # mamba d_state (hymba)
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0             # xlstm: every k-th layer is sLSTM

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500              # audio frames after conv stub
    modality: str = "text"           # text | audio | vlm

    # embeddings
    tie_embeddings: bool = True
    emb_scale: bool = False          # gemma: scale embeddings by sqrt(d)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 128    # pad embedding rows so TP divides vocab

    def __post_init__(self):
        if self.d_head == 0:
            self.d_head = self.d_model // self.n_heads
        if not self.layer_pattern:
            self.layer_pattern = ("local",) if self.window else ("global",)

    @property
    def vocab_padded(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab + m - 1) // m) * m

    # ------------------------------------------------------------------
    def layer_kind(self, i: int) -> str:
        """'local' (windowed) or 'global' attention for layer i."""
        return self.layer_pattern[i % len(self.layer_pattern)]

    def num_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, dh = self.n_heads, self.n_kv_heads, self.d_head
        per_layer = 0
        # attention
        per_layer += d * h * dh + 2 * d * kv * dh + h * dh * d
        # mlp
        if self.n_experts:
            e = self.n_experts
            mlp = e * (d * f * (2 if self.glu else 1) + f * d)
            per_layer += mlp + d * e  # + router
        elif f > 0:
            per_layer += d * f * (2 if self.glu else 1) + f * d
        # norms
        per_layer += d * (4 if self.post_norm else 2)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + di * (self.ssm_conv +
                                                     2 * self.ssm_state + 2)
        if self.family == "xlstm":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + 4 * di * dh  # gates etc. approx
        total = self.n_layers * per_layer
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        if self.family == "encdec":
            enc_layer = (d * h * dh + 2 * d * kv * dh + h * dh * d
                         + d * f * (2 if self.glu else 1) + f * d + 2 * d)
            total += self.n_enc_layers * enc_layer
            total += self.n_layers * (d * h * dh + 2 * d * kv * dh
                                      + h * dh * d + d)  # cross-attn
        return total

    def num_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if not self.n_experts:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        e, k = self.n_experts, self.top_k
        expert = d * f * (2 if self.glu else 1) + f * d
        inactive = self.n_layers * (e - k) * expert
        return self.num_params() - inactive

    def model_flops_per_token(self) -> float:
        """6·N_active (training: fwd+bwd) — the §Roofline MODEL_FLOPS basis."""
        return 6.0 * self.num_active_params()


@dataclasses.dataclass
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
