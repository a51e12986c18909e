"""Public wrapper of the attention kernel.

* :func:`sliding_window_attention` — SWA with GQA handling, the drop-in for
  the torch path in ``models.layers`` on the card: the CUDA kernels for
  CUDA tensors (where a gradient will follow, under autograd: the forward
  kernel, and the backward kernel for q's, k's and v's gradients), its
  plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import swa


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             q_block: int = 128) -> torch.Tensor:
    """q: (B,S,H,D); k, v: (B,S,KV,D).  The kernel reads KV head
    ``h // (H/KV)`` itself; the plain version repeats the KV heads.
    ``q_block`` is the plain version's query tile (the kernel has its
    own)."""
    if q.device.type == "cuda":
        return swa.attention(q, k, v, window=window)
    if q.device.type == "cpu":
        return swa.swa_plain(q, k, v, window=window, q_block=q_block)
    raise ValueError(f"no SWA kernel for device {q.device}")
