"""The dense attention oracle: ``repro.kernels.ref.swa_reference`` in
PyTorch."""

from __future__ import annotations

import math

import torch


def swa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """Dense masked causal sliding-window attention, f32 accumulation.

    q, k, v: (B, S, H, D) with H already GQA-repeated.
    """
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - window)
    logits = torch.where(ok, logits, -1e30)
    wgt = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", wgt, v.float())
    return out.to(q.dtype)
