"""Error-feedback int8 gradient compression (1-bit-Adam/EF-SGD family).

The port of ``repro.train.compress``.  Each gradient is quantised to int8
with a per-tensor scale and dequantised; the quantisation residual is
carried in an error-feedback buffer, so the scheme is unbiased over time.
"Per tensor" is per leaf of the reference's tree, where a block parameter
is one tensor stacked over the layers (``optimizer.stacked_leaf``).
On one device this shows the numerics and the EF invariant; the byte
saving belongs to a data-parallel all-reduce, which the port does not
shard yet (ROADMAP A16).
"""

from __future__ import annotations

from typing import Mapping

import torch

from .optimizer import stacked_leaf


def ef_init(params: Mapping[str, torch.Tensor]) -> dict:
    """A zero float32 error buffer beside each parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantise(g: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Returns (dequantised gradient, new error) for one leaf."""
    g = g.float() + err
    return _quantise(g, torch.clamp(g.abs().max(), min=1e-12) / 127.0)


def ef_compress_grads(grads: Mapping[str, torch.Tensor],
                      err_state: Mapping[str, torch.Tensor]):
    """(dequantised grads, new error buffers), with a scale a leaf of the
    reference's tree: one scale spans a block parameter's layers."""
    total = {k: g.float() + err_state[k] for k, g in grads.items()}
    peak: dict = {}
    for k, t in total.items():
        m = t.abs().max()
        leaf = stacked_leaf(k)
        peak[leaf] = m if leaf not in peak else torch.maximum(peak[leaf], m)
    out = {k: _quantise(t, torch.clamp(peak[stacked_leaf(k)], min=1e-12)
                        / 127.0) for k, t in total.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})
