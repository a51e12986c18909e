"""Error-feedback int8 gradient compression (1-bit-Adam/EF-SGD family).

The port of ``repro.train.compress``.  Each gradient is quantised to int8
with a per-tensor scale and dequantised; the quantisation residual is
carried in an error-feedback buffer, so the scheme is unbiased over time.
"Per tensor" is per leaf of the reference's tree, where a block parameter
is one tensor stacked over the layers (``optimizer.stacked_leaf``).
Sharded (DTensor gradients), the error buffers are DTensors placed as
their parameters, each gradient is redistributed to them first (the
data-parallel reduction), and a leaf's scale is the max over every shard
of every layer of it, reduced to one replicated value: the numbers are the
unsharded compression's.  As in the reference, what is compressed is the
already-reduced gradient: no collective carries int8, and the byte saving
the scheme is for (a data-parallel all-reduce of int8) is not taken.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..dist.sharding import like_placements, replicated
from .optimizer import stacked_leaf


def ef_init(params: Mapping[str, torch.Tensor]) -> dict:
    """A zero float32 error buffer beside each parameter (placed as it
    is, when it is a DTensor)."""
    return {k: torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
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
    total = {k: like_placements(g, err_state[k]).float() + err_state[k]
             for k, g in grads.items()}
    peak: dict = {}
    for k, t in total.items():
        m = replicated(t.abs().max())
        leaf = stacked_leaf(k)
        peak[leaf] = m if leaf not in peak else torch.maximum(peak[leaf], m)
    out = {k: _quantise(t, torch.clamp(peak[stacked_leaf(k)], min=1e-12)
                        / 127.0) for k, t in total.items()}
    return ({k: o[0] for k, o in out.items()},
            {k: o[1] for k, o in out.items()})
