"""Public wrapper of the attention kernel.

* :func:`sliding_window_attention` — SWA with GQA handling, the drop-in for
  the torch path in ``models.layers`` on the card: the CUDA kernels for
  CUDA tensors (where a gradient will follow, under autograd: the forward
  kernel, and the backward kernel for q's, k's and v's gradients), its
  plain version for CPU tensors.
* :func:`on_shards` — an attention call on DTensors (sharded training):
  q, k and v redistributed to placements an attention can run on each
  rank's shard alone (batch rows and heads), the call made on the local
  tensors through ``local_map``, the output a DTensor of those placements;
  :func:`on_head_shards` is the same for any computation by batch row and
  head (the mLSTM's chunks).
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


def _head_placements(ndim: int, head_dim: int, batch: bool, heads: bool,
                     rules) -> list:
    """Placements over ``rules.mesh`` of an ``ndim`` tensor whose dim 0 is
    the batch and ``head_dim`` the heads: the batch ``Shard(0)`` over the
    batch axes with ``batch``, the heads ``Shard(head_dim)`` over
    ``rules.tp`` with ``heads``, ``Replicate`` on every other axis."""
    from ..dist.sharding import placements

    axes = rules.batch_axes()
    spec = [None] * ndim
    if batch:
        spec[0] = axes if len(axes) > 1 else axes[0]
    if heads:
        spec[head_dim] = rules.tp
    return list(placements(tuple(spec), rules.mesh))


def on_head_shards(fn, args, head_dims, outs):
    """``fn(*args)`` (per batch row and head: attention, a recurrent
    cell's chunks) on DTensors, inside an ``activation_context``: each
    argument redistributed to :func:`_head_placements` (its dim 0 the
    batch, ``head_dims[i]`` its heads), ``fn`` run on each rank's local
    tensors through ``local_map``, each output (``outs``: its (ndim, head
    dim)) a DTensor of those placements.  The batch is sharded where the
    batch axes divide it, the heads where TP divides every argument's;
    elsewhere the argument is gathered whole over those axes and every
    rank of the group computes the same output.  ``local_map`` checks the
    placements it is given and redistributes nothing itself; the
    gradients come back to the arguments in the placements they arrived
    with (through the redistribution's backward)."""
    from torch.distributed.tensor.experimental import local_map

    from ..dist.sharding import active_rules

    rules = active_rules()
    if rules is None or rules.mesh is None:
        raise ValueError("an operation on DTensors by batch row and head "
                         "runs inside activation_context(rules): the rules "
                         "name the batch and TP axes")
    axes = rules.batch_axes()
    batch = bool(axes) and args[0].shape[0] % rules.axis_size(axes) == 0
    heads = rules.tp is not None and all(
        a.shape[d] % rules.axis_size(rules.tp) == 0
        for a, d in zip(args, head_dims))
    ins = [_head_placements(a.dim(), d, batch, heads, rules)
           for a, d in zip(args, head_dims)]
    args = [a.redistribute(rules.mesh, p) for a, p in zip(args, ins)]
    out = [_head_placements(n, d, batch, heads, rules) for n, d in outs]
    return local_map(fn, out_placements=out[0] if len(out) == 1
                     else tuple(out), in_placements=tuple(map(tuple, ins)),
                     device_mesh=rules.mesh)(*args)


def on_shards(fn, q, k, v):
    """``fn(q, k, v)`` (an attention over plain tensors: the kernel, or a
    plain version) on DTensors q (B, S, H, D) and k, v (B, S', KV, D),
    through :func:`on_head_shards`: the batch over the batch axes where
    they divide B, the heads over TP where it divides both H and KV (each
    rank's query heads then read only its own KV heads), the sequence and
    head dims whole (a query row reads the keys of its window); the
    output a DTensor (B, S, H, D) of those placements.

    The projections hand q, k and v over with their heads over TP where it
    divides them (``layers.flat_ready`` moves TP from a projection's head
    dim, where the rules put it, to its heads); an input that arrives
    otherwise is moved here (``Shard(3)`` to ``Shard(2)`` is an all-to-all,
    an all-gather and a chunk on a CPU mesh, paid again on the gradients).
    Where TP cannot take the heads, q, k and v are gathered whole over
    ``tp``."""
    return on_head_shards(fn, (q, k, v), (2, 2, 2), [(4, 2)])
