"""Collectives staged through host memory, for ranks that share one card.

NCCL refuses two ranks on one card, so a sharded run with fewer cards than
ranks (a check of the sharded path on one card: ``chip_smoke.py``, the
card-marked tests) takes the gloo backend on CUDA tensors.  gloo's own
CUDA path crashed (SIGSEGV in ``wait_tensor``) under DTensor's functional
collectives with torch 2.11 on an H100; the same collectives on host
tensors run.  :class:`HostStagedCollectives` is a dispatch mode below
DTensor that issues each collective DTensor makes on a CUDA tensor over a
host copy, waits for it, and copies the result back to the card.  With a
card a rank, NCCL needs none of this.
"""

from __future__ import annotations

import torch

#: the functional collectives DTensor issues, and its all-to-all
STAGED_OPS = frozenset({"all_gather_into_tensor", "reduce_scatter_tensor",
                        "all_reduce", "all_to_all_single", "broadcast",
                        "shard_dim_alltoall"})


class HostStagedCollectives:
    """Enter to stage every collective DTensor issues on a CUDA tensor
    through host memory; ``staged`` counts them."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        self.staged = 0

        class Staged(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                if func._overloadpacket.__name__ in STAGED_OPS:
                    dev = next(a.device for a in args
                               if isinstance(a, torch.Tensor))
                    if dev.type == "cuda":
                        host = [a.cpu() if isinstance(a, torch.Tensor)
                                else a for a in args]
                        out = torch.ops._c10d_functional.wait_tensor(
                            func(*host, **kwargs))
                        outer.staged += 1
                        return out.to(dev)
                return func(*args, **kwargs)

        self.mode = Staged()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
