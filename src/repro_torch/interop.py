"""Carrying the reference's state across to the port.

A stencil has no weights: what a run is made of is its plan and its input
data.  :func:`plan_from_reference` reads a plan the JAX package wrote
(``repro.core.schedule.plan_to_dict``) and :func:`inputs_from_numpy` turns
numpy inputs — the form both packages accept — into tensors on a device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import hw
from .core.ir import Program
from .core.lower_kernel import DTYPES
from .core.schedule import DataflowPlan, pick_block, plan_from_dict

#: the reference's backend names and their counterparts here
BACKENDS = {"pallas": "cuda", "jnp_fused": "torch_fused",
            "jnp_naive": "torch_naive"}


def plan_from_reference(plan_dict: Mapping, p: Program | None = None,
                        grid=None,
                        smem_budget: int = hw.H100.smem_per_block
                        ) -> DataflowPlan:
    """The port's plan for a reference ``plan_to_dict`` record.

    Fuse groups, dtype and schedule carry over as they are; the backend
    name maps to its counterpart.  The reference sized its tile for a TPU's
    VMEM; given the program and grid, the port's planner picks the tile for
    the plan's groups (:func:`~repro_torch.core.schedule.pick_block`).
    """
    plan = plan_from_dict(dict(plan_dict))
    plan.backend = BACKENDS.get(plan.backend, plan.backend)
    plan.interpret = False
    if p is not None and grid is not None and plan.schedule == "block":
        plan.block = pick_block(p, plan.groups, grid, plan.dtype,
                                smem_budget)
    return plan


def inputs_from_numpy(fields: Mapping, scalars: Mapping | None = None,
                      coeffs: Mapping | None = None, device="cuda",
                      dtype: str = "float32"):
    """``(fields, scalars, coeffs)`` as tensors on ``device``: fields and
    coefficients in ``dtype``, scalars as 0-d float32 tensors."""
    tdt = DTYPES[dtype]
    dev = torch.device(device)
    f = {k: torch.as_tensor(np.asarray(v), device=dev).to(tdt)
         for k, v in fields.items()}
    s = {k: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                         device=dev)
         for k, v in (scalars or {}).items()}
    c = {k: torch.as_tensor(np.asarray(v), device=dev).to(tdt)
         for k, v in (coeffs or {}).items()}
    return f, s, c
