"""Carrying the reference's state across to the port.

A stencil has no weights: what a run is made of is its plan and its input
data.  :func:`plan_from_reference` reads a plan the JAX package wrote
(``repro.core.schedule.plan_to_dict``) and :func:`inputs_from_numpy` turns
numpy inputs — the form both packages accept — into tensors on a device.
:func:`lm_params_from_reference` turns the reference LM's parameter tree
into the port's modules, so both packages compute the same model, and
:func:`whisper_params_from_reference` does the same for the
encoder-decoder;
:func:`opt_state_from_reference` does the same for its AdamW state, and
:func:`lm_tree_to_reference` turns the port's per-layer tensors (params,
grads, moments; an LM's or a Whisper's) back into the reference's stacked
tree, so the two can be held against each other leaf by leaf.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import hw
from .core.ir import Program
from .core.lower_kernel import DTYPES
from .core.schedule import DataflowPlan, pick_block, plan_from_dict
from .dist.sharding import STACKS
from .models.transformer import LM
from .models.whisper import Whisper

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


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(v, dtype=np.float32)
    return out


def _unstacked(tree: Mapping) -> dict:
    """{port name: float32 tensor} of a reference tree: the stacked
    ``blocks`` (``enc_blocks``, ``dec_blocks``) leaves split into
    ``blocks.<i>.…``."""
    out = {}
    for name, a in _flatten(tree).items():
        stack, _, rest = name.partition(".")
        if stack in STACKS:
            for i in range(a.shape[0]):
                out[f"{stack}.{i}.{rest}"] = torch.as_tensor(a[i])
        else:
            out[name] = torch.as_tensor(a)
    return out


def lm_params_from_reference(cfg, params: Mapping, device="cuda") -> LM:
    """The port's :class:`~repro_torch.models.transformer.LM` holding the
    reference ``init_lm`` tree ``params`` (numpy arrays; ``"blocks"``
    stacked on a leading layer axis), on ``device``, in
    ``cfg.param_dtype``."""
    lm = LM(cfg, device=torch.device(device))
    lm.load_state_dict(_unstacked(params), strict=True)
    return lm


def whisper_params_from_reference(cfg, params: Mapping,
                                  device="cuda") -> Whisper:
    """The port's :class:`~repro_torch.models.whisper.Whisper` holding the
    reference ``init_whisper`` tree ``params`` (numpy arrays;
    ``"enc_blocks"`` and ``"dec_blocks"`` stacked on a leading layer axis),
    on ``device``, in ``cfg.param_dtype``."""
    model = Whisper(cfg, device=torch.device(device))
    model.load_state_dict(_unstacked(params), strict=True)
    return model


def opt_state_from_reference(cfg, opt_state: Mapping, device="cuda") -> dict:
    """The port's AdamW state (:func:`repro_torch.train.optimizer.
    adamw_init`'s layout, moments keyed by parameter name) holding the
    reference's ``{"mu", "nu", "count"}`` (numpy; blocks stacked), on
    ``device``."""
    dev = torch.device(device)
    names = set(dict(LM(cfg, device="meta").named_parameters()))
    out = {}
    for key in ("mu", "nu"):
        moments = _unstacked(opt_state[key])
        if set(moments) != names:
            raise ValueError(f"{key}: leaves {sorted(set(moments) ^ names)[:5]}"
                             f" do not match {cfg.name}'s parameters")
        out[key] = {k: t.to(dev) for k, t in moments.items()}
    out["count"] = torch.tensor(int(np.asarray(opt_state["count"])),
                                dtype=torch.int32, device=dev)
    return out


def lm_tree_to_reference(cfg, tensors: Mapping) -> dict:
    """The reference's nested tree (numpy float32, ``"blocks"`` — or a
    Whisper's ``"enc_blocks"`` and ``"dec_blocks"`` — stacked on a leading
    layer axis) of per-layer tensors keyed by the port's parameter names:
    params, grads or moments."""
    tree, stacks = {}, {}
    for name, t in tensors.items():
        a = t.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[0] in STACKS:
            stacks.setdefault((parts[0], ".".join(parts[2:])),
                              {})[int(parts[1])] = a
        else:
            _put(tree, parts, a)
    for (stack, rest), layers in stacks.items():
        n = getattr(cfg, STACKS[stack])
        if sorted(layers) != list(range(n)):
            raise ValueError(f"{stack}.*.{rest}: layers {sorted(layers)}, "
                             f"{cfg.name} has {n}")
        _put(tree, [stack, *rest.split(".")],
             np.stack([layers[i] for i in range(n)]))
    return tree


def _put(tree: dict, path: list, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf
