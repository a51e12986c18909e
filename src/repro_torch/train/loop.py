"""Training loop: the train step with gradient accumulation and remat, and
the fault-tolerant driver (resume, async checkpoints, straggler deadline).

The port of ``repro.train.loop``.  ``make_train_step`` builds the update;
``Trainer`` owns the fault-tolerance envelope:

* resume-from-latest on construction (restartability after node failure)
* async checkpoint every ``ckpt_every`` steps, atomic publish
* step-addressable data (no loader state to persist)
* straggler mitigation hook: a per-step wall-clock deadline; steps that
  exceed it are logged and counted (the first step of a run is not: it
  builds the kernels, as the reference's first step compiles)
* simulated-failure injection for tests (``fail_at_step``)

PyTorch runs the step eagerly: gradients by ``torch.autograd.grad`` (on
the card the SWA layers run the forward and backward CUDA kernels,
``kernels.swa``), accumulation over microbatches a Python loop where the
reference has a ``lax.scan``, and the AdamW update written in place where
the reference donates its buffers.  The parameters are an
:class:`~repro_torch.models.transformer.LM` on the card unless
``device="cpu"``.

Sharded (``rules=``, :class:`~repro_torch.dist.ShardingRules` over a
``DeviceMesh``): DTensor is SPMD, so each rank is a process, which the
caller starts (``torchrun``, or ``torch.multiprocessing``) with its process
group open and the mesh built before it makes the ``Trainer``; the mesh's
device type decides the device.  Every rank runs ``init_lm`` from
``tcfg.seed`` and keeps its slice of each parameter
(``dist.sharding.place_params``); the moments and error buffers are made
beside the placed parameters, and each batch is placed by
``batch_sharding`` (each rank keeps its rows of ``data.batch_at(step)``,
the same on every rank).  The step runs under ``activation_context(rules)``
and DTensor's ``implicit_replication``; DTensor issues the collectives the
reference's XLA inserts, and the numbers are the unsharded step's up to
the order of its reductions.  Microbatches take rows of each rank's batch
shard where the reference takes global rows: the gradient is the mean of
the same per-row terms (one model's MoE aux loss, which depends on which
rows share a microbatch, aside).  Metrics are floats equal on every rank;
only rank 0 prints and writes checkpoints (``checkpoint.AsyncCheckpointer``
gathers each DTensor on every rank).  The dry run (``launch.specs``)
builds its sharded step from the same :func:`train_step`.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs.base import ModelConfig
from ..core.pipeline import resolve_device
from ..dist.sharding import (activation_context, check_world,
                             named_shardings, place_batch, place_params,
                             plain_replicated, rules_device)
from ..models.transformer import LM, init_lm, lm_loss
from .compress import ef_compress_grads, ef_init
from .optimizer import OptConfig, adamw_init, adamw_update, cosine_schedule


@dataclasses.dataclass
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    microbatches: int = 1            # gradient accumulation factor
    remat: bool = False
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    step_deadline_s: float = 0.0     # 0 = no straggler deadline
    seed: int = 0


def _rows(x, i: int, mb: int):
    """Microbatch ``i`` of ``mb``: rows ``[i n, (i + 1) n)`` of the batch,
    of each rank's shard for a DTensor (no communication)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        local = x.to_local()
        n = local.shape[0] // mb
        return DTensor.from_local(local[i * n:(i + 1) * n], x.device_mesh,
                                  x.placements, run_check=False)
    n = x.shape[0] // mb
    return x[i * n:(i + 1) * n]


def train_step(loss_fn, tcfg: TrainConfig, rules=None):
    """The train step of ``loss_fn(params, batch) -> (loss, metrics)``:
    fn(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, metrics), gradients accumulated over ``tcfg.microbatches``,
    compressed with ``tcfg.opt.compress_grads``, then one AdamW update in
    place.  Under ``rules`` it runs inside ``activation_context(rules)``
    and ``implicit_replication``; the metrics may be DTensors."""
    lr_fn = cosine_schedule(tcfg.opt)

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def step_fn(params, opt_state, ef_state, batch):
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            grads, loss = None, 0.0
            for i in range(mb):
                l, _, g = grads_of(params, {k: _rows(v, i, mb)
                                            for k, v in batch.items()})
                grads = ({k: v.float() for k, v in g.items()} if grads is None
                         else {k: grads[k] + g[k] for k in grads})
                loss = loss + l
            grads = {k: g / mb for k, g in grads.items()}
            loss = loss / mb
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if tcfg.opt.compress_grads:
            grads, ef_state = ef_compress_grads(grads, ef_state)
        _, opt_state, om = adamw_update(tcfg.opt,
                                        dict(params.named_parameters()),
                                        grads, opt_state, lr_fn)
        return params, opt_state, ef_state, {"loss": loss, **om, **metrics}

    if rules is None:
        return step_fn

    def sharded(*args):
        with activation_context(rules), plain_replicated():
            return step_fn(*args)
    return sharded


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, rules=None):
    """Returns fn(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, metrics): ``params`` an :class:`LM` whose masters are updated
    in place, the states as :func:`adamw_init` and :func:`ef_init` make
    them (``ef_state`` unused without ``compress_grads``), ``batch`` int
    tensors ``tokens`` and ``labels`` (B, S) on the parameters' device.
    Under ``rules`` the parameters, states and batch are DTensors over
    ``rules.mesh`` (:class:`Trainer` places them), whose size must be the
    world's."""
    if rules is not None:
        check_world(rules.mesh)

    def loss_fn(params: LM, batch):
        return lm_loss(cfg, params, batch["tokens"], batch["labels"],
                       remat=tcfg.remat)
    return train_step(loss_fn, tcfg, rules)


def _scalar(v) -> float:
    """A metric as a float, the same on every rank (a DTensor reduced)."""
    from torch.distributed.tensor import DTensor

    return float(v.full_tensor() if isinstance(v, DTensor) else v)


class Trainer:
    """Trains ``cfg`` on ``data`` (a step-addressable source) from
    ``init_lm`` with ``tcfg.seed``, resuming from the newest checkpoint in
    ``tcfg.ckpt_dir``.  ``state["params"]`` is the :class:`LM` (what a
    ``ServeEngine`` serves), ``state["opt"]`` and ``state["ef"]`` the
    optimizer and error-feedback states.  Under ``rules`` (see the module
    docstring) every rank makes one, its parameters, moments and error
    buffers DTensors over ``rules.mesh``; a ``device`` that disagrees with
    the mesh's device type raises, as does a mesh that is not the
    world."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data,
                 rules=None, fail_at_step: Optional[int] = None,
                 device=None):
        if rules is not None:
            self.device = rules_device(rules, device)
            self.rank = torch.distributed.get_rank()
        else:
            self.device = resolve_device(device)
            self.rank = 0
        self.cfg, self.tcfg, self.data, self.rules = cfg, tcfg, data, rules
        self.fail_at_step = fail_at_step
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_fn = make_train_step(cfg, tcfg, rules)
        self.straggler_events = 0
        self.history: list = []

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        model = init_lm(cfg, gen, self.device).requires_grad_(True)
        if rules is not None:
            model = place_params(cfg, model, rules)
        named = dict(model.named_parameters())
        ef_state = (ef_init(named) if tcfg.opt.compress_grads
                    else torch.zeros((), device=self.device))
        self.state = {"params": model, "opt": adamw_init(named),
                      "ef": ef_state}
        self.step = 0

        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            shardings = None
            if rules is not None:
                # the reference restores opt and ef whole and lets jit
                # place them; here they are placed as their parameters
                ps = named_shardings(cfg, model, rules)
                shardings = {"params": ps,
                             "opt": {"mu": ps, "nu": ps, "count": None},
                             "ef": ps if tcfg.opt.compress_grads else None}
            tree, extra, self.step = restore_checkpoint(
                tcfg.ckpt_dir, last, self._tree(), shardings)
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(tree["params"][k])
            self.state["opt"], self.state["ef"] = tree["opt"], tree["ef"]
            self.step = int(extra.get("next_step", self.step))

    def _tree(self) -> dict:
        """What a checkpoint holds: the masters by name and the states."""
        return {"params": dict(self.state["params"].named_parameters()),
                "opt": self.state["opt"], "ef": self.state["ef"]}

    def run(self, steps: int):
        try:
            return self._run(steps)
        finally:
            # join the async writer even when a step raises: a checkpoint
            # whose write began before the failure must be durable for the
            # restarted job to resume from it.
            self.ckpt.wait()

    def _run(self, steps: int):
        for step in range(self.step, self.step + steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = {k: torch.as_tensor(v, device=self.device).long()
                     for k, v in self.data.batch_at(step).items()}
            if self.rules is not None:
                batch = place_batch(batch, self.rules)
            t0 = time.perf_counter()
            (self.state["params"], self.state["opt"], self.state["ef"],
             metrics) = self.step_fn(self.state["params"], self.state["opt"],
                                     self.state["ef"], batch)
            metrics = {k: _scalar(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if self.tcfg.step_deadline_s and dt > self.tcfg.step_deadline_s \
                    and step > self.step:  # the first step builds kernels
                self.straggler_events += 1
            self.history.append({"step": step, "time_s": dt, **metrics})
            if step % self.tcfg.log_every == 0 and self.rank == 0:
                print(f"step {step:6d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms",
                      flush=True)
            nxt = step + 1
            if nxt % self.tcfg.ckpt_every == 0:
                self.ckpt.save(nxt, self._tree(), {"next_step": nxt})
        self.step = self.step + steps
        return self.history
