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
``device="cpu"``; sharded training (``rules=``) waits for sharded
execution, ROADMAP A16 (the rules themselves, and a dry run that traces
the sharded step, are :mod:`repro_torch.dist` and
:mod:`repro_torch.launch`).
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
from ..models.transformer import LM, init_lm, lm_loss
from .compress import ef_compress_grads, ef_init
from .optimizer import OptConfig, adamw_init, adamw_update, cosine_schedule

_SHARDED = ("sharded training (rules=) waits for sharded execution, "
            "ROADMAP A16")


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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, rules=None):
    """Returns fn(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, metrics): ``params`` an :class:`LM` whose masters are updated
    in place, the states as :func:`adamw_init` and :func:`ef_init` make
    them (``ef_state`` unused without ``compress_grads``), ``batch`` int
    tensors ``tokens`` and ``labels`` (B, S) on the parameters' device."""
    if rules is not None:
        raise NotImplementedError(_SHARDED)
    lr_fn = cosine_schedule(tcfg.opt)

    def grads_of(params: LM, tokens, labels):
        named = dict(params.named_parameters())
        loss, metrics = lm_loss(cfg, params, tokens, labels,
                                remat=tcfg.remat)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def step_fn(params: LM, opt_state, ef_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            B = tokens.shape[0]
            tks = tokens.reshape(mb, B // mb, -1)
            lbs = labels.reshape(mb, B // mb, -1)
            grads, loss = None, 0.0
            for i in range(mb):
                l, _, g = grads_of(params, tks[i], lbs[i])
                grads = ({k: v.float() for k, v in g.items()} if grads is None
                         else {k: grads[k] + g[k] for k in grads})
                loss = loss + l
            grads = {k: g / mb for k, g in grads.items()}
            loss = loss / mb
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, tokens, labels)
        if tcfg.opt.compress_grads:
            grads, ef_state = ef_compress_grads(grads, ef_state)
        _, opt_state, om = adamw_update(tcfg.opt,
                                        dict(params.named_parameters()),
                                        grads, opt_state, lr_fn)
        return params, opt_state, ef_state, {"loss": loss, **om, **metrics}

    return step_fn


class Trainer:
    """Trains ``cfg`` on ``data`` (a step-addressable source) from
    ``init_lm`` with ``tcfg.seed``, resuming from the newest checkpoint in
    ``tcfg.ckpt_dir``.  ``state["params"]`` is the :class:`LM` (what a
    ``ServeEngine`` serves), ``state["opt"]`` and ``state["ef"]`` the
    optimizer and error-feedback states."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data,
                 rules=None, fail_at_step: Optional[int] = None,
                 device=None):
        if rules is not None:
            raise NotImplementedError(_SHARDED)
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        self.fail_at_step = fail_at_step
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_fn = make_train_step(cfg, tcfg)
        self.straggler_events = 0
        self.history: list = []

        gen = torch.Generator(self.device).manual_seed(tcfg.seed)
        model = init_lm(cfg, gen, self.device).requires_grad_(True)
        named = dict(model.named_parameters())
        ef_state = (ef_init(named) if tcfg.opt.compress_grads
                    else torch.zeros((), device=self.device))
        self.state = {"params": model, "opt": adamw_init(named),
                      "ef": ef_state}
        self.step = 0

        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            tree, extra, self.step = restore_checkpoint(
                tcfg.ckpt_dir, last, self._tree())
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
            t0 = time.perf_counter()
            (self.state["params"], self.state["opt"], self.state["ef"],
             metrics) = self.step_fn(self.state["params"], self.state["opt"],
                                     self.state["ef"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if self.tcfg.step_deadline_s and dt > self.tcfg.step_deadline_s \
                    and step > self.step:  # the first step builds kernels
                self.straggler_events += 1
            self.history.append({"step": step, "time_s": dt, **metrics})
            if step % self.tcfg.log_every == 0:
                print(f"step {step:6d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms",
                      flush=True)
            nxt = step + 1
            if nxt % self.tcfg.ckpt_every == 0:
                self.ckpt.save(nxt, self._tree(), {"next_step": nxt})
        self.step = self.step + steps
        return self.history
