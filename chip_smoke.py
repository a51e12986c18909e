#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path — ``repro_torch.compile_program`` on the
paper's two apps, through the entry points a user calls — at the paper's
sizes, under both schedules:

Block schedule (generated CUDA fuse-group kernels):

1. ``pw_advection`` at 512x256x256 (32M points), float32, zero and
   periodic boundaries: a single step and a fused ``steps=10`` loop with
   ``pw_advection_update(0.1)``;
2. ``tracer_advection`` at 256x256x128 (8M points), zero boundary: a single
   step and a fused ``steps=4`` loop;
3. ``pw_advection`` in bfloat16 at 256x256x128, a single step.

Stream schedule (``schedule="stream"``, generated CUDA sweep kernels):

4. ``pw_advection`` at 512x256x256, float32: zero and periodic single
   steps; zero fused ``steps=10`` at ``time_tile`` 1, 2 and 4 (4 runs two
   chained sweeps and a remainder chain of 2); periodic fused ``steps=10``
   at ``time_tile=2``, which legalisation demotes to 1 with a warning; a
   zero single step at ``plane_tile=2``;
5. ``tracer_advection`` at 256x256x128: zero single step (four regions),
   zero fused ``steps=4``, periodic single step (eight regions);
6. ``pw_advection`` in bfloat16 at 256x256x128, a zero single step.

Stencil serving (``repro_torch.serve.StencilEngine``, after the tuner
phase): requests of 8M points, from ``--seed``, served in batches of 4
(each generated kernel launches once a step for the batch): pw fused x10
(16 requests to the 256x256x128 bucket, 8 to 192x192x96), pw periodic
fused x10 (4), tracer single steps (8), and a stream engine asked for
time_tile 2 (4 pw requests; the chain demotes to 1).  A warm pass must
compile no executor and build no kernel; every answer is held against its
exact grid's ``compile_program``; on each bucket a batch of up to 4
against batches of 1 (bit-equal, as many launches) and its batched kernel
against its batched plain version, timed; requests a second and p50/p99
for each phase, and pw fused with ``max_batch`` 1 in turns.

Distribution (``compile_program(..., mesh=, mesh_axes=)``, after the
serving phase): every shard of a mesh on ``cuda:0``, so both generated
kernels run at non-zero shard origins on shard-local grids and every halo
exchange runs on the one card (it measures the cost of sharding and of the
device-local exchange, not NVLink).  pw 32M on a (2,2) mesh: a zero single
step, periodic fused x10, and the stream schedule with the stream axis
sharded at time_tile 2 (fused x10); tracer 8M on (2,2,2) fused x4 and
periodic stream single step on (2,2); pw bf16 8M single step on (2,2);
pw 32M on a (1,1,1) mesh, single step and fused x10, bit-equal to the
local compile; ``strategy="tuned"`` under the (2,2) mesh (pw 32M fused
x10, ``max_measured`` 4, each measured candidate against ``torch_fused``,
the second compile a cache hit); and ``StencilEngine(mesh=(2,2))`` on 4
pw fused x10 requests of the 256x256x128 bucket, each answer against its
exact grid's local compile.  Each row is held against the local compile
on the card, logs the sharded and local step in turns, the exchange ms
and bytes a step and the launches a step (shards x kernels), and its
first kernel at a non-zero origin against its plain version.

LM serving (the hand-written CUDA sliding-window attention kernels:
``swa_mma.cu`` on the tensor cores for bfloat16, ``swa.cu`` for float32):

7. H2O-Danube-1.8B at full width and depth (24 layers, d 2560, 32 heads
   over 8 KV heads, head dim 80, window 4096, bfloat16), random weights
   from ``--seed``: ``ServeEngine.generate`` on two prompts of 8192 tokens,
   16 greedy new tokens.  The prefill launches the bf16 kernel once a
   layer (24), the decode steps never.  Layer 0's q, k and v are captured
   and the kernel held against ``swa_plain`` on them (bf16 at 2e-2, and
   the float32 kernel on the same values cast up at 2e-5); at a depth of 4
   layers the last-position logits of an 8192-token prefill (the kernel)
   are held against a 7936-token prefill and 256 teacher-forced decode
   steps (the ring cache, no kernel) at 2e-2; the kernels are also held
   against ``swa_plain`` at head dims 40/64/80/128/256 with GQA, ragged
   last tiles and a window >= S in both dtypes.
   ``torch.nn.functional.scaled_dot_product_attention`` with the band mask
   is timed on the same inputs as the library yardstick, in turns with the
   kernel (kernel, SDPA, kernel, SDPA, ...), in both dtypes.  The float32
   kernel is off the serving path; its row (0 launches on the path) keeps
   its time.

LM serving of the MoE, hybrid and xLSTM families (the last phase, after
training; the same bf16 kernel on new shapes), each at full width through
``ServeEngine.generate`` on two prompts from ``--seed``, 16 greedy new
tokens:

7b. mixtral-8x7B cut to 8 of its 32 layers (d 4096, 8 experts top-2, 32
   heads over 8 KV heads, head dim 128, window 4096; prompts of 8192: the
   kernel on every layer, 8 a prefill), hymba-1.5B cut to 4 of its 32
   layers (d 1600, 25 heads over 5 KV heads, head dim 64, window 1024,
   the Mamba head beside attention; prompts of 8192: the kernel on its 3
   local layers) and xlstm-350M whole (24 layers, d 1024; prompts of
   4096; its three sLSTM layers step token by token, as the reference's
   do).  Each
   logs its prefill and decode ms, peak memory, the profiler's device ms
   by class (SWA, matrix products, scan and recurrence, MoE dispatch,
   elementwise: ``record_function`` ranges around each module) and idle
   share of one prefill (xlstm's of 512 tokens), and mixtral the assignments each layer drops at capacity factor
   1.25.  Checks: the bf16 kernel on the inputs the first local layer
   hands it against ``swa_plain`` (hymba D 64 at a GQA group of 5,
   mixtral D 128), timed in turns with SDPA with the band mask; mixtral's
   ``moe_apply`` on layer 0's input against a plain loop over the experts
   with the same choices and drops; each recurrent cell on 512 tokens of
   its layer's input against its CPU float32 result, and its decode form
   against one call; and at depth 2 prefill against prefill plus 256
   decode steps (mixtral at capacity factor 8).

LM training (after the serving phase; the backward kernels under
``kernels.swa.SlidingWindowAttention``: ``swa_bwd_mma.cu`` on the tensor
cores for bfloat16, fed the log-sum-exp the forward stores, and
``swa_bwd.cu`` for float32):

8. the backward against ``swa_plain_backward`` on layer 0's shapes (B 1, S
   8192, H 32, KV 8, D 80, w 4096; bf16 at 2e-2, float32 at 1e-4 of each
   gradient's max abs; the forward's lse against ``swa_plain_lse`` at 1e-4
   relative; no ptxas spill in either bf16 kernel at D 80, nor at the
   families' D 128 and D 64), timed in turns
   with autograd through SDPA with the band mask, and each bf16 kernel's
   device time (dq, then dk/dv) under ``torch.profiler`` in a process of
   its own (``--backward-parts``); H2O-Danube-1.8B
   at full width and depth trained by ``repro_torch.train.Trainer`` for
   three steps on one 8192-token sequence of ``SyntheticLM(seed=--seed)``,
   remat on, checkpoints off: each step's loss, grad norm, CUDA-event time,
   tokens/s and SWA launches (48 forward, 24 backward, counted from 0
   around each step), peak memory, the last step under ``torch.profiler``;
   the smoke config's loss and gradients on the card (the kernels) against
   the CPU path in float32; and a smoke trainer that fails at step 5,
   resumes from its step-4 checkpoint and must match an uninterrupted run.

Sharded LM training (after the train phase; ``Trainer(rules=)`` over a
``DeviceMesh``, one process a rank, this script run with
``--sharded-rank``):

8b. H2O-Danube-1.8B at full width cut to 2 of its 24 layers (4 took the
   script past its time), two sequences of 8192 tokens from
   ``SyntheticLM(seed=--seed)`` a step (one a data rank), remat, bf16 over
   float32 masters, trained three steps by
   4 ranks of a (2, 2) ``("data", "model")`` mesh under the dry run's
   train rules (TP over ``model``, FSDP and the batch over ``data``): NCCL
   with a card a rank, else every rank on ``cuda:0`` with gloo, each
   collective staged through host memory
   (``repro_torch.dist.host_staged``); the backend and card count are
   logged.  Each step's loss and grad norm, and the gathered parameters
   after the last, are held against a single-process ``Trainer`` on the
   same card from the same parameters and batches (2e-2), the steps timed
   in turns with its steps; every rank must launch the bf16 SWA forward
   twice and the backward once a layer a step on its shard; the smoke
   config in float32 sharded against unsharded (1e-4); rank 0's first
   local SWA call (forward and backward) against its plain version
   (2e-2), timed in turns with SDPA; each step's collectives by op and
   mesh axis (a dispatch mode below DTensor, as the dry run counts them)
   and each rank's peak memory are logged (``"sharded_train"`` in the
   JSON).

LM training of the families (the last phase, after their serving; the
same bf16 kernels forward and backward, at D 128 and D 64):

7c. mixtral-8x7B cut to 2 of 32 layers (one 8192-token sequence a step:
   both layers past the window of 4096), hymba-1.5B cut to 2 of 32 (layer
   0 global, layer 1 local; 8192 tokens) and xlstm-350M cut to 8 of 24
   (its first sLSTM layer the last; 1024 tokens), each at full width
   trained by ``repro_torch.train.Trainer`` for three steps from
   ``--seed`` (remat,
   bf16 over float32 masters, checkpoints off): each step's loss, grad
   norm, CUDA-event time, tokens/s against the step's bound and SWA
   launches (two forward and one backward a local layer, counted from 0
   around each step), peak memory, and one step under ``torch.profiler``
   by the families phase's classes (xlstm's at 512 tokens).  Checks:
   losses and grad norms finite; the bf16 forward with lse and the
   backward on the inputs the first local layer's backward was handed in
   the first step, against ``swa_plain``, ``swa_plain_lse`` (1e-4) and
   ``swa_plain_backward`` (2e-2), timed in turns with SDPA (autograd
   through it for the backward); the smoke config's ``make_train_step``
   step in float32 on the card against the CPU from non-zero moments
   (1e-4).  Then whisper-small at full width and depth: ``whisper_loss``
   (remat) on 8 utterances of 1500 frames and 448 decoder tokens, every
   gradient, one ``adamw_update`` a step, three steps (the last
   profiled), and at depth 2 + 2 the card's bf16 loss and gradients
   against the CPU's float32 ones at 2e-2 (``"family_train"`` in the
   JSON).

Whisper serving (after training, before the families; no hand-written
kernel on its path: its attention is the reference's plain attention):

9. whisper-small at full width and depth (12 + 12 layers, d 768, 12
   heads, vocab 51865 padded to 51968), float32 masters from ``--seed``
   served as one bf16 copy: 8 utterances of 1500 precomputed frames (30 s
   each, numpy from ``--seed``), a 4-token prompt, then 64 greedy tokens
   through ``whisper_prefill`` and ``whisper_decode_step`` in a decoder
   context of 448.  Logs encode, prefill and decode ms, tokens/s, peak
   memory, and one decode step under ``torch.profiler`` (device ms, idle
   share).  Checks: no greedy id at or past the vocabulary (the padded
   columns are masked); the decode's logits against ``whisper_forward``
   on the same tokens (teacher-forced) at 2e-2; at depth 2 + 2, full
   width, the card's bf16 logits against the CPU's float32 ones at 2e-2.

Each block path's kernel row also keeps its CTA (chunk, tile, threads,
shared memory, CTAs an SM, levels), what ptxas reported for it (registers,
spill bytes), its generated operations and staged bytes a grid point, and
the SHA-256 of its generated source.  Each stream path's row keeps, for
every region's sweep kernel, its CTA (tile, threads, chunk, warm-up, CTAs,
shared memory, CTAs an SM planned), the planes it keeps in flight, the
barriers it passes a plane, its staged bytes a grid point and what ptxas
reported for it, and the SHA-256 of the path's generated source; a
spill in any sweep kernel fails the run.  Every stencil row's bound comes
from ``repro_torch.analysis.stencil_roofline`` (each input read once,
each output written once, priced at the H100's data-sheet rates), and
every path row also keeps the plan model's time a step (``modeled_ms``,
``model_plan``) and its ``roofline_fraction`` (modeled over the measured
step, ``obs.fraction_for``).

Tuner phase (``repro_torch.core.tune``, after the stencil paths): the
measured plan search at full size, each with a plan cache in a fresh
temporary file, ``max_measured`` 8, best of 3: ``pw_advection`` 512x256x256
float32, zero boundary, fused ``steps=10`` with its update (loop mode),
and ``tracer_advection`` 256x256x128, single step.  Each logs every
measured candidate (label, modeled and measured µs, roofline fraction),
the winner against the ``auto_plan`` seed (the winner may not be slower)
and the tune's seconds with ``nvcc``'s share; runs every measured
candidate's executables again on seeded inputs against ``torch_fused``
(1e-5 single step, 1e-4 fused); compiles again with
``strategy="tuned"`` through the same file (a cache hit with no timed
run); and times the tuned and ``auto_plan`` executables in turns.

Before anything else the card's properties are logged beside the
``hw.H100`` constants the planner uses; fewer SMs or less shared memory a
CTA may opt into than the planner assumes fail the run.

Every stencil path is compared with the same compile on
``backend="torch_fused"`` on the card, and each stream path with the block
path of the same program, boundary, grid and steps where there is one. Each
block path's first group kernel, and every sweep kernel of a stream path (a
chain's remainder included) on the inputs the path gives it, is held
against its plain PyTorch version; small grids are compared with the CPU
oracle, and a program whose one group reads no field or coefficient (``o0 =
s0`` on 6x8x32) must give 768 under every schedule.  Every tolerance is
relative to each output's own max abs: 1e-5 for a float32 single step, 1e-4
for fused loops, and 2e-2 (a few bfloat16 ulps) for bfloat16.  Every launch
count is zeroed just before each path and read just after.  Kernel and
end-to-end times come from CUDA events (warm-up, then the median of 5; the
LM prefill and decode the median of 3); a stencil kernel's time is that of
20 launches made while the card sleeps, so that they run back to back and
the host's time to launch them does not count; a stream path's kernel,
plain-version and bound times are per time step (a chained sweep's divided
by its depth), and its plain version is timed in the one run that checks
it.  One prefill and one decode step also run under ``torch.profiler`` for
their device time, idle share and kernel launches, beside the SWA kernels
launched and the SWA kernel records the profile holds.

Regions whose rings a coefficient alone feeds (the mesh phase): ``t =
cf0<0>; o3 = t[-1,0,0]`` and ``o2 = square(cf0<-1>); o3 =
square(o2[-2,2,-1])`` at 256x64x128 over (2,) and (4,) meshes on
``cuda:0`` that cut the stream axis, a single step and a fused loop of 3,
each held against the local stream compile (1e-4, 1e-5), one sweep a
shard a step.  A group that reads nothing, served (the serve phase):
``o0 = s0`` at 64x64x128, three requests in one batch, under the block
and the stream schedule, each answer bit-equal to its compile.

The port's examples (``examples_torch/``), last: ``quickstart`` (the
block kernel), ``stream_schedule`` (the sweep kernel), ``trace_compile``
(both) and ``serve_lm --arch gemma3_1b`` (whose 8-token window reaches
the SWA kernel) run at their default sizes, one after another in this
process; each must end with its closing line and launch the kernels it
reaches.  The other six run in ``tests/test_torch_examples.py`` only.

Usage, from the root of a checkout (the kernels build with nvcc into
``build/repro_torch_kernels/`` on first use):

    python3 chip_smoke.py [--seed 0]

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches, error and times.  Everything measured is
also written to ``--out`` (``build/chip_smoke.json`` by default).  Any
failure exits non-zero without a result line.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PW_GRID = (512, 256, 256)
TRACER_GRID = (256, 256, 128)
BF16_GRID = (256, 256, 128)
SMALL_GRID = (20, 18, 100)
NOTHING_GRID = (6, 8, 32)
PW_STEPS, TRACER_STEPS = 10, 4

# the serving phase's request grids, drawn per axis from these inclusive
# ranges; with a program's reach added each set rounds to one bucket
# (hw.BUCKET_LANE 32): pw (reach 1 a side) to 256x256x128, the paper's 8M
# grid, and to 192x192x96; tracer (reach 4) to 256x256x128 (from 217: 216
# + 8 would round to 224)
SERVE_PW_BIG = ((224, 254), (224, 254), (100, 126))
SERVE_PW_SMALL = ((160, 190), (160, 190), (64, 94))
SERVE_TRACER = ((217, 248), (217, 248), (96, 120))
SERVE_BATCH, SERVE_WINDOW_S, SERVE_STEPS = 4, 0.005, 10
# the mesh phase: shards stacked on cuda:0 over these meshes; the serve
# row's requests round to the 256x256x128 bucket
MESH_22 = ((2, 2), ("X", "Y"), ("X", "Y", None))
MESH_222 = ((2, 2, 2), ("X", "Y", "Z"), ("X", "Y", "Z"))
MESH_111 = ((1, 1, 1), ("X", "Y", "Z"), ("X", "Y", "Z"))
MESH_TUNE_MEASURED = 4
# the mesh phase's rings fed by a coefficient alone, over meshes that cut
# the stream axis into 2 and 4 shards on cuda:0
RING_GRID, RING_MESHES, RING_STEPS = (256, 64, 128), (2, 4), 3
# the serve phase's group that reads nothing (o0 = s0): three requests,
# served in one batch
NOTHING_SERVE_GRID, NOTHING_SERVE_WINDOW_S = (64, 64, 128), 0.05

LM_ARCH = "h2o_danube_1_8b"
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8192, 16
LM_E2E_DEPTH, LM_E2E_SPLIT = 4, 7936     # prefill 7936, decode 256
SWA_HEAD_DIMS = (40, 64, 80, 128, 256)
#: the bf16 SWA libraries the LMs serve (hymba, Danube, mixtral): a ptxas
#: spill fails the run, but at D 128, the q fragments' limit, where it is
#: recorded in the row
SERVED_HEAD_DIMS = (64, 80, 128)
# the families phase: (arch, depth (None: the config's), prompt tokens,
# the prefill-vs-decode check's prompt, the profiled prefill's prompt),
# served at full width (hymba cut to 4 of its 32 layers, layer 0 global,
# for the family training phase's time: its 2 x 8192 prefill takes ~2 s
# and launches ~62,000 kernels at full depth; xlstm's prefill profiled at
# 512 tokens: its sLSTM loop launches
# ~70 kernels a token, linear in the prompt, and a profile of 4096 tokens
# holds ~1M events); then, at
# depth 2, prefill against prefill + FAMILY_E2E_TAIL decode steps (mixtral
# at capacity factor 8, so that the prefill drops nothing that decode
# keeps; hymba at 2048 tokens: its global layers' blockwise attention
# takes multiples of its 2048-key chunk, as the reference's does), and
# each recurrent cell on FAMILY_MODULE_SEQ tokens in one call and in
# FAMILY_STEPS more, one at a time
FAMILY_RUNS = (("mixtral_8x7b", 8, 8192, 8192, 8192),
               ("hymba_1_5b", 4, 8192, 2048, 8192),
               ("xlstm_350m", None, 4096, 4096, 512))
FAMILY_E2E_DEPTH, FAMILY_E2E_TAIL, FAMILY_E2E_CF = 2, 256, 8.0
FAMILY_MODULE_SEQ, FAMILY_STEPS = 512, 16
#: profiler ranges of the families phase and the class of the kernels
#: (other than the SWA kernel and matrix products) launched inside them
FAMILY_RANGES = {"moe": "moe_dispatch", "mamba": "scan", "mlstm": "scan",
                 "slstm": "scan"}
# the Whisper phase: whisper-small at full width and depth, a batch of 30 s
# utterances (1500 frames each), a short prompt and greedy tokens in the
# published decoder context of 448; the card-vs-CPU check at depth 2 + 2
# on WHISPER_CHECK_BATCH of the utterances
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW, WHISPER_MAX_LEN = 8, 4, 64, 448
WHISPER_CHECK_DEPTH, WHISPER_CHECK_BATCH = 2, 2
# the training phase: full-width Danube on one 8192-token sequence (every
# layer past its window), three steps under remat; the smoke config (head
# dim 16) for the card-vs-CPU gradients and the resumed trainer
TRAIN_SEQ, TRAIN_STEPS = 8192, 3
TRAIN_SMOKE_SEQ, TRAIN_SMOKE_STEPS, TRAIN_FAIL_AT = 64, 8, 5
TRAIN_HEAD_DIMS = (80, 16)
# the family training phase: (arch, depth (None: the config's), tokens of
# the one sequence a step, tokens of the profiled step), full width, each
# trained FAMILY_TRAIN_STEPS steps by the Trainer (remat); then
# whisper-small's loss and gradients at full width and depth.  Cut to fit
# the script's time (PERF.md, section 4): mixtral to 2 of 32 layers (one
# layer holds 1.45e9 parameters: masters, moments and gradients of 2 and
# the 8192-token activations fill the card); hymba to 2 of 32 (layer 0
# global, layer 1 local: its Mamba scan under autograd launches ~19,000
# kernels a layer a step, 0.5-0.9 s a layer); xlstm to 8 of 24 (layer 7
# its first sLSTM) and 1024 tokens (its sLSTM loop launches ~110 kernels
# a token a step), its profiled step at 512 tokens, as its serving
# profile.  The bf16 backward at the families' head dims (mixtral 128 at
# group 4, hymba 64 at group 5) builds with Danube's TRAIN_HEAD_DIMS
FAMILY_TRAIN = (("mixtral_8x7b", 2, 8192, 8192),
                ("hymba_1_5b", 2, 8192, 8192),
                ("xlstm_350m", 8, 1024, 512))
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_HEAD_DIMS = (128, 64)
# the sharded training phase: full-width Danube cut to SHARDED_DEPTH of its
# 24 layers, trained by Trainer(rules=) on a (2, 2) ("data", "model") mesh
# of 4 rank processes under the dry run's train rules, one 8192-token
# sequence a data rank; the float32 smoke check on the same mesh
SHARDED_MESH, SHARDED_RANKS = ((2, 2), ("data", "model")), 4
SHARDED_DEPTH, SHARDED_BATCH, SHARDED_SEQ, SHARDED_STEPS = 2, 2, 8192, 3
SHARDED_SMOKE_BATCH, SHARDED_SMOKE_STEPS = 4, 3
SHARDED_TIMEOUT_S = 420
# (B, S, H, KV, D, window): the head dims, GQA, a window >= S, a last query
# tile that is not full, a head dim that is not a multiple of 16, D 256
# with a ragged last tile
SWA_SHAPES = [(2, 256, 4, 4, 64, 64), (1, 256, 32, 8, 80, 96),
              (2, 512, 8, 2, 128, 256), (1, 128, 4, 4, 256, 512),
              (2, 200, 4, 1, 80, 4096), (1, 192, 8, 2, 40, 100),
              (1, 200, 4, 2, 256, 96)]


def log(*a):
    print(*a, flush=True)


def make_inputs(p, grid, seed):
    """Seeded inputs as numpy arrays, as a request holds them: normal
    fields, ``e3t`` >= 1, ``msk`` in {0, 1}, scalars 0.1, normal coeffs;
    pw fields scaled by 0.1 so ten Euler steps stay bounded.  Drawn on
    the card from ``seed`` (a host draw of the serve phase's requests
    took seconds)."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device="cuda").cpu().numpy()

    scale = np.float32(0.1 if p.name == "pw_advection" else 1.0)
    fields = {f: normal(grid) * scale for f in p.input_fields()}
    if "e3t" in fields:
        fields["e3t"] = np.abs(fields["e3t"]) + np.float32(1.0)
    if "msk" in fields:
        fields["msk"] = (fields["msk"] > 0).astype(np.float32)
    if "t" in fields:
        fields["t"] += np.float32(15.0)
    scalars = {s: np.float32(0.1) for s in p.scalars}
    coeffs = {c: normal((grid[ax],)) for c, ax in p.coeffs.items()}
    return fields, scalars, coeffs


#: clock cycles the card sleeps while a timing's calls are queued: about
#: 10 ms at the H100's 1.98 GHz, longer than 20 launches take from Python
QUEUE_SLEEP_CYCLES = 20_000_000


def time_ms(fn, inner=1, reps=5, warmup=2, queued=False):
    """Median over ``reps`` of CUDA-event time per call of ``fn``.
    ``queued``: the ``inner`` calls are queued while the card sleeps
    before the first event, so they run back to back and the time is the
    card's alone, not the host's time to launch them (a kernel of 0.1 ms
    takes about as long to launch from Python)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return statistics.median(ts)


def time_in_turns(fns, reps=5, warmup=2):
    """Median CUDA-event time of one call of each of ``fns``, the calls
    made in turns (a, b, a, b, ...) so that all see the same clocks."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    ts = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(ts, fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t.append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in ts]


def ptxas_stats(report: str) -> dict:
    """Registers and spill bytes of the kernel in a ``-Xptxas -v`` log."""
    regs = re.findall(r"Used (\d+) registers", report)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        report)
    return {"registers": int(regs[-1]) if regs else None,
            "spill_stores": int(spills[-1][0]) if spills else None,
            "spill_loads": int(spills[-1][1]) if spills else None}


def ptxas_by_entry(report: str) -> dict:
    """Registers and spill bytes of each generated kernel of a ``-Xptxas
    -v`` log, by entry (``g0``, ``g1``, ...): the registers of its
    one-element instantiation (``registers``, what a single request runs)
    and of its batched one (``registers_batched``), and the most spill
    bytes either reports."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        m = re.match(r"_Z\d+(g\d+)_kernelILb([01])E", chunk)
        if m:
            st = out.setdefault(m.group(1), {
                "registers": None, "registers_batched": None,
                "spill_stores": 0, "spill_loads": 0})
            regs = re.findall(r"Used (\d+) registers", chunk)
            key = "registers_batched" if m.group(2) == "1" else "registers"
            st[key] = int(regs[-1]) if regs else None
            for a, b in re.findall(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", chunk):
                st["spill_stores"] = max(st["spill_stores"], int(a))
                st["spill_loads"] = max(st["spill_loads"], int(b))
    return out


def source_digest(source: str) -> str:
    """Short SHA-256 of a generated translation unit."""
    return hashlib.sha256(source.encode()).hexdigest()[:16]


def rel_err(got, want):
    """Max abs difference over the max abs of ``want`` (no floor, so a
    field of small values is held to its own scale)."""
    g, w = got.float(), want.float()
    err, scale = float((g - w).abs().max()), float(w.abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def block_paths(pw_advection, pw_advection_update, tracer_advection,
                tracer_advection_update):
    """The block schedule's paths (each runs the generated fuse-group
    kernels)."""
    pw_upd = pw_advection_update(0.1)
    tr_upd = tracer_advection_update()
    return [
        dict(name="pw_zero_step", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_periodic_step", app=pw_advection, boundary="periodic",
             grid=PW_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="pw_zero_fused10", app=pw_advection, boundary="zero",
             grid=PW_GRID, dtype="float32", steps=PW_STEPS, tol=1e-4,
             update=pw_upd),
        dict(name="pw_periodic_fused10", app=pw_advection,
             boundary="periodic", grid=PW_GRID, dtype="float32",
             steps=PW_STEPS, tol=1e-4, update=pw_upd),
        dict(name="tracer_zero_step", app=tracer_advection, boundary="zero",
             grid=TRACER_GRID, dtype="float32", steps=None, tol=1e-5),
        dict(name="tracer_zero_fused4", app=tracer_advection,
             boundary="zero", grid=TRACER_GRID, dtype="float32",
             steps=TRACER_STEPS, tol=1e-4, update=tr_upd),
        dict(name="pw_bf16_step", app=pw_advection, boundary="zero",
             grid=BF16_GRID, dtype="bfloat16", steps=None, tol=2e-2),
    ]


def stream_paths(pw_advection, pw_advection_update, tracer_advection,
                 tracer_advection_update):
    """The stream schedule's paths (each runs the generated sweep kernels);
    ``eff`` is the (time_tile, plane_tile) legalisation must keep, and
    ``demoted`` marks a request it must demote with a warning."""
    pw_upd = pw_advection_update(0.1)
    tr_upd = tracer_advection_update()
    pw = dict(app=pw_advection, grid=PW_GRID, dtype="float32")
    fused = dict(steps=PW_STEPS, tol=1e-4, update=pw_upd)
    tr = dict(app=tracer_advection, grid=TRACER_GRID, dtype="float32")
    return [{"schedule": "stream", "eff": (1, 1)} | ph for ph in [
        dict(name="pw_zero_stream_step", boundary="zero", steps=None,
             tol=1e-5, **pw),
        dict(name="pw_periodic_stream_step", boundary="periodic",
             steps=None, tol=1e-5, **pw),
        dict(name="pw_zero_stream_fused10_T1", boundary="zero",
             time_tile=1, **fused, **pw),
        dict(name="pw_zero_stream_fused10_T2", boundary="zero",
             time_tile=2, **fused, **pw) | dict(eff=(2, 1)),
        dict(name="pw_zero_stream_fused10_T4", boundary="zero",
             time_tile=4, **fused, **pw) | dict(eff=(4, 1)),
        dict(name="pw_periodic_stream_fused10_T2", boundary="periodic",
             time_tile=2, demoted=True, **fused, **pw),
        dict(name="pw_zero_stream_step_P2", boundary="zero", steps=None,
             tol=1e-5, plane_tile=2, **pw) | dict(eff=(1, 2)),
        dict(name="tracer_zero_stream_step", boundary="zero", steps=None,
             tol=1e-5, **tr),
        dict(name="tracer_zero_stream_fused4", boundary="zero",
             steps=TRACER_STEPS, tol=1e-4, update=tr_upd, **tr),
        dict(name="tracer_periodic_stream_step", boundary="periodic",
             steps=None, tol=1e-5, **tr),
        dict(name="pw_bf16_stream_step", app=pw_advection, boundary="zero",
             grid=BF16_GRID, dtype="bfloat16", steps=None, tol=2e-2),
    ]]


def config_key(ph) -> tuple:
    """Paths with equal keys compute the same function."""
    return (ph["p"].name, ph["boundary"], ph["grid"], ph["dtype"],
            ph["steps"])


def check_card(torch) -> dict:
    """The card's properties beside the ``hw.H100`` data-sheet constants
    the planner uses (which stay its constants, so plans do not depend on
    the card); a card with fewer SMs or less shared memory a CTA may opt
    into than the planner assumes fails the run."""
    from repro_torch import hw

    pr = torch.cuda.get_device_properties(0)
    got = {"sms": pr.multi_processor_count,
           "smem_per_block": pr.shared_memory_per_block_optin,
           "smem_per_sm": pr.shared_memory_per_multiprocessor,
           "registers_per_sm": pr.regs_per_multiprocessor,
           "threads_per_sm": pr.max_threads_per_multi_processor,
           "l2_bytes": pr.L2_cache_size, "hbm_bytes": pr.total_memory}
    for k, v in got.items():
        log(f"card {k}: {v} (planner's hw.H100: {getattr(hw.H100, k)})")
    for k in ("sms", "smem_per_block"):
        if got[k] < getattr(hw.H100, k):
            raise SystemExit(f"the card has {k} {got[k]}, fewer than the "
                             f"planner's {getattr(hw.H100, k)}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "chip_smoke.json"))
    ap.add_argument("--backward-parts", help=argparse.SUPPRESS)
    ap.add_argument("--sharded-rank", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.backward_parts:
        print(json.dumps(backward_parts_child(json.loads(
            args.backward_parts))))
        return 0
    if args.sharded_rank:
        sharded_rank_child(json.loads(args.sharded_rank))
        return 0
    t_smoke = time.perf_counter()
    laps, t_lap = {}, [t_smoke]

    def lap(name):
        """The seconds since the last lap, as ``name``'s."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import compile_program
    from repro_torch.analysis.stencil_roofline import model_plan
    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection, tracer_advection_update)
    from repro_torch.core import ProgramBuilder, TileDemotionWarning
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import build, stencil3d, stream3d, swa
    from repro_torch.obs import fraction_for

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    card_props = check_card(torch)

    # ---------------------------------------------------------------- paths
    apps = (pw_advection, pw_advection_update, tracer_advection,
            tracer_advection_update)
    paths = ([dict(ph, schedule="block") for ph in block_paths(*apps)]
             + stream_paths(*apps))
    t0 = time.perf_counter()
    plain_ex = {}
    for ph in paths:
        ph["p"] = ph["app"](ph["boundary"])
        kw = {} if ph["steps"] is None else dict(steps=ph["steps"],
                                                 update=ph["update"])
        if ph["schedule"] == "stream":
            kw.update({k: ph[k] for k in ("time_tile", "plane_tile")
                       if k in ph}, schedule="stream")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            ph["ex"] = compile_program(ph["p"], ph["grid"],
                                       dtype=ph["dtype"], **kw)
        demoted = any(issubclass(w.category, TileDemotionWarning)
                      for w in seen)
        if demoted != bool(ph.get("demoted")):
            raise SystemExit(f"{ph['name']}: TileDemotionWarning "
                             f"{'raised' if demoted else 'missing'}")
        if ph["schedule"] == "stream":
            st = ph["ex"].plan.stream
            if (st.time_tile, st.plane_tile) != ph["eff"]:
                raise SystemExit(f"{ph['name']}: effective tiles "
                                 f"{(st.time_tile, st.plane_tile)} != "
                                 f"{ph['eff']}")
        key = config_key(ph)
        if key not in plain_ex:
            kw.pop("schedule", None)
            kw.pop("time_tile", None)
            kw.pop("plane_tile", None)
            plain_ex[key] = compile_program(ph["p"], ph["grid"],
                                            dtype=ph["dtype"],
                                            backend="torch_fused", **kw)
    sources = [ph["ex"].kernels[0].module.source for ph in paths]
    swa_sources = [swa.kernel_source(getattr(torch, dt), d)
                   for dt in ("float32", "bfloat16")
                   for d in sorted(set(SWA_HEAD_DIMS + TRAIN_HEAD_DIMS))]
    bwd_sources = [swa.backward_source(getattr(torch, dt), d)
                   for dt in ("float32", "bfloat16") for d in TRAIN_HEAD_DIMS]
    bwd_sources += [swa.backward_source(torch.bfloat16, d)
                    for d in FAMILY_TRAIN_HEAD_DIMS]
    tags = (["stencil"] * len(sources) + ["swa"] * len(swa_sources)
            + ["swa_bwd"] * len(bwd_sources))
    swa_sources += bwd_sources
    build.build_many(sources + swa_sources, tag=tags)
    log(f"built {len(set(sources + swa_sources))} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, tag in dict.fromkeys(zip(sources + swa_sources, tags)):
        regs = [ln.strip() for ln in build.ptxas_report(src, tag).splitlines()
                if "registers" in ln or "spill" in ln]
        log("ptxas:", " | ".join(regs))
    swa_ptxas = []
    for dt in (torch.bfloat16, torch.float32):
        for d in SWA_HEAD_DIMS:
            st = ptxas_stats(build.ptxas_report(swa.kernel_source(dt, d),
                                                "swa"))
            st.update(dtype=str(dt).removeprefix("torch."), d=d,
                      source=str(swa.SOURCES[dt].relative_to(ROOT)),
                      smem_bytes=swa.smem_bytes(dt, d))
            swa_ptxas.append(st)
            log(f"ptxas swa {st['dtype']} D {d} ({st['source']}): "
                f"{st['registers']} registers, spill stores "
                f"{st['spill_stores']} B, spill loads {st['spill_loads']} B,"
                f" {st['smem_bytes']} B of dynamic shared memory a CTA")
            # the served libraries keep all in registers (D 128 recorded)
            if dt == torch.bfloat16 and d in SERVED_HEAD_DIMS and d != 128 \
                    and (st["spill_stores"] or st["spill_loads"]):
                raise SystemExit(f"ptxas spills in the bf16 SWA library at "
                                 f"D {d}")

    # ------------------------------------------- main path, counted launches
    inputs = {}
    for ph in paths:
        ikey = (ph["p"].name, ph["grid"], ph["dtype"])
        if ikey not in inputs:
            f, s, c = make_inputs(ph["p"], ph["grid"], args.seed)
            inputs[ikey] = inputs_from_numpy(f, s, c, "cuda", ph["dtype"])
        ph["inputs"] = inputs[ikey]
    for ph in paths:
        stencil3d.launches = stream3d.launches = swa.launches = 0
        out = ph["ex"](*ph["inputs"])
        torch.cuda.synchronize()
        ph["launches"] = (stream3d.launches if ph["schedule"] == "stream"
                          else stencil3d.launches)
        ph["out"] = out
        if ph["launches"] < 1:
            raise SystemExit(f"{ph['name']}: no kernel launch on the path")
    wants, block_out = {}, {}
    for ph in paths:
        key = config_key(ph)
        if key not in wants:
            wants[key] = plain_ex[key](*ph["inputs"])
        want, got = wants[key], ph.pop("out")
        if set(got) != set(want):
            raise SystemExit(f"{ph['name']}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
        for k in want:
            if tuple(got[k].shape) != ph["grid"] or \
                    not bool(torch.isfinite(got[k].float()).all()):
                raise SystemExit(f"{ph['name']}/{k}: bad shape or values")
        ph["e2e_err"] = max(rel_err(got[k], want[k]) for k in want)
        msg = (f"{ph['name']}: launches {ph['launches']}, vs torch_fused "
               f"max rel err {ph['e2e_err']:.3e}")
        if ph["schedule"] == "block":
            block_out[key] = got
        elif key in block_out:
            ph["block_err"] = max(rel_err(got[k], block_out[key][k])
                                  for k in want)
            msg += f", vs block path {ph['block_err']:.3e}"
            if ph["block_err"] > ph["tol"]:
                raise SystemExit(f"{ph['name']}: disagrees with the block "
                                 "path")
        log(msg + f" (tol {ph['tol']})")
        if ph["e2e_err"] > ph["tol"]:
            raise SystemExit(f"{ph['name']}: disagrees with torch_fused")
    del wants, block_out

    # small grids against the CPU oracle, and a group that reads no field
    # or coefficient (o0 = s0) under every schedule: all compiled first,
    # so that their kernels build at once
    small = {(app, schedule): compile_program(app(), SMALL_GRID,
                                              schedule=schedule)
             for app in (pw_advection, tracer_advection)
             for schedule in ("block", "stream")}
    b = ProgramBuilder("scalar_only", ndim=3, boundary="zero")
    b.inputs("in0")
    b.define(b.outputs("o0")[0], b.scalars("s0")[0])
    nothing = b.build()
    nothing_kw = ({}, {"strategy": "per_field"}, {"schedule": "stream"})
    nothing_ex = [compile_program(nothing, NOTHING_GRID, **kw)
                  for kw in nothing_kw]
    for app in (pw_advection, tracer_advection):
        p = app()
        f, s, c = make_inputs(p, SMALL_GRID, args.seed)
        want = compile_program(p, SMALL_GRID, backend="torch_naive",
                               device="cpu")(f, s, c)
        for schedule in ("block", "stream"):
            got = small[app, schedule](f, s, c)
            err = max(rel_err(got[k].cpu(), want[k]) for k in want)
            log(f"{p.name} {SMALL_GRID} {schedule}: card vs CPU oracle max "
                f"rel err {err:.3e} (tol 1e-5)")
            if err > 1e-5:
                raise SystemExit(f"{p.name} {schedule}: card disagrees with "
                                 "the CPU oracle")

    for kw, ex in zip(nothing_kw, nothing_ex):
        stencil3d.launches = stream3d.launches = 0
        got = ex({"in0": torch.zeros(NOTHING_GRID, device="cuda")},
                 {"s0": 0.5})["o0"]
        torch.cuda.synchronize()
        n = stencil3d.launches + stream3d.launches
        log(f"o0 = s0 on {NOTHING_GRID} {kw or 'block'}: sum "
            f"{float(got.sum())} (want 768), {n} kernel launches")
        if float(got.sum()) != 768.0 or n < 1 or got.device.type != "cuda":
            raise SystemExit(f"a group that reads nothing failed under {kw}")
    del small, nothing_ex

    # ------------------------------- kernel vs plain version, and timings
    rows, plain_step = [], {}
    for ph in paths:
        ex = ph["ex"]
        step_ms = time_ms(lambda: ex(*ph["inputs"]))
        key = config_key(ph)
        if key not in plain_step:
            plain_step[key] = time_ms(lambda: plain_ex[key](*ph["inputs"]))
        if ph["schedule"] == "stream":
            row = stream_row(ph, torch, stream3d)
        else:
            row = block_row(ph, torch, stencil3d)
        steps = ph["steps"] or 1
        row.update(step_ms=step_ms / steps,
                   plain_backend_step_ms=plain_step[key] / steps,
                   modeled_ms=model_plan(ph["p"], ex.plan, ph["grid"]) * 1e3,
                   roofline_fraction=fraction_for(ex, step_ms / 1e3))
        rows.append(row)
        log(f"{ph['name']}: kernel {row['ms']:.4f} ms/step (bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}), plain "
            f"{row['plain_ms']:.3f} ms, end-to-end {row['step_ms']:.4f} "
            f"ms/step (plan model {row['modeled_ms']:.4f} ms/step, "
            f"roofline fraction {row['roofline_fraction']:.3f}), "
            f"torch_fused {row['plain_backend_step_ms']:.4f} "
            f"ms/step, launches/step {row['launches_per_step']:g}")
    path_rows = [{k: ph.get(k) for k in (
        "name", "schedule", "grid", "dtype", "boundary", "steps", "time_tile",
        "plane_tile", "eff", "launches", "e2e_err", "block_err")}
        for ph in paths]
    del paths, inputs, plain_ex, ph
    torch.cuda.empty_cache()

    # ------------------------------------------------- measured plan search
    lap("main_path")
    tuner = tuner_phase(args.seed, torch)
    lap("tuner")
    torch.cuda.empty_cache()

    # ------------------------------------------------ stencil serving path
    serve_rows, serve = serve_phase(args.seed, torch, card)
    lap("serve")
    rows += serve_rows
    torch.cuda.empty_cache()

    # ------------------------------------------- distribution over a mesh
    mesh_rows, mesh = mesh_phase(args.seed, torch, card)
    lap("mesh")
    rows += mesh_rows
    torch.cuda.empty_cache()

    # --------------------------------------------------- LM serving path
    lm_rows, lm = lm_phase(args.seed, torch, swa)
    lap("lm")
    rows += lm_rows
    lm["swa_ptxas"] = swa_ptxas
    torch.cuda.empty_cache()

    # -------------------------------------------------- LM training path
    train_rows, train = train_phase(args.seed, torch, swa)
    lap("train")
    rows += train_rows
    torch.cuda.empty_cache()

    # ------------------------- sharded LM training over a (2, 2) mesh
    sharded_rows, sharded = sharded_train_phase(args.seed, torch, swa)
    lap("sharded_train")
    rows += sharded_rows
    torch.cuda.empty_cache()

    # -------------------------------- Whisper serving (no kernel on it)
    whisper = whisper_phase(args.seed, torch)
    lap("whisper")
    torch.cuda.empty_cache()

    # ------------------ LM serving: the MoE, hybrid and xLSTM families
    # (last: after xlstm's profile of ~1M events, the train phase's short
    # profile of the backward came back empty in two calls out of three)
    family_rows, families = families_phase(args.seed, torch, swa, swa_ptxas)
    lap("families")
    rows += family_rows
    torch.cuda.empty_cache()

    # ------------- LM training: the MoE, hybrid and xLSTM families, whisper
    # (after the families' serving profiles, which empty later short ones)
    family_train_rows, family_train = family_train_phase(args.seed, torch,
                                                         swa)
    lap("family_train")
    rows += family_train_rows
    torch.cuda.empty_cache()

    # --------------------------------------------------- the port's examples
    examples = examples_phase(card, torch)
    lap("examples")

    smoke_s = time.perf_counter() - t_smoke
    log(f"chip_smoke: {smoke_s:.1f} s in all; by phase "
        + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    result = {"card": card, "card_properties": card_props,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "seed": args.seed, "kernels": rows, "paths": path_rows,
              "tuner": tuner, "serve": serve, "mesh": mesh, "lm": lm,
              "families": families, "family_train": family_train,
              "train": train,
              "sharded_train": sharded, "whisper": whisper,
              "examples": examples, "seconds": smoke_s,
              "phase_seconds": laps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def block_row(ph, torch, stencil3d) -> dict:
    """The path's first fuse-group kernel against its plain version on the
    inputs the path gives it, and its times."""
    from repro_torch.analysis.stencil_roofline import (kernel_traffic,
                                                       roofline_seconds)
    from repro_torch.core import boundary as bc
    from repro_torch.core.lower_kernel import scalar_vector
    from repro_torch.kernels import build

    p, ex, grid = ph["p"], ph["ex"], ph["grid"]
    call = ex.kernels[0]
    fields, scalars, coeffs = ph["inputs"]
    bnd = p.boundaries()
    spec = ex.time_spec
    if spec is None:
        padded = {f: bc.pad_field(fields[f], call.halo_lo, call.halo_hi,
                                  bnd[f], align_hi=call.align_hi
                                  ).contiguous()
                  for f in call.group_inputs}
        ipad = None
    else:                      # the fused loop's carry buffers
        al = spec.align_hi
        fp = spec.field_pad
        padded = {f: bc.pad_field(fields[f], fp[f][:, 0],
                                  [int(fp[f][a, 1]) - al[a]
                                   for a in range(3)],
                                  bnd[f], align_hi=al).contiguous()
                  for f in call.group_inputs}
        ipad = {f: fp[f] for f in call.group_inputs}
    pc = {c: bc.pad_coeff(coeffs[c], call.pad_lo[call.coeff_axis[c]],
                          call.pad_hi[call.coeff_axis[c]],
                          bc.coeff_mode(p)).contiguous()
          for c in call.group_coeffs}
    # the scalar rows the kernel reads, on the card once (a list of
    # numbers would cross to the card at every timed launch)
    svec = scalar_vector(p, scalars, "cuda")

    def kernel():
        return call(padded, svec, pc, input_pad=ipad)

    def plain():
        return stencil3d.group_call_reference(call, padded, svec, pc,
                                              input_pad=ipad)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in want)
    rel = max(rel_err(got[k], want[k]) for k in want)
    log(f"{ph['name']}: kernel vs plain max abs err {err:.3e}, max rel "
        f"err {rel:.3e} (tol {ph['tol']} of each field's max abs)")
    if rel > ph["tol"]:
        raise SystemExit(f"{ph['name']}: kernel disagrees with its "
                         "plain version")
    del got, want
    ms = time_ms(kernel, inner=20, queued=True)
    plain_ms = time_ms(plain, inner=1)
    # each input's grid points read once, each output written once (the
    # halo and alignment slabs of the windows are padding, not data)
    min_bytes, flops = kernel_traffic(
        p, grid, call.group_inputs, call.group_outputs,
        [p.ops[i].expr for i in call.group], call.itemsize,
        coeffs=call.group_coeffs)
    bound_s, bound_by = roofline_seconds(min_bytes, flops)
    cta = call.cta
    ptxas = ptxas_by_entry(build.ptxas_report(call.module.source)).get(
        call.entry, ptxas_stats(""))
    digest = source_digest(call.module.source)
    log(f"{ph['name']}: generated source sha256 {digest}")
    log(f"{ph['name']}: CTA chunk {cta.tile[0]} tile {cta.tile[1:]}, "
        f"{call.threads[0] * call.threads[1]} threads, {call.smem_bytes} B "
        f"shared memory, {cta.ctas_per_sm} CTAs an SM planned; ptxas "
        f"{ptxas['registers']} registers ({ptxas.get('registers_batched')} "
        "batched), spill stores "
        f"{ptxas['spill_stores']} B, loads {ptxas['spill_loads']} B; "
        f"{call.flops_per_point():.1f} generated operations and "
        f"{call.staged_bytes_per_point():.1f} staged bytes a point")
    return {
        "name": f"stencil3d.build_group_call[{ph['name']} "
                f"{'x'.join(map(str, grid))} {ph['dtype']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil3d.py",
        "replaces": stencil3d.REPLACES,
        "launches": ph["launches"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_per_step": ph["launches"] / (ph["steps"] or 1),
        "block": list(call.block),
        "threads": list(call.threads),
        "smem_bytes": call.smem_bytes,
        "ctas_per_sm": cta.ctas_per_sm,
        "levels": len(cta.levels),
        **ptxas,
        "gen_flops_per_point": call.flops_per_point(),
        "staged_bytes_per_point": call.staged_bytes_per_point(),
        "min_bytes": min_bytes,
        "source_sha256": digest,
    }


def stream_row(ph, torch, stream3d) -> dict:
    """Every sweep kernel of the path against its plain version on the
    arguments the path gives it (captured from one more run), and its
    times per step: each call's time times its launches in the path, over
    the path's steps."""
    from repro_torch.analysis.stencil_roofline import (kernel_traffic,
                                                       roofline_seconds)
    from repro_torch.kernels import build

    p, ex, grid = ph["p"], ph["ex"], ph["grid"]
    captured = {}
    launch = stream3d.StreamCall.__call__

    def capture(call, padded, svec=None, pc=None, origin=None,
                input_pad=None, device=None):
        n, args = captured.get(id(call), (0, None))
        if args is None:
            args = ({f: t.clone() for f, t in padded.items()}, svec,
                    {c: t.clone() for c, t in (pc or {}).items()}, origin,
                    input_pad)
        captured[id(call)] = (n + 1, args)
        return launch(call, padded, svec, pc, origin, input_pad, device)

    stream3d.StreamCall.__call__ = capture
    try:
        ex(*ph["inputs"])
    finally:
        stream3d.StreamCall.__call__ = launch
    torch.cuda.synchronize()
    steps = ph["steps"] or 1
    err = rel = ms = plain_ms = min_bytes = flops = 0.0
    calls = []
    for call in ex.kernels:
        n, (padded, svec, pc, origin, ipad) = captured[id(call)]

        def kernel(call=call, padded=padded, svec=svec, pc=pc,
                   origin=origin, ipad=ipad):
            return call(padded, svec, pc, origin, ipad)

        got = kernel()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = stream3d.stream_call_reference(call, padded, svec, pc, origin,
                                              ipad)
        e1.record()
        e1.synchronize()
        c_plain = e0.elapsed_time(e1)
        c_err = max(float((got[k].float() - want[k].float()).abs().max())
                    for k in want)
        c_rel = max(rel_err(got[k], want[k]) for k in want)
        del got, want
        c_ms = time_ms(kernel, inner=20, queued=True)
        # each region input's grid points read once and each stored field
        # written once a sweep; operations: every op and update a stage
        c_bytes, c_flops = kernel_traffic(
            p, grid, call.group_inputs, call.group_outputs,
            [op.expr for op in call.ops]
            + list((call.update_exprs or {}).values()),
            call.itemsize, coeffs=call.group_coeffs, times=call.T)
        err, rel = max(err, c_err), max(rel, c_rel)
        ms += c_ms * n / steps
        plain_ms += c_plain * n / steps
        min_bytes += c_bytes * n / steps
        flops += c_flops * n / steps
        cta = call.cta
        ptxas = ptxas_by_entry(build.ptxas_report(call.module.source)).get(
            call.entry, ptxas_stats(""))
        calls.append({"region": list(call.region.ops), "time_tile": call.T,
                      "plane_tile": call.P, "launches_per_run": n,
                      "ms": c_ms, "plain_ms": c_plain, "max_abs_err": c_err,
                      "max_rel_err": c_rel, "tile": list(cta.tile),
                      "threads": list(cta.threads), "chunk": cta.chunk,
                      "n_chunks": cta.n_chunks, "warmup": cta.warmup,
                      "ctas": cta.ctas, "smem_bytes": call.smem_bytes,
                      "ctas_per_sm": cta.ctas_per_sm,
                      "planes_in_flight": call.P,
                      "barriers_per_plane": call.barriers_per_plane(),
                      "staged_bytes_per_point":
                          call.staged_bytes_per_point(),
                      **ptxas})
        log(f"{ph['name']} region {list(call.region.ops)} T={call.T} "
            f"P={call.P}: kernel {c_ms:.4f} ms x{n}, plain {c_plain:.1f} ms,"
            f" max abs err {c_err:.3e}, max rel err {c_rel:.3e}; tile "
            f"{cta.tile}, chunk {cta.chunk} (+{cta.warmup}), {cta.ctas} "
            f"CTAs, {call.smem_bytes} B, {cta.ctas_per_sm} CTAs an SM "
            f"planned, {call.P} planes in flight, "
            f"{call.barriers_per_plane():g} barriers a plane, "
            f"{call.staged_bytes_per_point():.1f} staged bytes a point; "
            f"ptxas {ptxas['registers']} registers "
            f"({ptxas.get('registers_batched')} batched), spill stores "
            f"{ptxas['spill_stores']} B, loads {ptxas['spill_loads']} B")
        if ptxas["registers"] is None:
            raise SystemExit(f"{ph['name']}: no ptxas report for "
                             f"{call.entry}")
        if ptxas["spill_stores"] or ptxas["spill_loads"]:
            raise SystemExit(f"{ph['name']}: ptxas spills in sweep kernel "
                             f"{call.entry}")
    if rel > ph["tol"]:
        raise SystemExit(f"{ph['name']}: a sweep kernel disagrees with its "
                         "plain version")
    bound_s, bound_by = roofline_seconds(min_bytes, flops)
    digest = source_digest(ex.kernels[0].module.source)
    log(f"{ph['name']}: generated source sha256 {digest}")
    return {
        "name": f"stream3d.build_stream_call[{ph['name']} "
                f"{'x'.join(map(str, grid))} {ph['dtype']}]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stream3d.py",
        "replaces": stream3d.REPLACES,
        "launches": ph["launches"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_per_step": ph["launches"] / steps,
        "max_rel_err": rel,
        "min_bytes_per_step": min_bytes,
        "source_sha256": digest,
        "calls": calls,
    }


def tuner_phase(seed, torch) -> list:
    """The measured plan search at full size, each problem with a plan
    cache in a fresh temporary file: ``pw_advection`` at 512x256x256
    (fused ``steps=10`` with the update: loop mode) and
    ``tracer_advection`` at 256x256x128 (single step).  Every measured
    candidate's executables run again on seeded inputs and are held
    against ``torch_fused``; the winner is no slower than the
    ``auto_plan`` seed; a second ``strategy="tuned"`` compile through the
    file is a cache hit with no timed run; the tuned and ``auto_plan``
    executables are timed in turns.  Returns one record a problem."""
    import tempfile

    from repro_torch import compile_program
    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection)
    from repro_torch.core import PlanCache, TuneConfig, tune_plan
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import stencil3d, stream3d
    from repro_torch.obs import global_metrics

    problems = [("pw_advection", pw_advection, PW_GRID, PW_STEPS,
                 pw_advection_update(0.1)),
                ("tracer_advection", tracer_advection, TRACER_GRID, None,
                 None)]
    records = []
    timed = global_metrics().counter("tune.timed_runs")
    with tempfile.TemporaryDirectory() as tmp:
        for name, app, grid, steps, update in problems:
            p = app("zero")
            path = str(Path(tmp) / f"{name}.json")
            cfg = TuneConfig(max_measured=8, repeats=3,
                             **({"steps": steps} if steps else {}))
            stencil3d.launches = stream3d.launches = 0
            res = tune_plan(p, grid, update=update, config=cfg,
                            cache=PlanCache(path), device="cuda")
            torch.cuda.synchronize()
            tune_launches = {"block": stencil3d.launches,
                             "stream": stream3d.launches}
            rec = res.record
            log(f"tune {name} {'x'.join(map(str, grid))}: "
                f"{rec['candidates']} candidates, {rec['measured']} measured,"
                f" {rec['tune_seconds']:.1f} s ({rec['build_seconds']:.1f} s "
                f"of it nvcc, one build_many); launches {tune_launches}")
            base = res.baseline
            fused = steps is not None
            cands = []
            for c in res.measured:
                eff = c.plan.stream if c.plan.stream is not None else c.plan
                cands.append({
                    "label": c.label, "schedule": c.plan.schedule,
                    "groups": len(c.plan.groups), "block": list(c.plan.block),
                    "time_tile": int(eff.time_tile),
                    "plane_tile": int(eff.plane_tile),
                    "carry_write": c.carry_write,
                    "modeled_us": c.modeled_s * 1e6,
                    "us_single": c.us_single, "us_fused": c.us_fused,
                    "us_fused_per_step": (c.us_fused / steps if fused
                                          else None),
                    "roofline_fraction": c.roofline_fraction})
                log(f"  {c.label}: modeled {c.modeled_s * 1e6:.1f} us/step, "
                    f"single {c.us_single:.1f} us"
                    + (f", fused x{steps} {c.us_fused:.1f} us "
                       f"({c.us_fused / steps:.1f} a step)" if fused else "")
                    + f", roofline fraction {c.roofline_fraction:.3f}")
            winner = res.measured[0]
            log(f"tune {name}: winner {winner.label} score "
                f"{winner.score():.1f} us against auto_plan {base.score():.1f}"
                f" us")
            if winner.score() > base.score():
                raise SystemExit(f"tune {name}: the winner is slower than "
                                 "the auto_plan seed")
            if tune_launches["block"] < 1 or tune_launches["stream"] < 1:
                raise SystemExit(f"tune {name}: a generated kernel was not "
                                 "launched")

            # every measured candidate against torch_fused on seeded inputs
            f, s, c = make_inputs(p, grid, seed)
            inputs = inputs_from_numpy(f, s, c, "cuda", "float32")
            modes = [(None, 1e-5)] + ([(steps, 1e-4)] if fused else [])
            wants = {}
            for n, _ in modes:
                kw = {} if n is None else dict(steps=n, update=update)
                wants[n] = compile_program(p, grid, backend="torch_fused",
                                           **kw)(*inputs)
            worst = 0.0
            for c, row in zip(res.measured, cands):
                for n, tol in modes:
                    kw = {} if n is None else dict(
                        steps=n, update=update, carry_write=c.carry_write)
                    ex = compile_program(p, grid, plan=c.plan, **kw)
                    stencil3d.launches = stream3d.launches = 0
                    got = ex(*inputs)
                    torch.cuda.synchronize()
                    launched = stencil3d.launches + stream3d.launches
                    err = max(rel_err(got[k], wants[n][k])
                              for k in wants[n])
                    del got
                    row["err_single" if n is None else "err_fused"] = err
                    worst = max(worst, err)
                    if launched < 1 or err > tol:
                        raise SystemExit(
                            f"tune {name} {c.label} (steps {n}): {launched} "
                            f"launches, max rel err {err:.3e} against "
                            f"torch_fused (tol {tol})")
            del wants
            log(f"tune {name}: all {len(cands)} measured candidates match "
                f"torch_fused (worst max rel err {worst:.3e})")

            # the tuned compile through the file: a hit, no timed run
            kw = {} if not fused else dict(steps=steps, update=update)
            cache = PlanCache(path)
            before = timed.value
            ex_t = compile_program(p, grid, strategy="tuned",
                                   plan_cache=cache, tune_config=cfg, **kw)
            if cache.hits != 1 or cache.misses or timed.value != before:
                raise SystemExit(f"tune {name}: the second tuned compile "
                                 f"was no pure cache hit (hits {cache.hits},"
                                 f" misses {cache.misses}, timed runs "
                                 f"{timed.value - before})")
            ex_a = compile_program(p, grid, **kw)
            tuned_ms, auto_ms = time_in_turns(
                [lambda: ex_t(*inputs), lambda: ex_a(*inputs)])
            per = steps or 1
            log(f"tune {name}: cache hit, 0 timed runs; in turns a step: "
                f"tuned ({winner.label}) {tuned_ms / per:.4f} ms, auto_plan "
                f"{auto_ms / per:.4f} ms")
            del inputs, ex_t, ex_a
            records.append({
                "program": name, "grid": list(grid), "steps": steps,
                "candidates": rec["candidates"], "measured": cands,
                "winner": winner.label, "baseline_score_us": base.score(),
                "winner_score_us": winner.score(),
                "tune_seconds": rec["tune_seconds"],
                "build_seconds": rec["build_seconds"],
                "tune_launches": tune_launches,
                "tuned_step_ms": tuned_ms / per,
                "auto_step_ms": auto_ms / per})
    return records


def serve_traffic(seed) -> dict:
    """The serving phase's requests, from ``seed`` with numpy: per phase
    the engine's compile knobs, the requests and the tolerance of an answer
    against the port's own compile of its exact grid.  Scalars differ per
    request (scaled by 0.5-1.5), so a batch's elements read their own."""
    import numpy as np

    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection)
    from repro_torch.serve import StencilRequest

    rng = np.random.default_rng(seed + 18)

    def reqs(app, boundary, ranges, n, steps):
        out = []
        for _ in range(n):
            grid = tuple(int(rng.integers(lo, hi + 1)) for lo, hi in ranges)
            p = app(boundary)
            f, sc, c = make_inputs(p, grid, int(rng.integers(1 << 30)))
            sc = {k: np.float32(v * rng.uniform(0.5, 1.5))
                  for k, v in sc.items()}
            kw = ({} if steps is None else dict(
                steps=steps, update=pw_advection_update(0.1),
                update_key="pw_advection_update(0.1)"))
            out.append(StencilRequest(program=p, fields=f, scalars=sc,
                                      coeffs=c, **kw))
        return out

    big = reqs(pw_advection, "zero", SERVE_PW_BIG, 16, SERVE_STEPS)
    return {
        "pw_fused": dict(engine={}, tol=1e-4, reqs=big + reqs(
            pw_advection, "zero", SERVE_PW_SMALL, 8, SERVE_STEPS)),
        "pw_periodic": dict(engine={}, tol=1e-4, reqs=reqs(
            pw_advection, "periodic", SERVE_PW_BIG, 4, SERVE_STEPS)),
        "tracer_step": dict(engine={}, tol=1e-5, reqs=reqs(
            tracer_advection, "zero", SERVE_TRACER, 8, None)),
        "pw_stream": dict(engine=dict(schedule="stream", time_tile=2),
                          tol=1e-4, reqs=big[:4]),
    }


def serve_pass(eng, reqs, torch):
    """All of ``reqs`` submitted at once and answered; (results, seconds
    from the first submit to the last answer)."""
    t0 = time.perf_counter()
    res = eng.map(reqs, timeout=600)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def serve_phase(seed, torch, card) -> tuple:
    """The stencil serving engine at the paper's 8M grid
    (``repro_torch.serve.StencilEngine``, ``max_batch`` 4, a 5 ms window):
    pw fused x10 (16 requests to the 256x256x128 bucket, 8 to 192x192x96),
    pw periodic fused x10 (4), tracer single steps (8), and a stream engine
    asked for time_tile 2 (4 pw fused requests; the bucket's update rule
    is not plane-local, so the chain demotes to 1).  Each phase: a warm-up
    pass (executor compiles, kernel builds), then the measured pass with
    the launch counts zeroed before it and read after it, which must build
    no kernel and compile no executor.  Every answer is held against the
    port's own ``compile_program`` of its exact grid on the card
    (``torch_fused``; the first request also ``cuda``); on each bucket a
    batch of up to 4 is bit-equal to batches of 1 and makes as many
    launches as one; each bucket's batched kernel is held against its
    batched plain version and timed (queued), the first bucket's giving
    the phase's kernel row.  pw fused is also served with ``max_batch`` 1,
    in turns with the batched engine.  Returns (kernel rows, record)."""
    from repro_torch import compile_program
    from repro_torch.analysis.stencil_roofline import (kernel_traffic,
                                                       roofline_seconds)
    from repro_torch.kernels import build, stencil3d, stream3d
    from repro_torch.serve import StencilEngine

    t_phase = time.perf_counter()
    traffic = serve_traffic(seed)
    # the first request of each phase compiled on its exact grid with the
    # generated kernels (their builds start at once)
    direct = {}
    for name, ph in traffic.items():
        r = ph["reqs"][0]
        kw = ({} if r.steps is None else
              dict(steps=r.steps, update=r.update))
        direct[name] = compile_program(r.program, r.grid(),
                                       schedule=ph["engine"].get("schedule"),
                                       **kw)
    rows, record = [], {"card": card, "batch": SERVE_BATCH,
                        "window_s": SERVE_WINDOW_S, "phases": {}}
    for name, ph in traffic.items():
        reqs, tol = ph["reqs"], ph["tol"]
        eng = StencilEngine(max_batch=SERVE_BATCH, window_s=SERVE_WINDOW_S,
                            **ph["engine"])
        try:
            t0 = time.perf_counter()
            serve_pass(eng, reqs, torch)                   # warm-up
            warm_s = time.perf_counter() - t0
            st = eng.stats
            before = {k: getattr(st, k) for k in (
                "compiles", "traces", "batches", "padded_slots",
                "exec_hits", "exec_misses", "completed")}
            runs = build.runs
            st.reset_latencies()
            stencil3d.launches = stream3d.launches = 0
            res, wall = serve_pass(eng, reqs, torch)
            launched = {"block": stencil3d.launches,
                        "stream": stream3d.launches}
            moved = {k: getattr(st, k) - v for k, v in before.items()}
            rec = {"requests": len(reqs), "warmup_s": warm_s,
                   "seconds": wall, "req_per_s": len(reqs) / wall,
                   "p50_ms": st.p50_ms(), "p99_ms": st.p99_ms(),
                   "batches": moved["batches"],
                   "padded_slots": moved["padded_slots"],
                   "exec_hits": moved["exec_hits"],
                   "exec_misses": moved["exec_misses"],
                   "warm_compiles": moved["compiles"],
                   "warm_kernel_sources": moved["traces"],
                   "warm_nvcc_runs": build.runs - runs,
                   "launches": launched}
            kind = "stream" if ph["engine"].get("schedule") == "stream" \
                else "block"
            log(f"serve {name}: {len(reqs)} requests in {wall:.3f} s "
                f"({rec['req_per_s']:.2f} req/s), p50 {rec['p50_ms']:.1f} ms,"
                f" p99 {rec['p99_ms']:.1f} ms; {rec['batches']} batches, "
                f"{rec['padded_slots']} padded slots, executor hits "
                f"{rec['exec_hits']} misses {rec['exec_misses']}; warm: "
                f"{rec['warm_compiles']} compiles, "
                f"{rec['warm_kernel_sources']} kernel sources, "
                f"{rec['warm_nvcc_runs']} nvcc runs; launches {launched} "
                f"({card})")
            if moved["compiles"] or moved["traces"] or build.runs != runs \
                    or moved["exec_misses"]:
                raise SystemExit(f"serve {name}: a warm request compiled an "
                                 "executor or built a kernel")
            if launched[kind] < 1:
                raise SystemExit(f"serve {name}: no {kind} kernel launch")

            # every answer against the port's compile of its exact grid
            worst = 0.0
            for i, (r, out) in enumerate(zip(reqs, res)):
                kw = ({} if r.steps is None else
                      dict(steps=r.steps, update=r.update))
                wants = [compile_program(r.program, r.grid(),
                                         backend="torch_fused", **kw)]
                if i == 0:
                    wants.append(direct[name])
                for ex in wants:
                    want = ex(r.fields, r.scalars, r.coeffs)
                    err = max(rel_err(out.outputs[k], want[k]) for k in want)
                    worst = max(worst, err)
                    if err > tol or set(out.outputs) != set(want):
                        raise SystemExit(
                            f"serve {name} request {i} {r.grid()}: max rel "
                            f"err {err:.3e} against {ex.plan.backend} on its "
                            f"grid (tol {tol})")
            rec["max_rel_err"] = worst
            log(f"serve {name}: every answer vs compile_program on its exact "
                f"grid (torch_fused; the first also cuda): max rel err "
                f"{worst:.3e} (tol {tol})")

            # each bucket's batch of up to 4 against batches of 1; the
            # first bucket's kernel is the phase's row
            by_bucket = {}
            for r, out in zip(reqs, res):
                by_bucket.setdefault(out.bucket.bucket, []).append(r)
            rec["buckets"] = {}
            for breqs in by_bucket.values():
                key, f, sc, c = eng.batch_inputs(breqs[:SERVE_BATCH])
                bex = eng.executor(key)
                if kind == "stream":
                    eff = bex.plan.stream.time_tile
                    rec["time_tile"] = {"requested": 2, "effective": eff}
                    log(f"serve {name}: time_tile 2 requested, effective "
                        f"{eff}")
                    if eff != 1:
                        raise SystemExit(f"serve {name}: the chain did not "
                                         "demote to time_tile 1")
                row, bit = serve_batch_checks(
                    name, bex, f, sc, c, tol, torch, stencil3d, stream3d,
                    kernel_traffic, roofline_seconds)
                rec["buckets"][bit.pop("bucket")] = bit
                if not rows or rows[-1]["name"].split()[1] != name:
                    row["launches"] = launched[kind]
                    rows.append(row)

            if name == "pw_fused":
                one = StencilEngine(max_batch=1, window_s=SERVE_WINDOW_S)
                try:
                    serve_pass(one, reqs, torch)           # warm-up
                    turns = {"batched": [], "max_batch_1": []}
                    for _ in range(2):
                        for k, e in (("batched", eng), ("max_batch_1", one)):
                            turns[k].append(serve_pass(e, reqs, torch)[1])
                finally:
                    one.close()
                rec["in_turns_req_per_s"] = {
                    k: [len(reqs) / t for t in v] for k, v in turns.items()}
                log(f"serve {name}: in turns, req/s batched "
                    f"{rec['in_turns_req_per_s']['batched']}, max_batch 1 "
                    f"{rec['in_turns_req_per_s']['max_batch_1']} ({card})")
        finally:
            eng.close()
        record["phases"][name] = rec
    record["phases"]["reads_nothing"] = serve_reads_nothing(seed, torch, card)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"serve phase: {record['seconds']:.1f} s")
    return rows, record


def serve_batch_checks(name, bex, fields, scalars, coeffs, tol, torch,
                       stencil3d, stream3d, kernel_traffic,
                       roofline_seconds) -> tuple:
    """A bucket executor's batch against batches of one: bit-equal, and as
    many launches; its first kernel, on the arguments the batch gives it,
    against its batched plain version, timed (queued).  Returns (kernel
    row without ``launches``, record)."""
    B = next(iter(fields.values())).shape[0]
    captured = {}
    saved = (stencil3d.launch, stream3d.launch)

    def capture(call, padded, sv, pc, origin, ipad, device=None):
        if id(call) not in captured:
            captured[id(call)] = (call, (
                {k: t.clone() for k, t in padded.items()}, sv.clone(),
                {k: t.clone() for k, t in pc.items()}, origin, ipad))
        return saved[0](call, padded, sv, pc, origin, ipad, device)

    stencil3d.launch = stream3d.launch = capture
    try:
        stencil3d.launches = stream3d.launches = 0
        out = bex.batched(fields, scalars, coeffs)
        torch.cuda.synchronize()
    finally:
        stencil3d.launch, stream3d.launch = saved
    n_batch = stencil3d.launches + stream3d.launches
    equal, n_one = True, set()
    for i in range(B):
        stencil3d.launches = stream3d.launches = 0
        one = bex.batched({k: v[i:i + 1] for k, v in fields.items()},
                          {k: v[i:i + 1] for k, v in scalars.items()},
                          {k: v[i:i + 1] for k, v in coeffs.items()})
        torch.cuda.synchronize()
        n_one.add(stencil3d.launches + stream3d.launches)
        equal &= all(torch.equal(out[k][i], one[k][0]) for k in out)
    del out, one
    log(f"serve {name}: a batch of {B} vs {B} batches of 1: bit-equal "
        f"{equal}; launches {n_batch} vs {sorted(n_one)} each")
    if not equal or n_one != {n_batch}:
        raise SystemExit(f"serve {name}: a batch differs from batches of one "
                         "or launches more")
    call, args = next(iter(captured.values()))
    padded, sv, pc, origin, ipad = args
    ref = (stream3d.stream_call_reference if isinstance(call,
                                                         stream3d.StreamCall)
           else stencil3d.group_call_reference)

    def kernel():
        return call(padded, sv, pc, origin, ipad)

    got = kernel()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = ref(call, padded, sv, pc, origin, ipad)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in want)
    rel = max(rel_err(got[k], want[k]) for k in want)
    del got, want
    if rel > tol:
        raise SystemExit(f"serve {name}: the batched kernel disagrees with "
                         f"its batched plain version ({rel:.3e} > {tol})")
    ms = time_ms(kernel, inner=20, queued=True)
    p = call.program
    exprs = ([op.expr for op in call.ops]
             + list((getattr(call, "update_exprs", None) or {}).values())
             if isinstance(call, stream3d.StreamCall)
             else [p.ops[i].expr for i in call.group])
    nbytes, flops = kernel_traffic(p, call.grid_shape, call.group_inputs,
                                   call.group_outputs, exprs, call.itemsize,
                                   coeffs=call.group_coeffs,
                                   times=getattr(call, "T", 1))
    bound_s, bound_by = roofline_seconds(nbytes * B, flops * B)
    bucket = "x".join(map(str, call.grid_shape))
    mod = "stream3d.build_stream_call" if isinstance(
        call, stream3d.StreamCall) else "stencil3d.build_group_call"
    log(f"serve {name}: batched kernel B {B} at {bucket}: {ms:.4f} ms "
        f"(queued; bound {bound_s * 1e3:.4f} ms by {bound_by}), plain "
        f"{plain_ms:.1f} ms, vs plain max abs err {err:.3e}, max rel err "
        f"{rel:.3e} (tol {tol})")
    row = {"name": f"{mod}[serve {name} B{B} {bucket} float32]",
           "route": "cuda",
           "source": f"src/repro_torch/kernels/{mod.split('.')[0]}.py",
           "replaces": (stream3d.REPLACES if mod.startswith("stream")
                        else stencil3d.REPLACES),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_s * 1e3, "bound_by": bound_by,
           "library_ms": None, "batch": B, "bucket": bucket,
           "max_rel_err": rel}
    return row, {"batch": B, "bit_equal_to_batches_of_1": equal,
                 "launches_batch": n_batch, "launches_batch_of_1": n_batch,
                 "kernel_ms": ms, "kernel_bound_ms": bound_s * 1e3,
                 "plain_ms": plain_ms, "max_rel_err_vs_plain": rel,
                 "bucket": bucket}


def mesh_paths(pw_advection, pw_advection_update, tracer_advection,
               tracer_advection_update):
    """The mesh phase's compile rows: the program, grid and dtype, the
    mesh (shape, axis names, mesh_axes), the compile knobs and the
    tolerance against the local compile (``bit`` for bit-equal)."""
    pw_upd = pw_advection_update(0.1)
    pw = dict(app=pw_advection, grid=PW_GRID, dtype="float32")
    tr = dict(app=tracer_advection, grid=TRACER_GRID, dtype="float32")
    fused = dict(steps=PW_STEPS, update=pw_upd)
    return [
        dict(name="mesh_pw_zero_step", boundary="zero", mesh=MESH_22,
             kw={}, tol=1e-5, **pw),
        dict(name="mesh_pw_periodic_fused10", boundary="periodic",
             mesh=MESH_22, kw=fused, tol=1e-4, **pw),
        dict(name="mesh_pw_stream_T2_fused10", boundary="zero",
             mesh=MESH_22, kw=dict(fused, schedule="stream", time_tile=2),
             tol=1e-4, **pw),
        dict(name="mesh_tracer_zero_fused4", boundary="zero", mesh=MESH_222,
             kw=dict(steps=TRACER_STEPS, update=tracer_advection_update()),
             tol=1e-4, **tr),
        dict(name="mesh_tracer_periodic_stream", boundary="periodic",
             mesh=MESH_22, kw=dict(schedule="stream"), tol=1e-5, **tr),
        dict(name="mesh_pw_bf16_step", boundary="zero", mesh=MESH_22,
             kw={}, tol=2e-2, app=pw_advection, grid=BF16_GRID,
             dtype="bfloat16"),
        dict(name="mesh_degenerate_step", boundary="zero", mesh=MESH_111,
             kw={}, tol="bit", **pw),
        dict(name="mesh_degenerate_fused10", boundary="zero", mesh=MESH_111,
             kw=fused, tol="bit", **pw),
    ]


def card_mesh(shape, names):
    """A mesh of ``shape`` with every shard on ``cuda:0``."""
    import numpy as np

    from repro_torch.dist import make_auto_mesh
    return make_auto_mesh(shape, names,
                          devices=["cuda:0"] * int(np.prod(shape)))


def mesh_run(torch, fn):
    """One counted run of ``fn`` after an uncounted warm-up (the main
    path: launch counts and the exchanged bytes zeroed just before, read
    just after), with every kernel's first launch at a non-zero shard
    origin captured (its arguments cloned) and each exchange timed by CUDA
    events.  Returns (outputs, launches, exchanged bytes, exchange ms,
    captured)."""
    from repro_torch.core import distribute
    from repro_torch.kernels import stencil3d, stream3d

    fn()                                # warm-up: allocator, first launches
    torch.cuda.synchronize()
    captured, pairs = {}, []
    saved = (stencil3d.launch, stream3d.launch, distribute._exchange)

    def capture(call, padded, sv, pc, origin, ipad, device=None):
        if id(call) not in captured and origin is not None and any(origin):
            captured[id(call)] = (call, (
                {k: t.clone() for k, t in padded.items()}, sv.clone(),
                {k: t.clone() for k, t in pc.items()}, tuple(origin), ipad))
        return saved[0](call, padded, sv, pc, origin, ipad, device)

    def timed_exchange(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = saved[2](*a, **kw)
        e1.record()
        pairs.append((e0, e1))
        return out

    stencil3d.launch = stream3d.launch = capture
    distribute._exchange = timed_exchange
    try:
        stencil3d.launches = stream3d.launches = 0
        distribute.exchanged_bytes = 0
        out = fn()
        torch.cuda.synchronize()
        launches = stencil3d.launches + stream3d.launches
        nbytes = distribute.exchanged_bytes
    finally:
        stencil3d.launch, stream3d.launch, distribute._exchange = saved
    ex_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return out, launches, nbytes, ex_ms, captured


def mesh_kernel_row(name, captured, launches, steps, tol, torch) -> dict:
    """The first captured kernel (a launch at a non-zero shard origin)
    against its plain version on the same arguments, timed (queued), its
    bound from the shard-local grid it ran on."""
    from repro_torch.analysis.stencil_roofline import (kernel_traffic,
                                                       roofline_seconds)
    from repro_torch.kernels import build, stencil3d, stream3d

    call, (padded, sv, pc, origin, ipad) = next(iter(captured.values()))
    stream = isinstance(call, stream3d.StreamCall)
    ref = (stream3d.stream_call_reference if stream
           else stencil3d.group_call_reference)

    def kernel():
        return call(padded, sv, pc, origin, ipad)

    got = kernel()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = ref(call, padded, sv, pc, origin, ipad)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    err = max(float((got[k].float() - want[k].float()).abs().max())
              for k in want)
    rel = max(rel_err(got[k], want[k]) for k in want)
    del got, want
    if rel > (1e-5 if tol == "bit" else float(tol)):
        raise SystemExit(f"{name}: the kernel at origin {origin} disagrees "
                         f"with its plain version ({rel:.3e})")
    ms = time_ms(kernel, inner=20, queued=True)
    p = call.program
    exprs = ([op.expr for op in call.ops]
             + list((call.update_exprs or {}).values()) if stream
             else [p.ops[i].expr for i in call.group])
    B = next(iter(padded.values())).ndim - call.ndim
    nb = next(iter(padded.values())).shape[0] if B else 1
    nbytes, flops = kernel_traffic(p, call.grid_shape, call.group_inputs,
                                   call.group_outputs, exprs, call.itemsize,
                                   coeffs=call.group_coeffs,
                                   times=getattr(call, "T", 1))
    bound_s, bound_by = roofline_seconds(nbytes * nb, flops * nb)
    local = "x".join(map(str, call.grid_shape))
    mod = "stream3d.build_stream_call" if stream \
        else "stencil3d.build_group_call"
    ptxas = ptxas_by_entry(build.ptxas_report(call.module.source)).get(
        call.entry, ptxas_stats(""))
    log(f"{name}: kernel at origin {origin} on the {local} shard: "
        f"{ms:.4f} ms (queued; bound {bound_s * 1e3:.4f} ms by {bound_by}),"
        f" plain {plain_ms:.1f} ms, vs plain max abs err {err:.3e}, max rel"
        f" err {rel:.3e}; ptxas {ptxas['registers']} registers "
        f"({ptxas.get('registers_batched')} batched), spill stores "
        f"{ptxas['spill_stores']} B, loads {ptxas['spill_loads']} B; source "
        f"sha256 {source_digest(call.module.source)}")
    if stream and (ptxas["spill_stores"] or ptxas["spill_loads"]):
        raise SystemExit(f"{name}: ptxas spills in sweep kernel "
                         f"{call.entry}")
    return {"name": f"{mod}[{name} shard {local} "
                    f"{str(call.dtype).removeprefix('torch.')}]",
            "route": "cuda",
            "source": f"src/repro_torch/kernels/{mod.split('.')[0]}.py",
            "replaces": stream3d.REPLACES if stream else stencil3d.REPLACES,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None,
            "launches_per_step": launches / (steps or 1),
            "origin": list(origin), "shard_grid": local,
            "max_rel_err": rel, "batch": nb, **ptxas,
            "source_sha256": source_digest(call.module.source)}


def mesh_phase(seed, torch, card) -> tuple:
    """Distribution over a mesh whose shards all sit on ``cuda:0`` (see
    the module docstring).  Every row: the sharded executable's counted
    run (launches, exchanged bytes, exchange ms by CUDA events), its
    outputs against the local compile's on the card, both timed in turns,
    and its first kernel at a non-zero origin against its plain version.
    Returns (kernel rows, record)."""
    import tempfile

    from repro_torch import compile_program
    from repro_torch.apps import (pw_advection, pw_advection_update,
                                  tracer_advection, tracer_advection_update)
    from repro_torch.core import PlanCache, TuneConfig, tune_plan
    from repro_torch.interop import inputs_from_numpy
    from repro_torch.kernels import build
    from repro_torch.obs import global_metrics
    from repro_torch.serve import StencilEngine

    t_phase = time.perf_counter()
    paths = mesh_paths(pw_advection, pw_advection_update, tracer_advection,
                       tracer_advection_update)
    # the serve row's requests, each with its exact grid's local compile
    reqs = serve_traffic(seed)["pw_fused"]["reqs"][:SERVE_BATCH]
    direct = [compile_program(r.program, r.grid(), steps=r.steps,
                              update=r.update) for r in reqs]
    for ph in paths:
        ph["p"] = ph["app"](ph["boundary"])
        shape, names, axes = ph["mesh"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ph["ex"] = compile_program(ph["p"], ph["grid"], dtype=ph["dtype"],
                                       mesh=card_mesh(shape, names),
                                       mesh_axes=axes, **ph["kw"])
            ph["local"] = compile_program(ph["p"], ph["grid"],
                                          dtype=ph["dtype"], **ph["kw"])
    sources = [k.module.source for ph in paths
               for ex in (ph["ex"], ph["local"]) for k in ex.kernels]
    sources += [k.module.source for ex in direct for k in ex.kernels]
    t0 = time.perf_counter()
    build.build_many(sources)
    log(f"mesh phase: built {len(set(sources))} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    rows, record = [], {"card": card, "rows": {}}
    inputs = {}
    for ph in paths:
        name, ex, steps = ph["name"], ph["ex"], ph["kw"].get("steps")
        ikey = (ph["p"].name, ph["grid"], ph["dtype"])
        if ikey not in inputs:
            f, s, c = make_inputs(ph["p"], ph["grid"], seed)
            inputs[ikey] = inputs_from_numpy(f, s, c, "cuda", ph["dtype"])
        args = inputs[ikey]
        got, launches, nbytes, ex_ms, captured = mesh_run(
            torch, lambda: ex(*args))
        want = ph["local"](*args)
        torch.cuda.synchronize()
        if set(got) != set(want):
            raise SystemExit(f"{name}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
        for k in want:
            if tuple(got[k].shape) != ph["grid"] or not bool(
                    torch.isfinite(got[k].float()).all()):
                raise SystemExit(f"{name}/{k}: bad shape or values")
        err = max(rel_err(got[k], want[k]) for k in want)
        bit = all(torch.equal(got[k], want[k]) for k in want)
        del got, want
        per = steps or 1
        shards = ex.shard.local_grid
        n_shards = 1
        for ax in range(len(shards)):
            n_shards *= ex.shard.axis_size(ax)
        chain = (ex.plan.stream.time_tile
                 if steps and ex.plan.stream is not None else 1)
        # a chain (and its remainder) is one sweep a shard an iteration
        want_launches = (n_shards * (per // chain + (1 if per % chain
                                                     else 0))
                         if chain > 1 else n_shards * len(ex.kernels) * per)
        mesh_ms, local_ms = time_in_turns(
            [lambda: ex(*args), lambda: ph["local"](*args)])
        rec = {"grid": list(ph["grid"]), "dtype": ph["dtype"],
               "mesh": list(ph["mesh"][0]), "mesh_axes": list(ph["mesh"][2]),
               "shard_grid": list(shards), "schedule": ex.plan.schedule,
               "time_tile": int(chain), "steps": steps,
               "max_rel_err": err, "bit_equal": bit,
               "step_ms": mesh_ms / per, "local_step_ms": local_ms / per,
               "exchange_ms_per_step": ex_ms / per,
               "exchange_bytes_per_step": nbytes / per,
               "launches": launches, "launches_per_step": launches / per,
               "shards_x_kernels": n_shards * len(ex.kernels)}
        log(f"{name}: {ph['grid']} {ph['dtype']} mesh {ph['mesh'][0]} "
            f"({ex.shard.describe()}), {ex.plan.schedule}"
            f"{f' T={chain}' if chain > 1 else ''}, steps {per}: max rel "
            f"err vs the local compile {err:.3e} (tol {ph['tol']}), "
            f"bit-equal {bit}; in turns a step: sharded {mesh_ms / per:.4f}"
            f" ms, local {local_ms / per:.4f} ms; exchange "
            f"{ex_ms / per:.4f} ms and {nbytes / per / 2**20:.2f} MiB a "
            f"step; launches {launches} ({launches / per:g} a step; "
            f"{n_shards} shards x {len(ex.kernels)} kernels) ({card})")
        if ph["tol"] == "bit" and not bit:
            raise SystemExit(f"{name}: the degenerate mesh is not "
                             "bit-equal to the local compile")
        if ph["tol"] != "bit" and err > ph["tol"]:
            raise SystemExit(f"{name}: disagrees with the local compile")
        if launches != want_launches:
            raise SystemExit(f"{name}: {launches} launches, expected "
                             f"{want_launches}")
        if n_shards > 1:
            if not captured:
                raise SystemExit(f"{name}: no kernel launched at a non-zero "
                                 "origin")
            row = mesh_kernel_row(name, captured, launches, steps, ph["tol"],
                                  torch)
            rec["kernel"] = {k: row[k] for k in ("name", "ms", "bound_ms",
                                                  "plain_ms", "max_rel_err",
                                                  "origin")}
            rows.append(row)
        record["rows"][name] = rec
        del captured
    del inputs, paths
    torch.cuda.empty_cache()

    # ----------- rings a coefficient alone feeds, the stream axis sharded
    record["rows"]["coeff_rings"] = mesh_coeff_rings(seed, torch, card)
    torch.cuda.empty_cache()

    # ---------------------------------------- the plan search under a mesh
    p = pw_advection("zero")
    upd = pw_advection_update(0.1)
    shape, names, axes = MESH_22
    mesh = card_mesh(shape, names)
    f, s, c = make_inputs(p, PW_GRID, seed)
    args = inputs_from_numpy(f, s, c, "cuda", "float32")
    timed = global_metrics().counter("tune.timed_runs")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mesh_plans.json")
        cfg = TuneConfig(max_measured=MESH_TUNE_MEASURED, steps=PW_STEPS,
                         repeats=3)
        t0 = time.perf_counter()
        res = tune_plan(p, PW_GRID, update=upd, config=cfg,
                        cache=PlanCache(path), mesh=mesh, mesh_axes=axes)
        tune_s = time.perf_counter() - t0
        want = {None: compile_program(p, PW_GRID, backend="torch_fused")(
            *args), PW_STEPS: compile_program(
            p, PW_GRID, backend="torch_fused", steps=PW_STEPS,
            update=upd)(*args)}
        cands, worst = [], 0.0
        for cand in res.measured:
            for n, tol in ((None, 1e-5), (PW_STEPS, 1e-4)):
                kw = {} if n is None else dict(
                    steps=n, update=upd, carry_write=cand.carry_write)
                exc = compile_program(p, PW_GRID, plan=cand.plan, mesh=mesh,
                                      mesh_axes=axes, **kw)
                got, launched, _, _, _ = mesh_run(torch, lambda: exc(*args))
                err = max(rel_err(got[k], want[n][k]) for k in want[n])
                del got
                worst = max(worst, err)
                if launched < 1 or err > tol:
                    raise SystemExit(f"mesh_tuned {cand.label} (steps {n}):"
                                     f" {launched} launches, max rel err "
                                     f"{err:.3e} against torch_fused")
            cands.append({"label": cand.label,
                          "us_fused_per_step": cand.us_fused / PW_STEPS,
                          "modeled_us": cand.modeled_s * 1e6})
        del want
        cache = PlanCache(path)
        before = timed.value
        ex_t = compile_program(p, PW_GRID, strategy="tuned", mesh=mesh,
                               mesh_axes=axes, steps=PW_STEPS, update=upd,
                               plan_cache=cache, tune_config=cfg)
        hit = cache.hits == 1 and not cache.misses \
            and timed.value == before
        ex_a = compile_program(p, PW_GRID, mesh=mesh, mesh_axes=axes,
                               steps=PW_STEPS, update=upd)
        tuned_ms, auto_ms = time_in_turns([lambda: ex_t(*args),
                                           lambda: ex_a(*args)])
    log(f"mesh_tuned: pw {PW_GRID} fused x{PW_STEPS} on mesh {shape}: "
        f"{res.record['candidates']} candidates, {len(res.measured)} "
        f"measured in {tune_s:.1f} s ({res.record['build_seconds']:.1f} s "
        f"nvcc), winner {res.measured[0].label}; every measured candidate "
        f"vs torch_fused worst max rel err {worst:.3e}; second compile a "
        f"cache hit with 0 timed runs: {hit}; in turns a step: tuned "
        f"{tuned_ms / PW_STEPS:.4f} ms, auto_plan {auto_ms / PW_STEPS:.4f} "
        f"ms ({card})")
    if not hit:
        raise SystemExit("mesh_tuned: the second tuned compile was no pure "
                         "cache hit")
    if res.measured[0].score() > res.baseline.score():
        raise SystemExit("mesh_tuned: the winner is slower than auto_plan")
    record["rows"]["mesh_tuned"] = {
        "candidates": res.record["candidates"], "measured": cands,
        "winner": res.measured[0].label, "key_mesh": res.record["mesh"],
        "tune_seconds": tune_s, "build_seconds": res.record["build_seconds"],
        "max_rel_err": worst, "cache_hit": hit,
        "tuned_step_ms": tuned_ms / PW_STEPS,
        "auto_step_ms": auto_ms / PW_STEPS}
    got, launches, _, _, captured = mesh_run(torch, lambda: ex_t(*args))
    del got
    row = mesh_kernel_row("mesh_tuned", captured, launches, PW_STEPS, 1e-4,
                          torch)
    rows.append(row)
    del ex_t, ex_a, args, captured
    torch.cuda.empty_cache()

    # ------------------------------------------ serving over the mesh
    eng = StencilEngine(max_batch=SERVE_BATCH, window_s=SERVE_WINDOW_S,
                        mesh=mesh, mesh_axes=axes)
    try:
        serve_pass(eng, reqs, torch)                        # warm-up
        compiles = eng.stats.compiles
        res_s, wall = serve_pass(eng, reqs, torch)
        worst = 0.0
        for r, out, ex in zip(reqs, res_s, direct):
            want = ex(r.fields, r.scalars, r.coeffs)
            err = max(rel_err(out.outputs[k], want[k]) for k in want)
            worst = max(worst, err)
            if err > 1e-4 or out.bucket.bucket != BF16_GRID:
                raise SystemExit(f"mesh_serve {r.grid()}: max rel err "
                                 f"{err:.3e} against its exact grid's "
                                 f"compile (bucket {out.bucket.bucket})")
        key, fb, sb, cb = eng.batch_inputs(reqs)
        bex = eng.executor(key)
        got, launches, nbytes, ex_ms, captured = mesh_run(
            torch, lambda: bex.batched(fb, sb, cb))
        del got
    finally:
        eng.close()
    log(f"mesh_serve: {len(reqs)} pw fused x{SERVE_STEPS} requests on "
        f"the {BF16_GRID} bucket over mesh {shape}: {wall:.3f} s "
        f"({len(reqs) / wall:.2f} req/s), warm compiles "
        f"{eng.stats.compiles - compiles}; every answer vs its exact grid's "
        f"compile max rel err {worst:.3e} (tol 1e-4); the batch of "
        f"{len(reqs)}: launches {launches} ({launches / SERVE_STEPS:g} a "
        f"step), exchange {ex_ms / SERVE_STEPS:.4f} ms and "
        f"{nbytes / SERVE_STEPS / 2**20:.2f} MiB a step ({card})")
    if eng.stats.compiles != compiles:
        raise SystemExit("mesh_serve: a warm request compiled an executor")
    row = mesh_kernel_row("mesh_serve", captured, launches, SERVE_STEPS,
                          1e-4, torch)
    rows.append(row)
    record["rows"]["mesh_serve"] = {
        "requests": len(reqs), "seconds": wall,
        "req_per_s": len(reqs) / wall, "max_rel_err": worst,
        "launches_batch": launches,
        "exchange_ms_per_step": ex_ms / SERVE_STEPS,
        "exchange_bytes_per_step": nbytes / SERVE_STEPS}
    record["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: {record['seconds']:.1f} s")
    return rows, record


def coeff_ring_programs() -> list:
    """``t = cf0<0>; o3 = t[-1,0,0]`` and ``o2 = square(cf0<-1>);
    o3 = square(o2[-2,2,-1])``: regions that read no field, whose temp
    rings a coefficient on axis 2 alone feeds (``in0`` is read by
    nothing; a fused loop sets it to half of ``o3``)."""
    from repro_torch.core import ProgramBuilder
    from repro_torch.core.ir import Access, CoeffRef, UnOp, UnOpKind

    b = ProgramBuilder("coeff_ring", ndim=3, boundary="zero")
    b.inputs("in0")
    cf0 = b.coeff("cf0", axis=2)
    t = b.temp("t")
    b.define(t, cf0[0])
    b.define(b.outputs("o3")[0], t[-1, 0, 0])
    ring = b.build()
    b = ProgramBuilder("coeff_ring_chain", ndim=3, boundary="zero")
    b.inputs("in0")
    b.coeff("cf0", axis=2)
    o2 = b.temp("o2")
    b.define(o2, UnOp(UnOpKind.SQUARE, CoeffRef("cf0", -1)))
    b.define(b.outputs("o3")[0],
             UnOp(UnOpKind.SQUARE, Access("o2", (-2, 2, -1))))
    return [ring, b.build()]


def mesh_coeff_rings(seed, torch, card) -> dict:
    """Each of :func:`coeff_ring_programs` under the stream schedule over
    meshes of ``RING_MESHES`` shards on ``cuda:0`` that cut the stream
    axis, a single step and a fused loop of ``RING_STEPS``, against the
    local stream compile on the card (1e-4 and 1e-5 of its max abs): each
    shard's sweep warms its rings up below its first plane.  Launches are
    counted over the sharded run (one sweep a shard a step)."""
    from repro_torch import compile_program
    from repro_torch.interop import inputs_from_numpy

    def halve(fields, out):
        return {"in0": 0.5 * out["o3"]}

    cases = []          # (program, steps, tol, local, {shards: sharded})
    for p in coeff_ring_programs():
        for steps, tol in ((None, 1e-4), (RING_STEPS, 1e-5)):
            kw = {} if steps is None else dict(steps=steps, update=halve)
            local = compile_program(p, RING_GRID, schedule="stream", **kw)
            sharded = {n: compile_program(p, RING_GRID, schedule="stream",
                                          mesh=card_mesh((n,), ("X",)),
                                          mesh_axes=("X", None, None), **kw)
                       for n in RING_MESHES}
            cases.append((p, steps, tol, local, sharded))
    rec, inputs = {}, {}
    for p, steps, tol, local, sharded in cases:
        if p.name not in inputs:
            f, s, c = make_inputs(p, RING_GRID, seed)
            inputs[p.name] = inputs_from_numpy(f, s, c, "cuda", "float32")
        args = inputs[p.name]
        want = local(*args)
        for n, ex in sharded.items():
            got, launches, _, _, _ = mesh_run(torch, lambda: ex(*args))
            err = max(rel_err(got[k], want[k]) for k in want)
            name = (f"{p.name} mesh ({n},) "
                    f"{f'x{steps}' if steps else 'single'}")
            log(f"coeff rings {name}: {RING_GRID}, stream axis cut in "
                f"{n}, max rel err vs the local stream compile "
                f"{err:.3e} (tol {tol}), {launches} sweep launches "
                f"({card})")
            if err > tol or launches != n * (steps or 1):
                raise SystemExit(f"coeff rings {name}: max rel err "
                                 f"{err:.3e}, {launches} launches")
            rec[name] = {"grid": list(RING_GRID), "shards": n,
                         "steps": steps, "max_rel_err": err,
                         "launches": launches}
            del got
    return rec


def serve_reads_nothing(seed, torch, card) -> dict:
    """``o0 = s0`` (its only group reads no field or coefficient) served
    by ``StencilEngine`` on the card under the block and the stream
    schedule: three requests with their own ``s0`` in one batch (the
    batch taken from the scalar rows), after a warm-up pass, launches
    counted over the measured pass; each answer bit-equal to
    ``compile_program`` of its grid on the card."""
    import numpy as np

    from repro_torch import compile_program
    from repro_torch.core import ProgramBuilder
    from repro_torch.kernels import stencil3d, stream3d
    from repro_torch.serve import StencilEngine, StencilRequest

    b = ProgramBuilder("scalar_only", ndim=3, boundary="zero")
    b.inputs("in0")
    b.define(b.outputs("o0")[0], b.scalars("s0")[0])
    p = b.build()
    rng = np.random.default_rng(seed)
    reqs = [StencilRequest(program=p, fields={"in0": rng.standard_normal(
        NOTHING_SERVE_GRID, dtype=np.float32)}, scalars={"s0": 0.5 + k})
        for k in range(3)]
    scheds = {"block": None, "stream": "stream"}
    engines = {k: StencilEngine(max_batch=SERVE_BATCH,
                                window_s=NOTHING_SERVE_WINDOW_S, schedule=v)
               for k, v in scheds.items()}
    rec = {}
    try:
        # the warm-up: both engines build their executors' kernels while
        # the direct compiles build theirs
        warm = [eng.submit(r) for eng in engines.values() for r in reqs]
        direct = {k: compile_program(p, NOTHING_SERVE_GRID, schedule=v)
                  for k, v in scheds.items()}
        for fut in warm:
            fut.result(600)
        torch.cuda.synchronize()
        for schedule, eng in engines.items():
            stencil3d.launches = stream3d.launches = 0
            res, wall = serve_pass(eng, reqs, torch)
            launched = (stencil3d.launches if schedule == "block"
                        else stream3d.launches)
            rec[schedule] = check_reads_nothing(
                schedule, reqs, res, wall, launched, direct[schedule],
                torch, card)
    finally:
        for eng in engines.values():
            eng.close()
    return rec


def check_reads_nothing(schedule, reqs, res, wall, launched, direct, torch,
                        card) -> dict:
    """A served pass of ``o0 = s0`` held to ``direct`` (its compile on the
    card): bit-equal answers, a batch of two or more, a launch."""
    exact = all(torch.equal(out.outputs["o0"],
                            direct(r.fields, r.scalars)["o0"])
                for r, out in zip(reqs, res))
    batch = max(out.batch_size for out in res)
    log(f"serve reads_nothing ({schedule}): o0 = s0 on "
        f"{NOTHING_SERVE_GRID}, {len(reqs)} requests in {wall:.3f} s, "
        f"largest batch {batch}, {launched} kernel launches, every answer "
        f"bit-equal to compile_program: {exact} ({card})")
    if not exact or launched < 1 or batch < 2:
        raise SystemExit(f"serve reads_nothing ({schedule}): exact {exact},"
                         f" {launched} launches, batch {batch}")
    return {"requests": len(reqs), "seconds": wall, "largest_batch": batch,
            "launches": launched, "bit_equal": exact}


# the port's examples run on the card: (example, arguments beyond its
# defaults, the kernel modules whose launches it must make).  The other six
# (pw_advection, tracer_advection, autotune, distributed_stencil,
# serve_stencils, train_lm) run only in tests/test_torch_examples.py, on
# the CPU: the script's time does not hold them
EXAMPLES = (
    ("quickstart", [], ("stencil3d",)),
    ("stream_schedule", [], ("stream3d",)),
    ("trace_compile", [], ("stencil3d", "stream3d")),
    ("serve_lm", ["--arch", "gemma3_1b"], ("swa",)),
)
# an example's last line (its counterpart in examples/ ends alike)
EXAMPLE_CLOSING = {"stream_schedule": r"\s*stream/P=4/T=4: .* steps/s .*",
                   "trace_compile": r"}"}


def examples_phase(card, torch) -> dict:
    """The examples of :data:`EXAMPLES` on the card at their default sizes,
    one after another in this process, each ``main`` with its standard
    output captured and every kernel count zeroed just before and read
    just after: each must end with its closing line (``... OK``) and
    launch the kernels it names; its seconds (``nvcc`` of the programs it
    compiles included) are logged.  Any failure fails the script."""
    import importlib.util
    import io
    import tempfile

    from repro_torch.kernels import stencil3d, stream3d, swa

    t_phase = time.perf_counter()
    record = {"card": card, "examples": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        extra = {"trace_compile": ["--out", f"{tmp}/TRACE_compile.json"]}
        for name, argv, kernels in EXAMPLES:
            path = ROOT / "examples_torch" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"example_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            stencil3d.launches = stream3d.launches = swa.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv + extra.get(name, []))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {"stencil3d": stencil3d.launches,
                        "stream3d": stream3d.launches, "swa": swa.launches}
            lines = buf.getvalue().rstrip("\n").splitlines()
            closing = lines[-1] if lines else ""
            log(f"example {name} {' '.join(argv)}: {seconds:.1f} s; "
                f"launches {launches}; last line {closing.strip()[:60]!r} "
                f"({card})")
            if not re.fullmatch(EXAMPLE_CLOSING.get(name, rf"{name} OK"),
                                closing):
                raise SystemExit(f"example {name}: last line {closing!r}")
            if sum(launches[k] for k in kernels) < 1:
                raise SystemExit(f"example {name}: no {'/'.join(kernels)} "
                                 "kernel launch")
            record["examples"][name] = {"argv": argv, "seconds": seconds,
                                        "launches": launches}
    record["seconds"] = time.perf_counter() - t_phase
    log(f"examples phase: {record['seconds']:.1f} s")
    return record


def kernel_class(name: str) -> str:
    """A kernel's class by its name: the SWA kernel, its backward, a
    matrix product, or "other"."""
    name = name.lower()
    return ("swa" if "swa_kernel" in name else "swa_bwd"
            if "swa_bwd" in name else "matmul"
            if any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90"))
            else "other")


def device_profile(fn, torch, ranges=None, swa_kernels=None) -> dict:
    """One run of ``fn`` under ``torch.profiler``: host ms (to the final
    synchronise), device ms (the kernels' time summed: one stream, so
    busy time), the idle share, kernel launches, and device ms by kernel
    class (the SWA kernel, its backward, matrix products, the rest) and
    of the eight kernels that took longest.  ``ranges`` ({label: class}):
    a kernel of the rest launched inside a ``record_function(label)``
    range (the op that launched it started inside the range, on the
    range's thread) counts to that class, and each label's device ms and
    host ms are kept apart.  ``swa_kernels``, a running count of the SWA
    kernels launched (read before and after ``fn``): those of ``fn``
    beside the SWA kernel records the profile holds, which a profiler
    that lost records shows (PERF.md, section 7).

    The profile is read from its raw events (``kineto_results``): the
    profiler's own event tree (``events()``, ``key_averages()``) takes
    about 80 µs an event to build in Python, some 30 times as long, which
    for a training step of 10^5 launches is tens of seconds."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ranges or {}
    before = swa_kernels() if swa_kernels else 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = {}      # thread -> [(start ns, end ns, label)] of the ranges
    ops = {}        # correlation id of a CPU op -> (thread, start ns)
    kernels = []    # (name, ns, correlation id of the op that launched it)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in ranges:
                spans.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), name))
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation() and not name.startswith("["):
            # (a range's own device-side annotation is not a kernel, nor
            # is a memory record)
            kernels.append((name, e.duration_ns(),
                            e.linked_correlation_id()))
    for sp in spans.values():
        sp.sort()
    starts = {t: [a for a, _, _ in sp] for t, sp in spans.items()}

    def range_of(corr):
        thread, at = ops.get(corr, (None, 0))
        i = bisect.bisect_right(starts.get(thread, ()), at) - 1
        if i < 0:
            return None
        _, end, label = spans[thread][i]
        return label if at <= end else None

    by = {"swa": 0.0, "swa_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    dev_by = dict.fromkeys(ranges, 0.0)
    per_name, swa_records = {}, 0
    for name, ns, corr in kernels:
        cls = kernel_class(name)
        ms = ns / 1e6
        by[cls] += ms
        swa_records += cls in ("swa", "swa_bwd")
        agg = per_name.setdefault(name, [0.0, 0, cls])
        agg[0] += ms
        agg[1] += 1
        label = range_of(corr) if cls == "other" and spans else None
        if label:
            dev_by[label] += ms
    dev = sum(by.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"host_ms": host_ms, "device_ms": dev,
           "idle_share": max(0.0, 1.0 - dev / host_ms),
           "kernel_launches": len(kernels), "device_ms_by": by,
           "top_kernels": [{"name": torch._C._demangle(n)[:120], "ms": ms,
                            "launches": k, "class": cls}
                           for n, (ms, k, cls) in top]}
    if swa_kernels:
        out.update(swa_kernels=swa_kernels() - before,
                   swa_records=swa_records)
        if swa_records != out["swa_kernels"]:
            log(f"the profiler holds {swa_records} SWA kernel records of "
                f"{out['swa_kernels']} launched: its SWA device ms are "
                "short by the rest")
    if ranges:
        host_by = dict.fromkeys(ranges, 0.0)
        for sp in spans.values():
            for a, b, label in sp:
                host_by[label] += (b - a) / 1e6
        for label, ms in dev_by.items():
            by[ranges[label]] = by.get(ranges[label], 0.0) + ms
            by["other"] -= ms
        out.update(device_ms_by_range=dev_by, host_ms_by_range=host_by)
    return out


def swa_flops(B, S, H, D, w):
    """4·D operations for each (query, key) pair of the band,
    ``sum_i min(i+1, w)`` a row."""
    return 4 * D * sum(min(i + 1, w) for i in range(S)) * B * H


def swa_bound(B, S, H, KV, D, w, dtype):
    """(bound ms, what bounds it): q, k, v and o moved once over 3.35 TB/s,
    against the band's operations over the peak for the dtype (data sheet,
    700 W): bf16 on the tensor cores' 989 TFLOP/s, float32 on the CUDA
    cores' 67 TFLOP/s."""
    import torch

    from repro_torch import hw

    itemsize = 2 if dtype == torch.bfloat16 else 4
    peak = (hw.H100.peak_bf16_flops if dtype == torch.bfloat16
            else hw.H100.peak_f32_flops)
    t_bytes = B * S * (2 * H + 2 * KV) * D * itemsize / hw.H100.hbm_bandwidth
    t_ops = swa_flops(B, S, H, D, w) / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lm_phase(seed, torch, swa):
    """H2O-Danube-1.8B served at full width and depth through
    ``ServeEngine.generate``; the SWA kernels (bf16 and float32) against
    their plain version on the inputs layer 0 gives the bf16 one and at the
    test shapes; prefill against decode at depth 4; times.  Returns (the
    kernels' rows, bf16 then float32; the LM record)."""
    import dataclasses

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels import stencil3d, stream3d
    from repro_torch.models import (ServeEngine, cast_params, decode_step,
                                    init_lm, lm_serve, prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    B, S, new = LM_BATCH, LM_PROMPT, LM_NEW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen)
    eng = ServeEngine(cfg, params, batch=B, max_len=S + new)
    del params
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_params() / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: counts zeroed just before, read just after; the
    # prefill's and the decode steps' launches apart, and layer 0's
    # kernel inputs captured
    counts = {"prefill": [], "decode": []}
    captured = []
    launch = swa.swa_cuda

    by_dtype = {torch.bfloat16: 0, torch.float32: 0}

    def capture(q, k, v, *, window):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), window))
        before = swa.launches
        out = launch(q, k, v, window=window)
        by_dtype[q.dtype] += swa.launches - before
        return out

    def counted(name, fn):
        def run(*a, **kw):
            before = swa.launches
            out = fn(*a, **kw)
            counts[name].append(swa.launches - before)
            return out
        return run

    patched = [(swa, "swa_cuda", capture),
               (lm_serve, "prefill", counted("prefill", lm_serve.prefill)),
               (lm_serve, "decode_step",
                counted("decode", lm_serve.decode_step))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    for m, n, f in patched:
        setattr(m, n, f)
    try:
        stencil3d.launches = stream3d.launches = swa.launches = 0
        t0 = time.perf_counter()
        ids = eng.generate(prompts.cpu().numpy(), new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = swa.launches
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    log(f"generate: ids {ids.shape}, {gen_s:.3f} s; SWA launches {launches}"
        f" (prefill {counts['prefill']}, decode steps "
        f"{sum(counts['decode'])} over {len(counts['decode'])}; bf16 "
        f"{by_dtype[torch.bfloat16]}, float32 {by_dtype[torch.float32]})")
    if ids.shape != (B, new) or not ((ids >= 0) & (ids < cfg.vocab)).all():
        raise SystemExit(f"generate returned bad ids {ids.shape}")
    if counts["prefill"] != [cfg.n_layers] or any(counts["decode"]) \
            or launches != cfg.n_layers \
            or by_dtype[torch.bfloat16] != cfg.n_layers:
        raise SystemExit("the SWA kernel did not run once a layer in the "
                         "prefill and never in decode")
    if eng.stats.prefill_tokens != B * S:
        raise SystemExit(f"stats {eng.stats}")

    # the kernels against their plain version on layer 0's inputs (float32:
    # the same values cast up)
    q, k, v, w = captured[0]
    H, KV, D = q.shape[2], k.shape[2], q.shape[3]
    q32, k32, v32 = q.float(), k.float(), v.float()
    got = swa.swa_cuda(q, k, v, window=w)
    got32 = swa.swa_cuda(q32, k32, v32, window=w)
    plain_ms, want = {}, {}
    for dt, args in ((torch.bfloat16, (q, k, v)), (torch.float32,
                                                    (q32, k32, v32))):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want[dt] = swa.swa_plain(*args, window=w)
        e1.record()
        e1.synchronize()
        plain_ms[dt] = e0.elapsed_time(e1)
    err = float((got.float() - want[torch.bfloat16].float()).abs().max())
    err32 = float((got32 - want[torch.float32]).abs().max())
    rel = rel_err(got, want[torch.bfloat16])
    rel32 = rel_err(got32, want[torch.float32])
    log(f"swa layer 0 {tuple(q.shape)} KV {KV} w {w}: kernel vs plain max "
        f"abs err {err:.3e}, max rel err {rel:.3e} (bf16, tol 2e-2); "
        f"float32 {err32:.3e} abs, {rel32:.3e} rel (tol 2e-5)")
    if rel > 2e-2 or rel32 > 2e-5 or not bool(torch.isfinite(got).all()) \
            or not bool(torch.isfinite(got32).all()):
        raise SystemExit("the SWA kernel disagrees with its plain version")
    del got, got32, want
    # each kernel in turns with the library yardstick, SDPA with the band
    # mask on the same inputs (KV heads repeated, (B, H, S, D) views)
    G = H // KV
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    flops = swa_flops(B, S, H, D, w)
    timed = {}
    for dt, (qq, kk, vv) in ((torch.bfloat16, (q, k, v)),
                             (torch.float32, (q32, k32, v32))):
        qt = qq.transpose(1, 2)
        kt = kk.repeat_interleave(G, 2).transpose(1, 2)
        vt = vv.repeat_interleave(G, 2).transpose(1, 2)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ms, library_ms = time_in_turns([
                lambda: swa.swa_cuda(qq, kk, vv, window=w),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=band)])
        del qt, kt, vt
        bound_ms, bound_by = swa_bound(B, S, H, KV, D, w, dt)
        timed[dt] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, tflops=flops / ms / 1e9,
                         bound_share=bound_ms / ms)
        log(f"swa kernel {dt}: {ms:.4f} ms a call ({flops / ms / 1e9:.1f} "
            f"TFLOP/s on the band, {bound_ms / ms:.1%} of the bound "
            f"{bound_ms:.4f} ms by {bound_by}), plain {plain_ms[dt]:.3f} ms,"
            f" SDPA with the band mask {library_ms:.4f} ms (medians, in "
            f"turns); {by_dtype[dt]} launches a prefill")
    del band, q32, k32, v32

    # end-to-end times of the serving path
    toks = prompts
    prefill_ms = time_ms(lambda: prefill(cfg, eng.params, toks, S + new),
                         reps=3, warmup=1)
    _, cache = prefill(cfg, eng.params, toks, S + new)
    tok = toks[:, -1]
    step = {"pos": S}

    def one_step():
        decode_step(cfg, eng.params, cache, tok, step["pos"])
        step["pos"] += 1

    decode_ms = time_ms(one_step, inner=4, reps=3, warmup=1)
    prof = {"prefill": device_profile(
        lambda: prefill(cfg, eng.params, toks, S + new), torch,
        swa_kernels=lambda: swa.launches),
        "decode_step": device_profile(one_step, torch,
                                      swa_kernels=lambda: swa.launches)}
    del cache
    log(f"prefill {B}x{S}: {prefill_ms:.2f} ms ({B * S / prefill_ms * 1e3:.0f}"
        f" tokens/s); decode {decode_ms:.3f} ms a step "
        f"({B / decode_ms * 1e3:.1f} tokens/s); generate {new} tokens "
        f"{gen_s * 1e3:.1f} ms")
    for k, pr in prof.items():
        log(f"profile {k}: host {pr['host_ms']:.2f} ms, device "
            f"{pr['device_ms']:.2f} ms (idle {pr['idle_share']:.1%}), "
            f"{pr['kernel_launches']} kernel launches; device ms: "
            + ", ".join(f"{c} {v:.2f}" for c, v in pr["device_ms_by"].items()))

    # prefill (the kernel) against prefill + teacher-forced decode (the
    # ring cache) at a depth of LM_E2E_DEPTH, full width
    cfg4 = dataclasses.replace(cfg, n_layers=LM_E2E_DEPTH)
    p4 = cast_params(init_lm(cfg4, gen), torch.bfloat16)
    full, _ = prefill(cfg4, p4, toks, S)
    swa.launches = 0
    part, cache = prefill(cfg4, p4, toks[:, :LM_E2E_SPLIT], S)
    pre_launches = swa.launches
    for t in range(LM_E2E_SPLIT, S):
        part, cache = decode_step(cfg4, p4, cache, toks[:, t], t)
    torch.cuda.synchronize()
    dec_launches = swa.launches - pre_launches
    e2e = rel_err(part, full)
    log(f"depth {LM_E2E_DEPTH}: prefill {S} vs prefill {LM_E2E_SPLIT} + "
        f"{S - LM_E2E_SPLIT} decode steps, last-position logits max rel err "
        f"{e2e:.3e} (tol 2e-2); kernel launches {pre_launches} + "
        f"{dec_launches}")
    if e2e > 2e-2 or pre_launches != LM_E2E_DEPTH or dec_launches \
            or not bool(torch.isfinite(full).all()):
        raise SystemExit("prefill and decode disagree at depth "
                         f"{LM_E2E_DEPTH}")
    del p4, cache

    # the kernel at the test shapes
    shapes = []
    rng = torch.Generator(device="cuda").manual_seed(seed + 1)
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        for (b, s, h, kv, d, ww) in SWA_SHAPES:
            qq, kk, vv = (torch.randn((b, s, hh, d), generator=rng,
                                      device="cuda").to(getattr(torch, dt))
                          for hh in (h, kv, kv))
            r = rel_err(swa.swa_cuda(qq, kk, vv, window=ww),
                        swa.swa_plain(qq, kk, vv, window=ww,
                                      q_block=128 if s % 128 == 0 else s))
            shapes.append({"shape": [b, s, h, kv, d], "window": ww,
                           "dtype": dt, "max_rel_err": r})
            if r > tol:
                raise SystemExit(f"swa kernel {dt} {(b, s, h, kv, d, ww)}: "
                                 f"max rel err {r:.3e} > {tol}")
    log(f"swa kernel at {len(shapes)} test shapes: worst max rel err "
        f"{max(x['max_rel_err'] for x in shapes):.3e}")

    rows = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        t = timed[dt]
        rows.append({
            "name": f"swa.swa_cuda[{cfg.name} prefill B{B} S{S} H{H} KV{KV} "
                    f"D{D} w{w} {tag}]",
            "route": "cuda",
            "source": str(swa.SOURCES[dt].relative_to(ROOT)),
            "replaces": swa.REPLACES,
            "launches": by_dtype[dt],
            "max_abs_err": err if dt == torch.bfloat16 else err32,
            "ms": t["ms"],
            "plain_ms": plain_ms[dt],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "max_rel_err": rel if dt == torch.bfloat16 else rel32,
            "tflops": t["tflops"],
            "bound_share": t["bound_share"],
            "on_serving_path": by_dtype[dt] > 0,
            "smem_bytes": swa.smem_bytes(dt, D),
        })
    record = {"arch": LM_ARCH, "batch": B, "prompt": S, "new_tokens": new,
              "generate_s": gen_s, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_ms,
              "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
              "decode_tokens_per_s": B / decode_ms * 1e3,
              "launches_prefill": counts["prefill"],
              "launches_decode": sum(counts["decode"]),
              "profile": prof,
              "e2e_depth": LM_E2E_DEPTH, "e2e_max_rel_err": e2e,
              "swa_shapes": shapes}
    return rows, record


def families_phase(seed, torch, swa, swa_ptxas):
    """The MoE, hybrid and xLSTM families served through
    ``ServeEngine.generate`` (``FAMILY_RUNS``), each at full width, with
    the SWA kernel held against its plain version on the inputs its first
    local layer hands it, the MoE against a plain per-expert loop and each
    recurrent cell against its CPU float32 result, and prefill against
    prefill plus decode.  Returns (the SWA kernel's rows, the record)."""
    rows, record = [], {}
    for arch, depth, prompt, e2e_prompt, prof_prompt in FAMILY_RUNS:
        row, record[arch] = serve_family(arch, depth, prompt, e2e_prompt,
                                         prof_prompt,
                                         seed, torch, swa, swa_ptxas)
        rows += [row] if row else []
        torch.cuda.empty_cache()
    return rows, record


def serve_family(arch, depth, S, e2e_prompt, prof_prompt, seed, torch, swa,
                 swa_ptxas):
    """One family's serving path at full width (depth cut to ``depth``
    where given): the main path with its counts, times, a prefill of
    ``prof_prompt`` tokens and a decode step profiled, and the checks.
    Returns (its SWA row or None, its record)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (ServeEngine, decode_step, init_lm,
                                    lm_serve, prefill, ssm, transformer)

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    full_depth = cfg.n_layers
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    B, new = LM_BATCH, LM_NEW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, gen)
    eng = ServeEngine(cfg, params, batch=B, max_len=S + new)
    del params
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.params.parameters())
    log(f"{cfg.name}: {cfg.n_layers} of {full_depth} layers, d "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params served in "
        f"{cfg.dtype}, built in {time.perf_counter() - t_phase:.1f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    local = ([i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "local"]
             if cfg.window and S > cfg.window and not cfg.attn_softcap
             else [])

    # the main path: counts zeroed just before and read just after; the
    # first call's inputs of the SWA kernel and of each cell captured;
    # each module's work in a profiler range
    counts = {"prefill": [], "decode": []}
    captured, moe_calls = {}, []
    plain = {"swa_cuda": swa.swa_cuda, "moe_apply": transformer.moe_apply,
             "mamba_apply": ssm.mamba_apply, "mlstm_apply": ssm.mlstm_apply,
             "slstm_apply": ssm.slstm_apply}

    def capture_swa(q, k, v, *, window):
        if "swa" not in captured:
            captured["swa"] = (q.clone(), k.clone(), v.clone(), window)
        return plain["swa_cuda"](q, k, v, window=window)

    def ranged(name, label):
        def run(p, x, *a, **kw):
            if label not in captured:
                captured[label] = (p, x.clone())
            with torch.profiler.record_function(label):
                if label != "moe":
                    return plain[name](p, x, *a, **kw)
                stats = {}
                out = plain[name](p, x, *a, stats=stats, **kw)
                moe_calls.append((x.shape[1], stats["dropped"]))
                return out
        return run

    def counted(name, fn):
        def run(*a, **kw):
            before = swa.launches
            out = fn(*a, **kw)
            counts[name].append(swa.launches - before)
            return out
        return run

    patched = [(swa, "swa_cuda", capture_swa),
               (lm_serve, "prefill", counted("prefill", lm_serve.prefill)),
               (lm_serve, "decode_step",
                counted("decode", lm_serve.decode_step)),
               (transformer, "moe_apply", ranged("moe_apply", "moe"))]
    patched += [(ssm, f"{c}_apply", ranged(f"{c}_apply", c))
                for c in ("mamba", "mlstm", "slstm")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    for m, n, f in patched:
        setattr(m, n, f)
    try:
        torch.cuda.reset_peak_memory_stats()
        swa.launches = 0
        t0 = time.perf_counter()
        ids = eng.generate(prompts.cpu().numpy(), new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = swa.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dropped = [int(d) for s, d in moe_calls if s > 1]
        log(f"{arch} generate: ids {ids.shape}, {gen_s:.3f} s, peak "
            f"{peak_gb:.2f} GB; SWA launches {launches} (prefill "
            f"{counts['prefill']}, decode steps {sum(counts['decode'])} "
            f"over {len(counts['decode'])})"
            + (f"; MoE assignments dropped a layer at capacity factor "
               f"{cfg.capacity_factor}: {dropped} of "
               f"{B * S * cfg.top_k}" if cfg.n_experts else ""))
        if ids.shape != (B, new) or not ((ids >= 0)
                                         & (ids < cfg.vocab)).all():
            raise SystemExit(f"{arch}: generate returned bad ids")
        if counts["prefill"] != [len(local)] or any(counts["decode"]) \
                or launches != len(local):
            raise SystemExit(f"{arch}: the SWA kernel did not run once a "
                             "local layer in the prefill and never in "
                             "decode")
        if cfg.n_experts and len(dropped) != cfg.n_layers:
            raise SystemExit(f"{arch}: {len(dropped)} MoE prefill calls")

        # end-to-end times (generate's prefill was the warm-up) and one
        # profiled prefill and decode step
        toks = prompts
        last = {}

        def timed_prefill():
            last["cache"] = prefill(cfg, eng.params, toks, S + 64)[1]

        prefill_ms = time_ms(timed_prefill, reps=3, warmup=0)
        cache = last.pop("cache")          # the last timed prefill's
        step = {"pos": S}
        tok = toks[:, -1]

        def one_step():
            decode_step(cfg, eng.params, cache, tok, step["pos"])
            step["pos"] += 1

        decode_ms = time_ms(one_step, inner=4, reps=3, warmup=1)
        ptoks = toks[:, :prof_prompt]
        prof = {"prefill": device_profile(
            lambda: prefill(cfg, eng.params, ptoks, S + 64), torch,
            FAMILY_RANGES, lambda: swa.launches),
            "decode_step": device_profile(one_step, torch, FAMILY_RANGES,
                                          lambda: swa.launches)}
        del cache
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    log(f"{arch} prefill {B}x{S}: {prefill_ms:.2f} ms "
        f"({B * S / prefill_ms * 1e3:.0f} tokens/s); decode "
        f"{decode_ms:.3f} ms a step ({B / decode_ms * 1e3:.1f} tokens/s)")
    for k, pr in prof.items():
        shape = f" ({B}x{prof_prompt})" if k == "prefill" else ""
        log(f"{arch} profile {k}{shape}: host {pr['host_ms']:.2f} ms, "
            f"device {pr['device_ms']:.2f} ms (idle {pr['idle_share']:.1%}), "
            f"{pr['kernel_launches']} kernel launches; device ms: "
            + ", ".join(f"{'elementwise' if c == 'other' else c} {v:.2f}"
                        for c, v in pr["device_ms_by"].items())
            + "; host ms in ranges: "
            + ", ".join(f"{c} {v:.1f}" for c, v in
                        pr["host_ms_by_range"].items() if v))

    record = {"arch": arch, "depth": cfg.n_layers, "full_depth": full_depth,
              "params": n_params,
              "batch": B, "prompt": S, "new_tokens": new,
              "profiled_prompt": prof_prompt,
              "generate_s": gen_s, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_ms,
              "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
              "decode_tokens_per_s": B / decode_ms * 1e3,
              "peak_memory_gb": peak_gb, "local_layers": len(local),
              "launches_prefill": counts["prefill"],
              "launches_decode": sum(counts["decode"]), "profile": prof}
    if cfg.n_experts:
        record["moe_dropped_per_layer"] = dropped
        record["moe_assignments_per_layer"] = B * S * cfg.top_k
        record["moe_check"] = moe_check(cfg, *captured["moe"], torch)
    for cell in ("mamba", "mlstm", "slstm"):
        if cell in captured:
            record[f"{cell}_check"] = cell_check(
                cell, plain[f"{cell}_apply"], *captured[cell], torch)
    row = None
    if "swa" in captured:
        row = family_swa_row(cfg, captured.pop("swa"), len(local), swa,
                             swa_ptxas, torch)
    del eng, captured, prompts
    torch.cuda.empty_cache()
    record["e2e"] = family_e2e(cfg, seed, e2e_prompt, torch, swa)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"{arch}: {record['seconds']:.1f} s in all")
    return row, record


def whisper_phase(seed, torch) -> dict:
    """whisper-small served on the card at full width and depth: float32
    masters from ``--seed`` cast once to a bf16 copy; WHISPER_BATCH
    utterances of precomputed frames (numpy, from ``--seed``), a prompt of
    WHISPER_PROMPT tokens, then WHISPER_NEW greedy tokens through
    ``whisper_prefill`` and ``whisper_decode_step`` (plain PyTorch: no
    hand-written kernel is on this path).  Logs encode, prefill and decode
    ms, tokens/s, peak memory and one profiled decode step.  Raises unless:
    no greedy id is past the vocabulary; the teacher-forced decode's
    logits equal ``whisper_forward``'s on the same tokens at 2e-2; and, at
    depth 2 + 2, the card's bf16 logits equal the CPU's float32 ones at
    2e-2 (each relative to the compared logits' max abs)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import cast_params
    from repro_torch.models.whisper import (encode, init_whisper,
                                            whisper_decode_step,
                                            whisper_forward, whisper_prefill)

    t_phase = time.perf_counter()
    cfg = get_config("whisper_small")
    B, P, new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    served = cast_params(init_whisper(cfg, gen), torch.bfloat16)
    rng = np.random.default_rng(seed)
    frames_np = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                    dtype=np.float32)
    prompt_np = rng.integers(0, cfg.vocab, (B, P))
    frames = torch.as_tensor(frames_np, device="cuda")
    prompt = torch.as_tensor(prompt_np, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in served.parameters())
    log(f"{cfg.name}: {cfg.n_enc_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), "
        f"{n_params / 1e6:.1f} M params served in bfloat16, {B} x "
        f"{cfg.enc_seq} frames, prompt {P}, {new} new tokens, max_len "
        f"{WHISPER_MAX_LEN}")

    # the main path: prefill, then greedy decode steps
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = whisper_prefill(cfg, served, frames, prompt,
                                        WHISPER_MAX_LEN)
        steps, ids = [logits], [logits.argmax(-1)]
        for i in range(new - 1):
            logits, cache = whisper_decode_step(cfg, served, cache, ids[-1],
                                                P + i)
            steps.append(logits)
            ids.append(logits.argmax(-1))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ids = torch.stack(ids, 1)
    steps = torch.stack(steps, 1)
    past_vocab = int((ids >= cfg.vocab).sum())
    log(f"whisper generate: ids {tuple(ids.shape)}, {gen_s:.3f} s, peak "
        f"{peak_gb:.2f} GB; greedy ids >= vocab {cfg.vocab}: {past_vocab}")
    if past_vocab or not bool(torch.isfinite(steps[..., :cfg.vocab]).all()):
        raise SystemExit(f"whisper: {past_vocab} greedy ids past the "
                         "vocabulary, or logits not finite")

    # teacher-forced: the decode's logits against the forward's on the
    # prompt and the greedy ids
    with torch.inference_mode():
        full = whisper_forward(cfg, served, frames,
                               torch.cat([prompt, ids[:, :-1]], 1))
    tf_err = rel_err(steps[..., :cfg.vocab],
                     full[:, P - 1:, :cfg.vocab])
    log(f"whisper teacher-forced decode vs whisper_forward ({B} x "
        f"{P + new - 1} tokens): rel err {tf_err:.3e} (tol 2e-2)")
    if not tf_err <= 2e-2:
        raise SystemExit(f"whisper: the decode departs from the forward, "
                         f"{tf_err:.3e}")

    # end-to-end times and one profiled decode step
    with torch.inference_mode():
        encode_ms = time_ms(lambda: encode(cfg, served, frames), reps=3,
                            warmup=1)
        prefill_ms = time_ms(lambda: whisper_prefill(
            cfg, served, frames, prompt, WHISPER_MAX_LEN), reps=3, warmup=1)
        _, cache = whisper_prefill(cfg, served, frames, prompt,
                                   WHISPER_MAX_LEN)
        step = {"pos": P}
        tok = prompt[:, -1]

        def one_step():
            whisper_decode_step(cfg, served, cache, tok, step["pos"])
            step["pos"] += 1

        decode_ms = time_ms(one_step, inner=4, reps=3, warmup=1)
        prof = device_profile(one_step, torch)
    del cache, full, steps, served
    torch.cuda.empty_cache()
    log(f"whisper encode {B}x{cfg.enc_seq}: {encode_ms:.2f} ms; prefill "
        f"(encode + {P} tokens): {prefill_ms:.2f} ms; decode "
        f"{decode_ms:.3f} ms a step ({B / decode_ms * 1e3:.1f} tokens/s)")
    log(f"whisper peak memory: {peak_gb:.2f} GB")
    log(f"whisper profile decode step: host {prof['host_ms']:.2f} ms, "
        f"device {prof['device_ms']:.3f} ms (idle {prof['idle_share']:.1%}), "
        f"{prof['kernel_launches']} kernel launches; device ms: "
        + ", ".join(f"{c} {v:.3f}" for c, v in prof["device_ms_by"].items()))

    # depth 2 + 2, full width: the card's bf16 logits against the CPU's
    # float32 ones, the same masters
    small = dataclasses.replace(cfg, n_layers=WHISPER_CHECK_DEPTH,
                                n_enc_layers=WHISPER_CHECK_DEPTH)
    masters = init_whisper(small, gen)
    b = WHISPER_CHECK_BATCH
    toks = torch.cat([prompt, ids[:, :-1]], 1)[:b]
    with torch.inference_mode():
        card = whisper_forward(small, cast_params(masters, torch.bfloat16),
                               frames[:b], toks)
        cpu = whisper_forward(dataclasses.replace(small, dtype="float32"),
                              masters.to("cpu"), frames[:b].cpu(),
                              toks.cpu())
    cpu_err = rel_err(card[..., :cfg.vocab].cpu(), cpu[..., :cfg.vocab])
    log(f"whisper depth {WHISPER_CHECK_DEPTH}+{WHISPER_CHECK_DEPTH} card "
        f"bf16 vs CPU float32 logits ({b} x {toks.shape[1]} tokens): rel "
        f"err {cpu_err:.3e} (tol 2e-2)")
    if not cpu_err <= 2e-2:
        raise SystemExit(f"whisper: the card departs from the CPU, "
                         f"{cpu_err:.3e}")
    del masters, card, cpu
    torch.cuda.empty_cache()
    record = {"arch": "whisper_small", "params": n_params, "batch": B,
              "frames": cfg.enc_seq, "prompt": P, "new_tokens": new,
              "max_len": WHISPER_MAX_LEN, "generate_s": gen_s,
              "encode_ms": encode_ms, "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_ms,
              "decode_tokens_per_s": B / decode_ms * 1e3,
              "peak_memory_gb": peak_gb, "ids_past_vocab": past_vocab,
              "teacher_forced_rel_err": tf_err, "cpu_rel_err": cpu_err,
              "profile_decode_step": prof,
              "seconds": time.perf_counter() - t_phase}
    log(f"whisper: {record['seconds']:.1f} s in all")
    return record


def moe_check(cfg, p, x, torch) -> dict:
    """The card's ``moe_apply`` on layer 0's bf16 input against a plain
    loop over the experts on the same input and the same top-k choices,
    with the same assignments dropped (each expert keeps its first
    ``cap`` in token-major order), at 2e-2 of the output's max abs."""
    from repro_torch.models.layers import _ACTS, moe_apply

    stats = {}
    y, _ = moe_apply(p, x, cfg.top_k, cfg.act, cfg.capacity_factor,
                     stats=stats)
    B, S, D = x.shape
    T, k = B * S, cfg.top_k
    xf = x.reshape(T, D)
    probs = torch.softmax(xf.float() @ p.router.float(), -1)
    top_i = stats["top_i"]
    top_p = probs.gather(1, top_i)
    top_p = (top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)).reshape(-1)
    cap = max(int(cfg.capacity_factor * T * k / cfg.n_experts), 1)
    want = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    eid = top_i.reshape(-1)
    kept = 0
    for e in range(cfg.n_experts):
        idx = torch.nonzero(eid == e)[:cap, 0]          # token-major
        kept += idx.numel()
        t = idx // k
        h = xf[t] @ p.w_in[e]
        g = xf[t] @ p.w_gate[e] if hasattr(p, "w_gate") else None
        h = _ACTS[cfg.act](h) if g is None else _ACTS[cfg.act](g) * h
        want.index_add_(0, t, (h @ p.w_out[e]).float() * top_p[idx, None])
    want = want.to(x.dtype).reshape(B, S, D)
    err = rel_err(y, want)
    dropped = int(stats["dropped"])
    log(f"moe_apply {tuple(x.shape)} E {cfg.n_experts} top-{k} cap {cap}: "
        f"vs the per-expert loop max rel err {err:.3e} (tol 2e-2); "
        f"{dropped} of {T * k} assignments dropped")
    if err > 2e-2 or dropped != T * k - kept \
            or not bool(torch.isfinite(y).all()):
        raise SystemExit("moe_apply disagrees with the per-expert loop")
    return {"max_rel_err": err, "dropped": dropped, "capacity": cap}


def cell_check(cell, apply, p, x, torch) -> dict:
    """The card's (bf16) ``<cell>_apply`` on the first ``FAMILY_MODULE_SEQ``
    tokens of its layer's input against its CPU float32 result (the same
    bf16 weights and input, cast up): the output and each state at 2e-2
    of its max abs; and its decode form on the card, FAMILY_STEPS tokens
    one at a time from that state, against one call over all of them."""
    import copy

    n, m = FAMILY_MODULE_SEQ, FAMILY_STEPS
    xs = x[:, :n]
    y, state = apply(p, xs)
    p32 = copy.deepcopy(p).to("cpu", torch.float32)
    y32, state32 = apply(p32, xs.float().cpu())
    errs = [rel_err(y.cpu(), y32)] + [rel_err(a.cpu(), b)
                                      for a, b in zip(state, state32)]
    whole, _ = apply(p, x[:, :n + m])
    steps = []
    for t in range(n, n + m):
        out, state = apply(p, x[:, t:t + 1], state)
        steps.append(out)
    step_err = rel_err(torch.cat(steps, 1), whole[:, n:])
    log(f"{cell}_apply {tuple(xs.shape)} bf16 on the card vs float32 on "
        f"the CPU: max rel err output {errs[0]:.3e}, states "
        + ", ".join(f"{e:.3e}" for e in errs[1:]) + f"; {m} decode steps "
        f"vs one call {step_err:.3e} (tol 2e-2)")
    if max(errs + [step_err]) > 2e-2 or not bool(torch.isfinite(y).all()):
        raise SystemExit(f"{cell}_apply on the card disagrees with the CPU "
                         "or with its decode form")
    return {"seq": n, "max_rel_err": errs[0], "state_max_rel_err": errs[1:],
            "decode_steps": m, "decode_vs_call_max_rel_err": step_err}


def family_swa_row(cfg, captured, launches, swa, swa_ptxas, torch) -> dict:
    """The bf16 SWA kernel on the inputs the first local layer hands it:
    against ``swa_plain`` at 2e-2, timed in turns with SDPA with the band
    mask, its bound, and ptxas's registers and spills at its head dim."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, w = captured
    B, S, H, D = q.shape
    KV = k.shape[2]
    got = swa.swa_cuda(q, k, v, window=w)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = swa.swa_plain(q, k, v, window=w)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    err = float((got.float() - want.float()).abs().max())
    rel = rel_err(got, want)
    del got, want
    G = H // KV
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, 2).transpose(1, 2)
    vt = v.repeat_interleave(G, 2).transpose(1, 2)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        ms, library_ms = time_in_turns([
            lambda: swa.swa_cuda(q, k, v, window=w),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=band)])
    del qt, kt, vt, band
    bound_ms, bound_by = swa_bound(B, S, H, KV, D, w, q.dtype)
    flops = swa_flops(B, S, H, D, w)
    ptx = next(st for st in swa_ptxas
               if st["dtype"] == "bfloat16" and st["d"] == D)
    log(f"swa {cfg.name} first local layer {tuple(q.shape)} KV {KV} (group "
        f"{G}) w {w}: kernel vs plain max abs err {err:.3e}, max rel err "
        f"{rel:.3e} (bf16, tol 2e-2); {ms:.4f} ms a call "
        f"({flops / ms / 1e9:.1f} TFLOP/s on the band, {bound_ms / ms:.1%} "
        f"of the bound {bound_ms:.4f} ms by {bound_by}), plain "
        f"{plain_ms:.3f} ms, SDPA with the band mask {library_ms:.4f} ms "
        f"(in turns); ptxas {ptx['registers']} registers, spill stores "
        f"{ptx['spill_stores']} B, loads {ptx['spill_loads']} B; {launches} "
        "launches a prefill")
    if rel > 2e-2:
        raise SystemExit(f"the SWA kernel disagrees with its plain version "
                         f"at {cfg.name}'s shape")
    return {
        "name": f"swa.swa_cuda[{cfg.name} prefill B{B} S{S} H{H} KV{KV} "
                f"D{D} w{w} bf16]",
        "route": "cuda",
        "source": str(swa.SOURCES[q.dtype].relative_to(ROOT)),
        "replaces": swa.REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "max_rel_err": rel,
        "tflops": flops / ms / 1e9, "bound_share": bound_ms / ms,
        "on_serving_path": launches > 0,
        "smem_bytes": swa.smem_bytes(q.dtype, D),
        "registers": ptx["registers"], "spill_stores": ptx["spill_stores"],
        "spill_loads": ptx["spill_loads"]}


def family_e2e(cfg, seed, S, torch, swa) -> dict:
    """At depth FAMILY_E2E_DEPTH, full width, bf16: the last-position
    logits (the real vocabulary) of an S-token prefill against a prefill
    of S - FAMILY_E2E_TAIL tokens and FAMILY_E2E_TAIL decode steps, at
    2e-2; the MoE at capacity factor FAMILY_E2E_CF, so that the prefill
    drops none of what decode keeps."""
    import dataclasses

    from repro_torch.models import cast_params, decode_step, init_lm, prefill

    depth = FAMILY_E2E_DEPTH
    cfg2 = dataclasses.replace(cfg, n_layers=depth, capacity_factor=(
        FAMILY_E2E_CF if cfg.n_experts else cfg.capacity_factor))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, S), generator=gen,
                         device="cuda")
    p2 = cast_params(init_lm(cfg2, gen), torch.bfloat16)
    full, _ = prefill(cfg2, p2, toks, S)
    swa.launches = 0
    split = S - FAMILY_E2E_TAIL
    part, cache = prefill(cfg2, p2, toks[:, :split], S)
    pre = swa.launches
    for t in range(split, S):
        part, cache = decode_step(cfg2, p2, cache, toks[:, t], t)
    torch.cuda.synchronize()
    dec = swa.launches - pre
    err = rel_err(part[:, :cfg.vocab], full[:, :cfg.vocab])
    local = sum(cfg2.layer_kind(i) == "local" for i in range(depth)) \
        if cfg2.window and split > cfg2.window else 0
    log(f"{cfg.name} depth {depth}: prefill {S} vs prefill {split} + "
        f"{FAMILY_E2E_TAIL} decode steps, last-position logits max rel err "
        f"{err:.3e} (tol 2e-2); SWA launches {pre} + {dec}")
    if err > 2e-2 or pre != local or dec \
            or not bool(torch.isfinite(full).all()):
        raise SystemExit(f"{cfg.name}: prefill and decode disagree at "
                         f"depth {depth}")
    del p2, cache
    return {"depth": depth, "split": split, "max_rel_err": err,
            "capacity_factor": cfg2.capacity_factor,
            "launches_prefill": pre, "launches_decode": dec}


def swa_backward_bound(B, S, H, KV, D, w, dtype):
    """(bound ms, what bounds it) of the SWA gradient: q, k, v, o and dout
    read and dq, dk, dv written once over 3.35 TB/s, against the
    gradient's five products over the band (10·D operations a pair, 2.5
    times the forward's 4·D) over the peak for the dtype (data sheet,
    700 W)."""
    import torch

    from repro_torch import hw

    itemsize = 2 if dtype == torch.bfloat16 else 4
    peak = (hw.H100.peak_bf16_flops if dtype == torch.bfloat16
            else hw.H100.peak_f32_flops)
    t_bytes = B * S * (4 * H + 4 * KV) * D * itemsize / hw.H100.hbm_bandwidth
    t_ops = 2.5 * swa_flops(B, S, H, D, w) / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def swa_pair_check(torch, swa, q, k, v, do, w, label, launches, where,
                   flags) -> tuple:
    """The bf16 SWA forward with its log-sum-exp (``swa_cuda_lse``) and its
    backward (``swa_cuda_backward``) on q, k, v and the cotangent ``do``:
    the output and each gradient against ``swa_plain`` and
    ``swa_plain_backward`` at 2e-2 of its max abs, the lse against
    ``swa_plain_lse`` at 1e-4; each call timed in turns with SDPA with the
    band mask (the backward: autograd through it), and its plain version
    once.  ``launches`` ({"forward", "backward"}: the main path's counts,
    made ``where``) and ``flags`` go into the two rows, named from
    ``label``.  Returns (the rows, a record)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, S, H, D = q.shape
    KV = k.shape[2]
    o, lse = swa.swa_cuda_lse(q, k, v, window=w)
    got = (o,) + swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
    torch.cuda.synchronize()
    lse_err = rel_err(lse, swa.swa_plain_lse(q, k, window=w))
    want, plain_ms = (), {}
    for name, fn in (("forward", lambda: (swa.swa_plain(q, k, v, window=w),)),
                     ("backward", lambda: swa.swa_plain_backward(
                         q, k, v, do, window=w))):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want += tuple(fn())
        e1.record()
        e1.synchronize()
        plain_ms[name] = e0.elapsed_time(e1)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    abs_errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
    log(f"{label} SWA {(B, S, H, KV, D)} (group {H // KV}) w {w} bf16: "
        f"kernel vs plain max rel err out {errs[0]:.3e}, dq {errs[1]:.3e}, "
        f"dk {errs[2]:.3e}, dv {errs[3]:.3e} (tol 2e-2); lse "
        f"{lse_err:.3e} (tol 1e-4)")
    if max(errs) > 2e-2 or lse_err > 1e-4 or not all(
            bool(torch.isfinite(t.float()).all()) for t in got + (lse,)):
        raise SystemExit(f"{label}: the SWA kernels disagree with their "
                         "plain versions")
    del got, want
    G = H // KV
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous(
        ).requires_grad_(True)
    vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous(
        ).requires_grad_(True)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        fwd_ms, fwd_lib = time_in_turns([
            lambda: swa.swa_cuda_lse(q, k, v, window=w),
            lambda: F.scaled_dot_product_attention(
                qt.detach(), kt.detach(), vt.detach(), attn_mask=band)],
            reps=3)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
    dot = do.transpose(1, 2)
    bwd_ms, bwd_lib = time_in_turns([
        lambda: swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse),
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True)], reps=3)
    rows = []
    for part, ms, lib, (bound_ms, bound_by), err, src, fn in (
            ("forward", fwd_ms, fwd_lib, swa_bound(B, S, H, KV, D, w,
                                                   q.dtype),
             abs_errs[0], swa.SOURCES[q.dtype], "swa_cuda_lse"),
            ("backward", bwd_ms, bwd_lib, swa_backward_bound(
                B, S, H, KV, D, w, q.dtype), max(abs_errs[1:]),
             swa.BACKWARD_SOURCES[q.dtype], "swa_cuda_backward")):
        log(f"{label} swa {part}: {ms:.4f} ms a call (bound "
            f"{bound_ms:.4f} ms by {bound_by}), plain "
            f"{plain_ms[part]:.3f} ms, SDPA {lib:.4f} ms (medians, in "
            f"turns); {launches[part]} launches in {where}")
        rows.append({
            "name": f"swa.{fn}[{label} B{B} S{S} H{H} KV{KV} D{D} w{w} "
                    "bf16]",
            "route": "cuda", "source": str(src.relative_to(ROOT)),
            "replaces": swa.REPLACES, "launches": launches[part],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms[part],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "backward_of_replaces": part == "backward", **flags})
    del o, lse, qt, kt, vt, out, dot, band
    return rows, {"shape": [B, S, H, KV, D], "window": w,
                  "max_rel_err": errs, "lse_rel_err": lse_err, "rows": rows}


def backward_parts(torch, swa, args, w, abs_err, shape, seed) -> list:
    """The bf16 backward's two kernels apart: each one's device time under
    ``torch.profiler`` over three calls, in a process of its own
    (:func:`backward_parts_child`, on the same inputs from ``seed``), its
    plain version's time (autograd through ``swa_plain`` for dq alone,
    then for dk and dv), and its bound: dq's three band products (S, dP,
    dQ: 6·D a pair) and dk/dv's four (S^T, dP^T, dV, dK: 8·D a pair) over
    989 TFLOP/s, against the bytes each moves once (dq: q, k, v, o, dout,
    lse in, dq and D out; dk/dv: q, k, v, dout, lse and D in, dk and dv
    out) over 3.35 TB/s."""
    from repro_torch import hw

    q, k, v, o, do, lse = args
    B, S, H, KV, D = shape
    # a process that has used the card for a minute or more loses this
    # library's kernel records from a short profile (PERF.md, section 7);
    # a fresh one has kept them in every session tried
    spec = {"seed": seed, "shape": list(shape), "window": w}
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--backward-parts", json.dumps(spec)],
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise SystemExit(f"the backward's profile failed: {run.stderr}")
    dev = json.loads(run.stdout.strip().splitlines()[-1])
    if not all(dev.values()):
        raise SystemExit(f"the profiler saw no bf16 backward kernel: {dev}")
    plain = {}
    for part, wrt in (("dq", (0,)), ("dkdv", (1, 2))):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        with torch.enable_grad():
            out = swa.swa_plain(*leaves, window=w)
            torch.autograd.grad(out, [leaves[i] for i in wrt], do)
        e1.record()
        e1.synchronize()
        plain[part] = e0.elapsed_time(e1)
        del leaves, out
    pairs = swa_flops(B, S, H, D, w) / (4 * D)
    rows = []
    for part, per_pair, moved in (
            ("dq", 6 * D, B * S * (2 * (4 * H + 2 * KV) * D + 8 * H)),
            ("dkdv", 8 * D, B * S * (2 * (2 * H + 4 * KV) * D + 8 * H))):
        t_ops = pairs * per_pair / hw.H100.peak_bf16_flops
        t_bytes = moved / hw.H100.hbm_bandwidth
        rows.append({"kernel": part, "ms": dev[part],
                     "plain_ms": plain[part],
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "max_abs_err": abs_err[part]})
        log(f"swa_bwd_mma_{part}: {dev[part]:.4f} ms a call (profiler), "
            f"bound {rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}"
            f", plain {plain[part]:.3f} ms")
    return rows


def backward_parts_child(spec: dict) -> dict:
    """Device ms a call of each bf16 backward kernel, over three calls
    under ``torch.profiler``, on the train phase's layer-0 inputs made
    from ``spec["seed"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import swa

    B, S, H, KV, D = spec["shape"]
    w = spec["window"]
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((B, S, H, D), (B, S, KV, D),
                                      (B, S, KV, D), (B, S, H, D)))
    o, lse = swa.swa_cuda_lse(q, k, v, window=w)
    swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
        torch.cuda.synchronize()
    dev = {"dq": 0.0, "dkdv": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if "swa_bwd_mma_dkdv" in e.key:
            dev["dkdv"] += us / 1e3 / 3
        elif "swa_bwd_mma_dq" in e.key:
            dev["dq"] += us / 1e3 / 3
    return dev


def train_step_ops(cfg, tokens: int) -> float:
    """The operations of a training step on one sequence of ``tokens``:
    6·N_active·T for the matrix products (forward and backward; a MoE's
    active experts only), plus three times each attention layer's forward
    attention operations (4·D a (query, key) pair a head: the forward and
    the gradient's two matrix products per forward one) over its pairs by
    ``cfg.layer_kind``: the band on a local layer, the causal triangle on
    a global one, none on an xLSTM cell."""
    ops = 6.0 * cfg.num_active_params() * tokens
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind not in ("local", "global"):
            continue
        w = cfg.window if kind == "local" and cfg.window else tokens
        ops += 3 * swa_flops(1, tokens, cfg.n_heads, cfg.d_head, w)
    return ops


def train_step_bound_ms(cfg, tokens: int) -> float:
    """The least time of a training step, :func:`train_step_ops` at the
    bf16 peak (989 TFLOP/s, 700 W)."""
    from repro_torch import hw

    return train_step_ops(cfg, tokens) / hw.H100.peak_bf16_flops * 1e3


def train_phase(seed, torch, swa):
    """Training on the card: the SWA backward kernel against its plain
    version on layer-0-shaped inputs (and timed in turns with autograd
    through SDPA), full-width Danube trained three steps by
    ``repro_torch.train.Trainer``, the smoke config's gradients on the card
    against the CPU path, and a smoke trainer resumed from its checkpoint
    against an uninterrupted run.  Returns (the backward's rows, bf16 then
    float32; the training record)."""
    import copy
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.kernels import build, stencil3d, stream3d
    from repro_torch.models import init_lm, lm_loss
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    H, KV, D, w = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.window
    B, S = 1, TRAIN_SEQ
    record = {"arch": LM_ARCH, "batch": B, "seq": S, "steps": TRAIN_STEPS,
              "remat": True}

    # Danube's head dim in both dtypes, the families' (FAMILY_TRAIN) in
    # bf16: a spill in either kernel fails the run
    for dt, d in ([(torch.bfloat16, D), (torch.float32, D)]
                  + [(torch.bfloat16, d) for d in FAMILY_TRAIN_HEAD_DIMS]):
        report = build.ptxas_report(swa.backward_source(dt, d), "swa_bwd")
        name = "swa_bwd_mma" if dt == torch.bfloat16 else "swa_bwd"
        for chunk in report.split("Compiling entry function '")[1:]:
            kernel = "dkdv" if "dkdv" in chunk[:40] else "dq"
            st = ptxas_stats(chunk)
            key = f"ptxas_{kernel}_{str(dt).removeprefix('torch.')}"
            record[key if d == D else f"{key}_d{d}"] = st
            log(f"ptxas {name}_{kernel} {str(dt).removeprefix('torch.')} D "
                f"{d}: {st['registers']} registers, spill stores "
                f"{st['spill_stores']} B, spill loads {st['spill_loads']} B; "
                f"{swa.backward_smem_bytes(dt, d)} B of shared memory a CTA "
                "at most")
            if st["spill_stores"] or st["spill_loads"]:
                raise SystemExit(f"ptxas spills in {name}_{kernel} at D {d}")

    # 1. the backward kernel on layer 0's shapes, against its plain
    # version, and in turns with autograd through SDPA with the band mask
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    base = [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    G = H // KV
    timed = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v, do = (t.to(dt) for t in base)
        lse = None
        if dt == torch.bfloat16:
            o, lse = swa.swa_cuda_lse(q, k, v, window=w)
            lse_err = rel_err(lse, swa.swa_plain_lse(q, k, window=w))
            log(f"swa forward lse {dt}: vs swa_plain_lse max rel err "
                f"{lse_err:.3e} (tol 1e-4)")
            if lse_err > 1e-4 or not bool(torch.isfinite(lse).all()):
                raise SystemExit("the forward's lse disagrees with its plain "
                                 "version")
        else:
            o = swa.swa_cuda(q, k, v, window=w)
        got = swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = swa.swa_plain_backward(q, k, v, do, window=w)
        e1.record()
        e1.synchronize()
        plain_ms = e0.elapsed_time(e1)
        errs = {n: rel_err(a, b) for n, a, b in zip("qkv", got, want)}
        abs_errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)]
        abs_err = max(abs_errs)
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        log(f"swa backward {dt} {(B, S, H, KV, D)} w {w}: kernel vs plain "
            f"max rel err dq {errs['q']:.3e}, dk {errs['k']:.3e}, dv "
            f"{errs['v']:.3e} (tol {tol}), max abs err {abs_err:.3e}")
        if not finite or max(errs.values()) > tol:
            raise SystemExit(f"the SWA backward kernel ({dt}) disagrees "
                             "with its plain version")
        del got, want
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous(
            ).requires_grad_(True)
        vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous(
            ).requires_grad_(True)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        dot = do.transpose(1, 2)
        ms, library_ms = time_in_turns([
            lambda: swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse),
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                        retain_graph=True)], reps=3)
        bound_ms, bound_by = swa_backward_bound(B, S, H, KV, D, w, dt)
        timed[dt] = dict(ms=ms, library_ms=library_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=abs_err, max_rel_err=errs)
        if dt == torch.bfloat16:
            timed["parts"] = backward_parts(
                torch, swa, (q, k, v, o, do, lse), w,
                {"dq": abs_errs[0], "dkdv": max(abs_errs[1:])},
                (B, S, H, KV, D), seed + 2)
        log(f"swa backward kernel {dt}: {ms:.4f} ms a call ({bound_ms / ms:.1%}"
            f" of the bound {bound_ms:.4f} ms by {bound_by}), plain "
            f"{plain_ms:.3f} ms, autograd through SDPA with the band mask "
            f"{library_ms:.4f} ms (medians, in turns)")
        del q, k, v, do, o, qt, kt, vt, out, dot
        torch.cuda.empty_cache()
    del base, band
    parts = timed.pop("parts")
    record["backward"] = {str(dt).removeprefix("torch."): t
                          for dt, t in timed.items()}
    record["backward"]["bfloat16_kernels"] = parts

    # 2. the main path: full-width Danube trained by the Trainer, the
    # counts zeroed just before each step and read just after it
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    tmp = tmp_dir.name
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=10,
                                     total_steps=100),
                       remat=True, ckpt_every=10**9,
                       ckpt_dir=os.path.join(tmp, "full"), log_every=1,
                       seed=seed)
    data = SyntheticLM(BatchSpec(global_batch=B, seq_len=S,
                                 vocab=cfg.vocab), seed=seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, data)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []
    inner = tr.step_fn

    def counted(*a):
        stencil3d.launches = stream3d.launches = 0
        swa.launches = swa.backward_launches = 0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a)
        e1.record()
        steps.append({"events": (e0, e1), "forward": swa.launches,
                      "backward": swa.backward_launches,
                      "stencil": stencil3d.launches + stream3d.launches})
        return out

    tr.step_fn = counted
    tr.run(TRAIN_STEPS - 1)
    # (each step zeroes the wrappers' counts; a backward launch runs two
    # kernels)
    prof = device_profile(lambda: tr.run(1), torch, swa_kernels=lambda: sum(
        st["forward"] + 2 * st["backward"] for st in steps))
    hist = tr.history
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for st in steps:
        e0, e1 = st.pop("events")
        st["ms"] = e0.elapsed_time(e1)
    bound_ms = train_step_bound_ms(cfg, B * S)
    for h, st in zip(hist, steps):
        log(f"train step {h['step']}: loss {h['loss']:.4f}, grad norm "
            f"{h['grad_norm']:.4f}, lr {h['lr']:.3e}, {st['ms']:.1f} ms "
            f"(CUDA events; host {h['time_s'] * 1e3:.1f} ms), "
            f"{B * S / st['ms'] * 1e3:.0f} tokens/s; SWA launches forward "
            f"{st['forward']}, backward {st['backward']}")
    log(f"train: {cfg.name} B {B} S {S} remat, {cfg.num_params() / 1e9:.3f} "
        f"B params, built in {init_s:.1f} s; peak memory {peak_gb:.2f} GB; "
        f"step bound {bound_ms:.2f} ms (6·N·T + 3x the band's attention "
        f"at 989 TFLOP/s); profile of the last step: host "
        f"{prof['host_ms']:.1f} ms, device {prof['device_ms']:.1f} ms "
        f"(idle {prof['idle_share']:.1%}), {prof['kernel_launches']} kernel "
        f"launches; device ms: "
        + ", ".join(f"{c} {v:.1f}" for c, v in prof["device_ms_by"].items()))
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm")):
        raise SystemExit(f"training gave {hist}")
    if any(st["forward"] != 2 * cfg.n_layers or st["backward"] != cfg.n_layers
           or st["stencil"] for st in steps):
        raise SystemExit("a train step did not run the SWA forward kernel "
                         "twice a layer (remat) and its backward once")
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    record.update(history=hist, steps=steps, step_ms=step_ms,
                  tokens_per_s=B * S / step_ms * 1e3, peak_memory_gb=peak_gb,
                  step_bound_ms=bound_ms, bound_share=bound_ms / step_ms,
                  init_s=init_s, profile=prof,
                  launches_forward=sum(st["forward"] for st in steps),
                  launches_backward=sum(st["backward"] for st in steps))
    del tr, inner, counted
    torch.cuda.empty_cache()

    # 3a. the smoke config in float32: loss and every gradient on the card
    # (the SWA kernels forward and backward) against the CPU path
    scfg = dataclasses.replace(get_smoke(LM_ARCH), dtype="float32")
    cpu_lm = init_lm(scfg, torch.Generator().manual_seed(seed),
                     "cpu").requires_grad_(True)
    card_lm = copy.deepcopy(cpu_lm).to("cuda")
    batch = SyntheticLM(BatchSpec(2, TRAIN_SMOKE_SEQ, scfg.vocab),
                        seed=seed).batch_at(0)
    res = {}
    for name, lm in (("cpu", cpu_lm), ("cuda", card_lm)):
        swa.launches = swa.backward_launches = 0
        t, lb = (torch.as_tensor(batch[k], device=name).long()
                 for k in ("tokens", "labels"))
        loss, _ = lm_loss(scfg, lm, t, lb)
        named = dict(lm.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        res[name] = (loss.item(), {k: g.cpu() for k, g in zip(named, grads)},
                     swa.launches, swa.backward_launches)
    grad_err = max(rel_err(res["cuda"][1][k], g)
                   for k, g in res["cpu"][1].items())
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    log(f"smoke {scfg.name} float32 S {TRAIN_SMOKE_SEQ}: card vs CPU loss "
        f"rel err {loss_err:.3e} (tol 1e-5), worst gradient max rel err "
        f"{grad_err:.3e} (tol 1e-4); card SWA launches forward "
        f"{res['cuda'][2]}, backward {res['cuda'][3]}")
    if loss_err > 1e-5 or grad_err > 1e-4 or res["cuda"][2:] != (
            scfg.n_layers, scfg.n_layers) or res["cpu"][2:] != (0, 0):
        raise SystemExit("the smoke config's gradients on the card disagree "
                         "with the CPU path")
    record["smoke_grads"] = {"loss_rel_err": loss_err,
                             "grad_max_rel_err": grad_err}

    # 3b. a smoke trainer on the card fails at TRAIN_FAIL_AT, resumes from
    # its last checkpoint and matches an uninterrupted run
    scfg = get_smoke(LM_ARCH)
    sdata = SyntheticLM(BatchSpec(4, TRAIN_SMOKE_SEQ, scfg.vocab), seed=seed)
    stcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=50),
                        ckpt_every=2, ckpt_dir=os.path.join(tmp, "resume"),
                        log_every=10**9, seed=seed)
    try:
        Trainer(scfg, stcfg, sdata, fail_at_step=TRAIN_FAIL_AT).run(
            TRAIN_SMOKE_STEPS)
        raise SystemExit("the smoke trainer did not fail")
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    last = latest_step(stcfg.ckpt_dir)
    resumed = Trainer(scfg, stcfg, sdata)
    start = resumed.step
    swa.launches = swa.backward_launches = 0
    got = resumed.run(TRAIN_SMOKE_STEPS - start)
    resumed_launches = (swa.launches, swa.backward_launches)
    whole = Trainer(scfg, dataclasses.replace(
        stcfg, ckpt_dir=os.path.join(tmp, "whole"), ckpt_every=10**9), sdata)
    want = whole.run(TRAIN_SMOKE_STEPS)[start:]
    loss_diff = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(got, want))
    param_err = max(rel_err(a, b) for a, b in zip(
        resumed.state["params"].parameters(),
        whole.state["params"].parameters()))
    log(f"smoke trainer: failed at step {TRAIN_FAIL_AT}, latest checkpoint "
        f"{last}, resumed at {start}; steps {[h['step'] for h in got]} vs "
        f"the uninterrupted run: loss max rel diff {loss_diff:.3e}, final "
        f"params max rel diff {param_err:.3e} (tol 1e-5); SWA launches "
        f"resumed {resumed_launches}")
    if last != TRAIN_FAIL_AT - TRAIN_FAIL_AT % 2 or start != last \
            or [h["step"] for h in got] != [h["step"] for h in want] \
            or loss_diff > 1e-5 or param_err > 1e-5 \
            or min(resumed_launches) < 1:
        raise SystemExit("the resumed smoke trainer does not match the "
                         "uninterrupted run")
    record["resume"] = {"failed_at": TRAIN_FAIL_AT, "resumed_at": start,
                        "loss_max_rel_diff": loss_diff,
                        "params_max_rel_diff": param_err}
    tmp_dir.cleanup()

    rows = []
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        t = timed[dt]
        rows.append({
            "name": f"swa.swa_cuda_backward[{cfg.name} train B{B} S{S} "
                    f"H{H} KV{KV} D{D} w{w} {tag}]",
            "route": "cuda",
            "source": str(swa.BACKWARD_SOURCES[dt].relative_to(ROOT)),
            "replaces": swa.REPLACES,
            "launches": (record["launches_backward"]
                         if dt == torch.bfloat16 else 0),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "max_rel_err": t["max_rel_err"],
            "backward_of_replaces": True,
            "on_training_path": dt == torch.bfloat16,
            "smem_bytes": swa.backward_smem_bytes(dt, D),
        })
    for part in parts:
        rows.append({
            "name": f"swa_bwd_mma_{part['kernel']}[{cfg.name} train B{B} "
                    f"S{S} H{H} KV{KV} D{D} w{w} bf16]",
            "route": "cuda",
            "source": str(swa.BACKWARD_SOURCES[torch.bfloat16].relative_to(
                ROOT)),
            "replaces": swa.REPLACES,
            "launches": record["launches_backward"],
            "max_abs_err": part["max_abs_err"],
            "ms": part["ms"],
            "plain_ms": part["plain_ms"],
            "bound_ms": part["bound_ms"],
            "bound_by": part["bound_by"],
            "library_ms": None,
            "backward_of_replaces": True,
            "on_training_path": True,
            "smem_bytes": swa.backward_smem_bytes(torch.bfloat16, D),
        })
    record["seconds"] = time.perf_counter() - t_phase
    log(f"train phase: {record['seconds']:.1f} s")
    return rows, record


def sharded_rank_child(spec: dict) -> None:
    """One rank of the sharded training phase (this script run with
    ``--sharded-rank``): full-width Danube cut to ``spec["depth"]`` layers
    trained by ``Trainer(rules=)`` over a (2, 2) mesh, in turns with a
    single-process ``Trainer`` on rank 0 from the same parameters and
    batches; the smoke config in float32 the same way; rank 0's first
    local SWA call captured.  Writes ``rank<r>.json`` (and rank 0 the
    captured call, ``swa_local.pt``) under ``spec["dir"]``."""
    import contextlib
    import dataclasses
    import datetime
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.dist.host_staged import HostStagedCollectives
    from repro_torch.kernels import swa
    from repro_torch.launch.dryrun import CollectiveLog
    from repro_torch.launch.mesh import make_rules
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    rank, work = spec["rank"], Path(spec["dir"])
    backend = spec["backend"]
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{work}/store",
                            rank=rank, world_size=SHARDED_RANKS,
                            timeout=datetime.timedelta(
                                seconds=SHARDED_TIMEOUT_S))
    staged = (HostStagedCollectives() if backend == "gloo"
              else contextlib.nullcontext())
    mesh = init_device_mesh("cuda", SHARDED_MESH[0],
                            mesh_dim_names=SHARDED_MESH[1])
    rules = make_rules(mesh, kind="train")
    rec = {"rank": rank, "device": str(torch.cuda.current_device()),
           "rules": {"tp": rules.tp, "fsdp": rules.fsdp, "dp": rules.dp}}

    captured = []
    attention = swa.attention

    def capture(q, k, v, *, window):
        if not captured:
            captured.append([t.detach().clone() for t in (q, k, v)]
                            + [window])
        return attention(q, k, v, window=window)
    swa.attention = capture

    def train(cfg, tcfg, data, tag):
        """Steps of the sharded Trainer (every rank) and the single one
        (rank 0) in turns; per sharded step its counts, time and
        collectives on this rank."""
        sharded = Trainer(cfg, dataclasses.replace(
            tcfg, ckpt_dir=str(work / f"{tag}_sharded")), data, rules=rules)
        single = (Trainer(cfg, dataclasses.replace(
            tcfg, ckpt_dir=str(work / f"{tag}_single")), data)
            if rank == 0 else None)
        inner, steps = sharded.step_fn, []

        def counted(*a):
            swa.launches = swa.backward_launches = 0
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            with CollectiveLog(mesh) as comms:
                out = inner(*a)
            e1.record()
            torch.cuda.synchronize()
            steps.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                          "events": (e0, e1), "forward": swa.launches,
                          "backward": swa.backward_launches,
                          "collectives": comms.by_op_axis()})
            return out
        sharded.step_fn = counted
        single_ms = []
        for _ in range(spec[tag + "_steps"]):
            sharded.run(1)
            dist.barrier()
            if single is not None:
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                single.run(1)
                e1.record()
                e1.synchronize()
                single_ms.append(e0.elapsed_time(e1))
            dist.barrier()
        for st in steps:
            e0, e1 = st.pop("events")
            st["ms"] = e0.elapsed_time(e1)
        out = {"history": sharded.history, "steps": steps,
               "single_ms": single_ms}
        # the gathered parameters against the single run's (rank 0)
        worst = {}
        single_named = (dict(single.state["params"].named_parameters())
                        if single is not None else {})
        for k, p in sharded.state["params"].named_parameters():
            full = p.full_tensor()
            if single is not None:
                worst[k] = rel_err(full, single_named[k])
            del full
        if single is not None:
            out["single_history"] = single.history
            out["params_max_rel_err"] = max(worst.values())
            out["params_worst_leaf"] = max(worst, key=worst.get)
        del sharded, single
        torch.cuda.empty_cache()
        return out

    with staged:
        cfg = dataclasses.replace(get_config(spec["arch"]),
                                  n_layers=spec["depth"])
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=10,
                                         total_steps=100),
                           remat=True, ckpt_every=10**9, log_every=10**9,
                           seed=spec["seed"])
        data = SyntheticLM(BatchSpec(global_batch=spec["batch"],
                                     seq_len=spec["seq"], vocab=cfg.vocab),
                           seed=spec["seed"])
        torch.cuda.reset_peak_memory_stats()
        rec["full"] = train(cfg, tcfg, data, "full")
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        swa.attention = attention
        if rank == 0:
            torch.save(captured[0], work / "swa_local.pt")
        scfg = dataclasses.replace(get_smoke(spec["arch"]), dtype="float32")
        stcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=40),
                            remat=True, ckpt_every=10**9, log_every=10**9,
                            seed=spec["seed"])
        sdata = SyntheticLM(BatchSpec(global_batch=SHARDED_SMOKE_BATCH,
                                      seq_len=TRAIN_SMOKE_SEQ,
                                      vocab=scfg.vocab), seed=spec["seed"])
        rec["smoke"] = train(scfg, stcfg, sdata, "smoke")
    if isinstance(staged, HostStagedCollectives):
        rec["staged_collectives"] = staged.staged
    dist.barrier()
    dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(rec))
    os._exit(0)


def sharded_train_phase(seed, torch, swa):
    """Sharded training on the card: 4 rank processes (this script with
    ``--sharded-rank``) train full-width Danube cut to ``SHARDED_DEPTH``
    layers through ``Trainer(rules=)`` on a (2, 2) ``("data", "model")``
    mesh under the dry run's train rules, NCCL with a card a rank, else
    gloo (staged through host memory, ``repro_torch.dist.host_staged``)
    with every rank on ``cuda:0``.  Checks each step's loss and grad norm
    and the gathered parameters after the last against a single-process
    Trainer on the same card (2e-2), the SWA launches of every rank (2
    forward and 1 backward a layer a step, under remat), the smoke config
    in float32 sharded against unsharded (1e-4), and rank 0's first local
    SWA call (forward and backward) against its plain version, timed in
    turns with SDPA.  Returns (the local SWA rows, the record)."""
    import tempfile

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SHARDED_RANKS else "gloo"
    staged = ("collectives staged through host memory, "
              if backend == "gloo" else "")
    log(f"sharded_train: {SHARDED_RANKS} ranks on a {SHARDED_MESH[0]} mesh "
        f"{SHARDED_MESH[1]}, backend {backend} ({staged}{cards} card(s)); "
        f"{cfg.name} at full width cut to "
        f"{SHARDED_DEPTH} of its {cfg.n_layers} layers, {SHARDED_BATCH} x "
        f"{SHARDED_SEQ} tokens a step, remat, bf16 over float32 masters")
    # the sources every rank loads (cached by the start of the run)
    d_smoke = get_smoke(LM_ARCH).d_head
    build.build_many(
        [swa.kernel_source(torch.bfloat16, cfg.d_head),
         swa.kernel_source(torch.float32, d_smoke),
         swa.backward_source(torch.bfloat16, cfg.d_head),
         swa.backward_source(torch.float32, d_smoke)],
        tag=["swa", "swa", "swa_bwd", "swa_bwd"])
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_")
    work = Path(tmp_dir.name)
    spec = {"dir": str(work), "backend": backend, "seed": seed,
            "arch": LM_ARCH, "depth": SHARDED_DEPTH, "batch": SHARDED_BATCH,
            "seq": SHARDED_SEQ, "full_steps": SHARDED_STEPS,
            "smoke_steps": SHARDED_SMOKE_STEPS}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sharded-rank",
         json.dumps(dict(spec, rank=r))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SHARDED_RANKS)]
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    outs = [None] * SHARDED_RANKS
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            err = outs[r][1] if outs[r] else "(timed out)"
            log(f"sharded rank {r} failed:\n{err[-3000:]}")
        raise SystemExit(f"sharded_train: ranks {failed} failed")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(SHARDED_RANKS)]
    rec = {"ranks": SHARDED_RANKS, "mesh": list(SHARDED_MESH[0]),
           "axes": list(SHARDED_MESH[1]), "backend": backend, "cards": cards,
           "arch": LM_ARCH, "depth": SHARDED_DEPTH, "batch": SHARDED_BATCH,
           "seq": SHARDED_SEQ, "steps": SHARDED_STEPS,
           "rules": ranks[0]["rules"]}

    # every rank ran the kernels: 2 forward (remat) and 1 backward a layer
    for r in ranks:
        for part, depth in (("full", SHARDED_DEPTH), ("smoke", 2)):
            got = [(st["forward"], st["backward"])
                   for st in r[part]["steps"]]
            if any(f != 2 * depth or b != depth for f, b in got):
                raise SystemExit(f"sharded_train rank {r['rank']} {part}: "
                                 f"SWA launches {got} a step, want "
                                 f"{(2 * depth, depth)}")
    zero = ranks[0]
    for part, tol in (("full", 2e-2), ("smoke", 1e-4)):
        z = zero[part]
        errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(
            z["history"], z["single_history"])) for k in ("loss",
                                                          "grad_norm")}
        same = all(r[part]["history"][i][k] == zero[part]["history"][i][k]
                   for r in ranks for i in range(len(z["history"]))
                   for k in ("loss", "grad_norm"))
        log(f"sharded_train {part}: losses "
            f"{[round(h['loss'], 5) for h in z['history']]} vs single "
            f"{[round(h['loss'], 5) for h in z['single_history']]}; max rel "
            f"err loss {errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}"
            f", gathered params {z['params_max_rel_err']:.3e} "
            f"({z['params_worst_leaf']}) (tol {tol}); metrics equal on "
            f"every rank: {same}")
        if max(errs.values()) > tol or z["params_max_rel_err"] > tol \
                or not same or len(z["history"]) != spec[part + "_steps"]:
            raise SystemExit(f"sharded_train {part}: the sharded run "
                             "disagrees with the single-process run")
        rec[part] = {"history": z["history"],
                     "single_history": z["single_history"],
                     "loss_max_rel_err": errs["loss"],
                     "grad_norm_max_rel_err": errs["grad_norm"],
                     "params_max_rel_err": z["params_max_rel_err"]}
    steps = zero["full"]["steps"]
    tokens = SHARDED_BATCH * SHARDED_SEQ
    for i, (st, single) in enumerate(zip(steps, zero["full"]["single_ms"])):
        log(f"sharded step {i}: {st['ms']:.1f} ms (CUDA events, rank 0; "
            f"host {st['host_ms']:.1f} ms), {tokens / st['ms'] * 1e3:.0f} "
            f"tokens/s; single-process step {single:.1f} ms, "
            f"{tokens / single * 1e3:.0f} tokens/s; SWA launches forward "
            f"{st['forward']}, backward {st['backward']} a rank")
    coll = steps[-1]["collectives"]
    log("sharded step collectives a rank (op over axis: count, MB): "
        + "; ".join(f"{k}: {v['count']}, {v['bytes'] / 1e6:.1f}"
                    for k, v in sorted(coll.items())))
    log("sharded peak memory a rank (GB): "
        + ", ".join(f"{r['peak_memory_gb']:.2f}" for r in ranks))
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    single_ms = statistics.median(zero["full"]["single_ms"][1:])
    rec.update(step_ms=step_ms, single_step_ms=single_ms,
               tokens_per_s=tokens / step_ms * 1e3,
               single_tokens_per_s=tokens / single_ms * 1e3,
               steps_record=steps, single_ms=zero["full"]["single_ms"],
               collectives_per_step=coll,
               peak_memory_gb=[r["peak_memory_gb"] for r in ranks],
               staged_collectives=zero.get("staged_collectives"),
               launches_forward=sum(st["forward"] for st in steps),
               launches_backward=sum(st["backward"] for st in steps))

    # rank 0's first local SWA call: its shard of layer 0's q, k, v
    q, k, v, w = torch.load(work / "swa_local.pt")
    tmp_dir.cleanup()
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    rows, rec["local_swa"] = swa_pair_check(
        torch, swa, q, k, v, do, w,
        f"{cfg.name} depth {SHARDED_DEPTH} sharded (2,2) rank 0 shard",
        {part: rec["launches_" + part] for part in ("forward", "backward")},
        f"{SHARDED_STEPS} sharded steps on rank 0",
        {"on_sharded_training_path": True})
    del q, k, v, do
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"sharded_train phase: {rec['seconds']:.1f} s")
    return rows, rec


def family_train_phase(seed, torch, swa):
    """The MoE, hybrid and xLSTM families trained on the card
    (``FAMILY_TRAIN``), then whisper-small's loss and gradients.  Returns
    (the SWA rows of the families with attention, the record)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, record = [], {}
    for arch, depth, S, prof_S in FAMILY_TRAIN:
        arch_rows, record[arch] = train_family(arch, depth, S, prof_S, seed,
                                               torch, swa)
        rows += arch_rows
        torch.cuda.empty_cache()
    record["whisper_small"] = train_whisper(seed, torch)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"family_train phase: {record['seconds']:.1f} s")
    return rows, record


@contextlib.contextmanager
def module_ranges(torch):
    """Each family module's call (``moe_apply``, the Mamba scan, the mLSTM
    and sLSTM cells) inside a ``record_function`` range of its
    ``FAMILY_RANGES`` label, while the block is open."""
    from repro_torch.models import ssm, transformer

    patched = [(transformer, "moe_apply", "moe")] + [
        (ssm, f"{c}_apply", c) for c in ("mamba", "mlstm", "slstm")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]

    def ranged(fn, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run

    for (m, n, label), (_, _, fn) in zip(patched, saved):
        setattr(m, n, ranged(fn, label))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def train_family(arch, depth, S, prof_S, seed, torch, swa):
    """One family at full width (depth cut to ``depth`` where given)
    trained by ``Trainer`` for FAMILY_TRAIN_STEPS steps on one S-token
    sequence of ``SyntheticLM``, remat on, bf16 over float32 masters, the
    SWA counts zeroed just before each step and read just after; one step
    of ``prof_S`` tokens under ``torch.profiler`` (the last Trainer step
    when ``prof_S == S``, else one more step on a shorter sequence); then
    the SWA forward with lse and backward on the inputs the first local
    layer's backward was handed in the first step (:func:`swa_pair_check`)
    and the smoke config's step on the card against the CPU
    (:func:`smoke_step_check`).  Returns (the SWA rows, the record)."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    t_arch = time.perf_counter()
    cfg = get_config(arch)
    full_depth = cfg.n_layers
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    local = [i for i, kind in enumerate(kinds) if kind == "local"
             and cfg.window and S > cfg.window and not cfg.attn_softcap]
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_family_")
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=10,
                                     total_steps=100),
                       remat=True, ckpt_every=10**9, ckpt_dir=tmp_dir.name,
                       log_every=1, seed=seed)
    data = SyntheticLM(BatchSpec(global_batch=1, seq_len=S,
                                 vocab=cfg.vocab), seed=seed)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, data)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_arch
    n_params = sum(p.numel() for p in tr.state["params"].parameters())
    log(f"family_train {cfg.name}: {cfg.n_layers} of {full_depth} layers "
        f"({kinds.count('global')} global, {len(local)} local with the SWA "
        f"kernel), d {cfg.d_model}, {n_params / 1e9:.3f} B params, "
        f"1 x {S} tokens a step, built in {init_s:.1f} s")

    # the main path: the counts zeroed just before each step and read just
    # after it; the first step's SWA backward calls captured (the layers
    # run last to first, so the last one held is the first local layer's)
    steps, captured = [], {}
    inner, plain_bwd = tr.step_fn, swa.swa_cuda_backward

    def capture_bwd(q, k, v, o, do, *, window, lse=None):
        if not steps:
            captured["swa"] = tuple(t.detach().clone()
                                    for t in (q, k, v, do)) + (window,)
        return plain_bwd(q, k, v, o, do, window=window, lse=lse)

    def counted(*a):
        swa.launches = swa.backward_launches = 0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a)
        e1.record()
        steps.append({"events": (e0, e1), "forward": swa.launches,
                      "backward": swa.backward_launches})
        return out

    def swa_kernels():
        # a backward launch runs two kernels
        return sum(st["forward"] + 2 * st["backward"] for st in steps)

    tr.step_fn = counted
    swa.swa_cuda_backward = capture_bwd
    try:
        if prof_S == S:
            tr.run(FAMILY_TRAIN_STEPS - 1)
            with module_ranges(torch):
                prof = device_profile(lambda: tr.run(1), torch,
                                      FAMILY_RANGES, swa_kernels)
        else:
            tr.run(FAMILY_TRAIN_STEPS)
            short = {k: torch.as_tensor(v, device="cuda").long()
                     for k, v in SyntheticLM(BatchSpec(1, prof_S, cfg.vocab),
                                             seed=seed).batch_at(0).items()}

            def short_step():
                ts = tr.state
                ts["params"], ts["opt"], ts["ef"], m = inner(
                    ts["params"], ts["opt"], ts["ef"], short)
                return float(m["loss"])

            with module_ranges(torch):
                prof = device_profile(short_step, torch, FAMILY_RANGES)
    finally:
        swa.swa_cuda_backward = plain_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = tr.history
    for st in steps:
        e0, e1 = st.pop("events")
        st["ms"] = e0.elapsed_time(e1)
    bound_ms = train_step_bound_ms(cfg, S)
    for h, st in zip(hist, steps):
        log(f"family_train {cfg.name} step {h['step']}: loss "
            f"{h['loss']:.4f}, grad norm {h['grad_norm']:.4f}, "
            f"{st['ms']:.1f} ms (CUDA events; host {h['time_s'] * 1e3:.1f} "
            f"ms), {S / st['ms'] * 1e3:.0f} tokens/s; SWA launches forward "
            f"{st['forward']}, backward {st['backward']}")
    log(f"family_train {cfg.name}: peak memory {peak_gb:.2f} GB; step "
        f"bound {bound_ms:.2f} ms (6·N_active·T + 3x each attention "
        f"layer's pairs at 989 TFLOP/s); profile of a step of {prof_S} "
        f"tokens: host {prof['host_ms']:.1f} ms, device "
        f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.1%}), "
        f"{prof['kernel_launches']} kernel launches; device ms: "
        + ", ".join(f"{'elementwise' if c == 'other' else c} {v:.1f}"
                    for c, v in prof["device_ms_by"].items()))
    if len(hist) != FAMILY_TRAIN_STEPS or not all(
            np.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm")):
        raise SystemExit(f"{cfg.name}: training gave {hist}")
    if any(st["forward"] != 2 * len(local) or st["backward"] != len(local)
           for st in steps):
        raise SystemExit(f"{cfg.name}: a train step did not run the SWA "
                         "forward kernel twice a local layer (remat) and its "
                         "backward once")
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    record = {"arch": arch, "depth": cfg.n_layers, "full_depth": full_depth,
              "params": n_params, "batch": 1, "seq": S,
              "steps": FAMILY_TRAIN_STEPS, "remat": True,
              "local_layers": len(local),
              "global_layers": kinds.count("global"), "history": hist,
              "steps_record": steps, "step_ms": step_ms,
              "tokens_per_s": S / step_ms * 1e3, "peak_memory_gb": peak_gb,
              "step_bound_ms": bound_ms, "bound_share": bound_ms / step_ms,
              "init_s": init_s, "profiled_seq": prof_S, "profile": prof,
              "launches_forward": sum(st["forward"] for st in steps),
              "launches_backward": sum(st["backward"] for st in steps)}
    del tr, inner, counted, data
    tmp_dir.cleanup()
    torch.cuda.empty_cache()

    rows = []
    if local:
        q, k, v, do, w = captured.pop("swa")
        rows, record["swa"] = swa_pair_check(
            torch, swa, q, k, v, do, w,
            f"{cfg.name} train layer {local[0]}",
            {"forward": record["launches_forward"],
             "backward": record["launches_backward"]},
            f"{FAMILY_TRAIN_STEPS} train steps",
            {"on_training_path": True})
        del q, k, v, do
        torch.cuda.empty_cache()
    record["smoke_step"] = smoke_step_check(arch, seed, torch, swa)
    record["seconds"] = time.perf_counter() - t_arch
    log(f"family_train {cfg.name}: {record['seconds']:.1f} s")
    return rows, record


def smoke_step_check(arch, seed, torch, swa) -> dict:
    """One ``make_train_step`` step of ``arch``'s smoke config in float32
    on the card (the SWA kernels on its local layers) against the same
    step on the CPU, from the same parameters and non-zero moments (so
    the update is smooth in the gradients): every parameter at 1e-4 of
    its max abs, and the kernels launched once a local layer each way on
    the card, never on the CPU."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.models import init_lm
    from repro_torch.train import (OptConfig, TrainConfig, adamw_init,
                                   make_train_step)

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    S = TRAIN_SMOKE_SEQ
    local = sum(cfg.layer_kind(i) == "local" and 0 < cfg.window < S
                for i in range(cfg.n_layers))
    cpu = init_lm(cfg, torch.Generator().manual_seed(seed),
                  "cpu").requires_grad_(True)
    card = copy.deepcopy(cpu).to("cuda")
    batch = SyntheticLM(BatchSpec(2, S, cfg.vocab), seed=seed).batch_at(0)
    step = make_train_step(cfg, TrainConfig(opt=OptConfig(
        lr=1e-3, warmup_steps=0)))
    gen = torch.Generator().manual_seed(seed + 1)
    state = adamw_init(dict(cpu.named_parameters()))
    state["count"] += 5
    for t in state["mu"].values():
        t.copy_(torch.randn(t.shape, generator=gen) * 1e-2)
    for t in state["nu"].values():
        t.copy_(torch.randn(t.shape, generator=gen).square() * 1e-4 + 1e-6)
    out = {}
    for dev, lm in (("cpu", cpu), ("cuda", card)):
        swa.launches = swa.backward_launches = 0
        moved = {"mu": {k: t.to(dev, copy=True)
                        for k, t in state["mu"].items()},
                 "nu": {k: t.to(dev, copy=True)
                        for k, t in state["nu"].items()},
                 "count": state["count"].to(dev)}
        *_, metrics = step(lm, moved, torch.zeros((), device=dev),
                           {k: torch.as_tensor(v, device=dev).long()
                            for k, v in batch.items()})
        out[dev] = ({k: p.detach().cpu() for k, p in lm.named_parameters()},
                    float(metrics["loss"]),
                    (swa.launches, swa.backward_launches))
    err = max(rel_err(out["cuda"][0][k], p) for k, p in out["cpu"][0].items())
    loss_err = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    log(f"smoke {cfg.name} float32 2 x {S}: one train step on the card vs "
        f"the CPU, params max rel err {err:.3e}, loss rel err "
        f"{loss_err:.3e} (tol 1e-4); card SWA launches forward, backward "
        f"{out['cuda'][2]}")
    if err > 1e-4 or loss_err > 1e-4 or out["cuda"][2] != (local, local) \
            or out["cpu"][2] != (0, 0):
        raise SystemExit(f"{cfg.name}: the smoke step on the card disagrees "
                         "with the CPU")
    return {"params_max_rel_err": err, "loss_rel_err": loss_err,
            "launches": out["cuda"][2]}


def whisper_step_ops(cfg, batch: int, tokens: int) -> float:
    """The operations of a whisper training step on ``batch`` utterances
    of ``cfg.enc_seq`` frames and ``tokens`` decoder tokens: 6 times each
    weight a token passes through (the frontend's projection, the
    encoder's layers and the cross-attention's keys and values on the
    frames; the decoder's layers and the tied logits on the tokens), plus
    three times the forward attention's 4·D a (query, key) pair a head:
    all frame pairs in the encoder, the causal triangle and every
    (token, frame) pair in the decoder."""
    d, f, h, kv, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head)
    F_, T = cfg.enc_seq, tokens
    attn = 2 * d * h * dh + 2 * d * kv * dh
    mlp = d * f * (2 if cfg.glu else 1) + f * d
    per_frame = d * d + cfg.n_enc_layers * (attn + mlp) \
        + cfg.n_layers * 2 * d * kv * dh
    per_token = cfg.n_layers * (attn + 2 * d * h * dh + mlp) \
        + cfg.vocab_padded * d
    pairs = cfg.n_enc_layers * F_ * F_ + cfg.n_layers * (
        T * (T + 1) // 2 + T * F_)
    return 6.0 * batch * (F_ * per_frame + T * per_token) \
        + 3 * 4 * dh * h * batch * pairs


def train_whisper(seed, torch) -> dict:
    """whisper-small at full width and depth, float32 masters from
    ``--seed`` computed in bf16: ``whisper_loss`` (remat) on WHISPER_BATCH
    utterances of precomputed frames and WHISPER_MAX_LEN decoder tokens,
    every gradient by autograd, one ``adamw_update`` step from them;
    FAMILY_TRAIN_STEPS such steps, the last under ``torch.profiler``.
    Then at depth 2 + 2, full width, on WHISPER_CHECK_BATCH utterances:
    the loss and every gradient of the card's bf16 run against the CPU's
    float32 run from the same masters, at 2e-2 of each one's max abs."""
    import dataclasses

    import numpy as np

    from repro_torch import hw
    from repro_torch.configs import get_config
    from repro_torch.models import init_whisper, whisper_loss
    from repro_torch.train import OptConfig, adamw_init, adamw_update
    from repro_torch.train.optimizer import cosine_schedule

    t0 = time.perf_counter()
    cfg = get_config("whisper_small")
    B, T = WHISPER_BATCH, WHISPER_MAX_LEN
    rng = np.random.default_rng(seed)
    frames_np = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                    dtype=np.float32)
    toks_np = rng.integers(0, cfg.vocab, (B, T + 1))
    frames = torch.as_tensor(frames_np, device="cuda")
    tokens = torch.as_tensor(toks_np[:, :-1], device="cuda")
    labels = torch.as_tensor(toks_np[:, 1:], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    masters = init_whisper(cfg, gen).requires_grad_(True)
    named = dict(masters.named_parameters())
    opt = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    lr_fn = cosine_schedule(opt)
    state = {"opt": adamw_init(named)}
    hist = []

    def step():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss, _ = whisper_loss(cfg, masters, frames, tokens, labels,
                               remat=True)
        grads = torch.autograd.grad(loss, list(named.values()))
        _, state["opt"], om = adamw_update(
            opt, named, dict(zip(named, grads)), state["opt"], lr_fn)
        e1.record()
        hist.append({"loss": float(loss.detach()), "grad_norm": float(
            om["grad_norm"]), "events": (e0, e1)})

    for _ in range(FAMILY_TRAIN_STEPS - 1):
        step()
    prof = device_profile(step, torch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for h in hist:
        e0, e1 = h.pop("events")
        h["ms"] = e0.elapsed_time(e1)
    step_ms = statistics.median(h["ms"] for h in hist[1:])
    bound_ms = whisper_step_ops(cfg, B, T) / hw.H100.peak_bf16_flops * 1e3
    for i, h in enumerate(hist):
        log(f"family_train {cfg.name} step {i}: loss {h['loss']:.4f}, grad "
            f"norm {h['grad_norm']:.4f}, {h['ms']:.1f} ms (CUDA events), "
            f"{B * T / h['ms'] * 1e3:.0f} decoder tokens/s")
    log(f"family_train {cfg.name}: {B} x {cfg.enc_seq} frames, {B} x {T} "
        f"tokens, remat; peak memory {peak_gb:.2f} GB; step bound "
        f"{bound_ms:.2f} ms; profile of the last step: host "
        f"{prof['host_ms']:.1f} ms, device {prof['device_ms']:.1f} ms (idle "
        f"{prof['idle_share']:.1%}), {prof['kernel_launches']} kernel "
        "launches; device ms: "
        + ", ".join(f"{'elementwise' if c == 'other' else c} {v:.1f}"
                    for c, v in prof["device_ms_by"].items()))
    if not all(np.isfinite(h[k]) for h in hist for k in ("loss",
                                                          "grad_norm")):
        raise SystemExit(f"whisper training gave {hist}")
    record = {"arch": "whisper_small", "batch": B, "frames": cfg.enc_seq,
              "tokens": T, "remat": True, "history": hist,
              "step_ms": step_ms, "tokens_per_s": B * T / step_ms * 1e3,
              "utterances_per_s": B / step_ms * 1e3,
              "peak_memory_gb": peak_gb, "step_bound_ms": bound_ms,
              "bound_share": bound_ms / step_ms, "profile": prof}
    del masters, named, state
    torch.cuda.empty_cache()

    # depth 2 + 2, full width: the card's bf16 loss and gradients against
    # the CPU's float32 ones, the same masters
    small = dataclasses.replace(cfg, n_layers=WHISPER_CHECK_DEPTH,
                                n_enc_layers=WHISPER_CHECK_DEPTH)
    masters = init_whisper(small, gen).requires_grad_(True)
    b = WHISPER_CHECK_BATCH
    res = {}
    for dev, c in (("cuda", small),
                   ("cpu", dataclasses.replace(small, dtype="float32"))):
        masters = masters.to(dev)
        loss, _ = whisper_loss(c, masters, frames[:b].to(dev),
                               tokens[:b].to(dev), labels[:b].to(dev))
        named = dict(masters.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        res[dev] = (float(loss), {k: g.cpu() for k, g in zip(named, grads)})
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_errs = {k: rel_err(res["cuda"][1][k], g)
                 for k, g in res["cpu"][1].items()}
    worst = max(grad_errs, key=grad_errs.get)
    log(f"whisper depth {WHISPER_CHECK_DEPTH}+{WHISPER_CHECK_DEPTH} card "
        f"bf16 vs CPU float32 ({b} x {cfg.enc_seq} frames, {b} x {T} "
        f"tokens): loss rel err {loss_err:.3e}, worst gradient {worst} max "
        f"rel err {grad_errs[worst]:.3e} (tol 2e-2)")
    if loss_err > 2e-2 or grad_errs[worst] > 2e-2:
        raise SystemExit("whisper: the card's gradients depart from the "
                         "CPU's")
    record.update(cpu_loss_rel_err=loss_err, cpu_grad_max_rel_err=grad_errs,
                  seconds=time.perf_counter() - t0)
    del masters, res
    torch.cuda.empty_cache()
    log(f"family_train {cfg.name}: {record['seconds']:.1f} s")
    return record


if __name__ == "__main__":
    sys.exit(main())
