#!/usr/bin/env python3
"""Two or more checkouts of the port timed in turns on one CUDA card.

Each turn is a fresh process that imports ``repro_torch`` from one
checkout's ``src`` and runs the tasks given for it, so the checkouts see
the same card, clocks and power limit within one call::

    python3 tools/lm_turns.py --tree parent=build/parent --tree change=. \\
        --order parent,change,change,parent \\
        --tasks parent,change=danube_train,danube_decode,gemma_decode \\
        --out build/lm_turns.json

Tasks (bf16 compute over float32 masters, random weights from ``--seed``):

* ``danube_train``: full-width H2O-Danube-1.8B trained by ``Trainer``
  (remat, one 8192-token sequence), ``TRAIN_STEPS`` steps, each step's
  CUDA-event ms and host ms;
* ``danube_decode``: Danube served by ``ServeEngine`` (batch 2, prompt
  8192), a decode step's CUDA-event ms (median over ``REPS`` of
  ``INNER`` steps) and its device ms (kernels summed under
  ``torch.profiler`` over ``INNER`` steps);
* ``gemma_decode``: Gemma-2 2B at full width and depth (scaled, tied
  embeddings) served likewise at prompt ``GEMMA_PROMPT``, with the
  engine's weight bytes;
* ``profile_after:arch@prompt/...``: the bf16 SWA backward (Danube's
  layer-0 shapes) profiled over three calls, then after each listed
  model's prefill profiled as ``chip_smoke.py``'s families phase profiles
  it (``sleep@N``: after N seconds idle instead), unpadded and padded by
  ``PADS``: the kernel records each backward profile holds, and the
  seconds each prefill profile takes.

Prints one JSON line per turn and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN_SEQ, TRAIN_STEPS = 8192, 4
SERVE_BATCH, DANUBE_PROMPT, GEMMA_PROMPT = 2, 8192, 2048
INNER, REPS = 8, 9
#: (before, after) host seconds a backward profile is padded with
PADS = ((0.2, 0.0), (0.0, 0.2), (1.0, 1.0), (0.0, 0.0))


def _events_ms(torch, fn, inner=INNER, reps=REPS, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / inner)
    return ts


def danube_train(torch, seed):
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import BatchSpec, SyntheticLM
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    cfg = get_config("h2o_danube_1_8b")
    with tempfile.TemporaryDirectory(prefix="lm_turns_") as tmp:
        tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=10,
                                         total_steps=100),
                           remat=True, ckpt_every=10**9, ckpt_dir=tmp,
                           log_every=1, seed=seed)
        data = SyntheticLM(BatchSpec(global_batch=1, seq_len=TRAIN_SEQ,
                                     vocab=cfg.vocab), seed=seed)
        tr = Trainer(cfg, tcfg, data)
        inner, ms = tr.step_fn, []

        def timed(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(*a)
            e1.record()
            ms.append((e0, e1))
            return out

        tr.step_fn = timed
        tr.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        steps = [a.elapsed_time(b) for a, b in ms]
        hist = tr.history
        del tr
    return {"step_ms": steps, "host_ms": [h["time_s"] * 1e3 for h in hist],
            "median_ms": statistics.median(steps[1:]),
            "loss": [float(h["loss"]) for h in hist]}


def _serve_decode(torch, arch, prompt, seed):
    from repro_torch.configs import get_config
    from repro_torch.models import ServeEngine, decode_step, init_lm, prefill

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_lm(cfg, gen)
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, batch=SERVE_BATCH, max_len=prompt + 256)
    held = sum(p.numel() * p.element_size() for p in eng.params.parameters())
    toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt), generator=gen,
                         device="cuda")
    logits, cache = prefill(cfg, eng.params, toks, prompt + 256)
    step = {"pos": prompt}
    tok = logits.argmax(-1)

    def one_step():
        decode_step(cfg, eng.params, cache, tok, step["pos"])
        step["pos"] += 1

    ts = _events_ms(torch, one_step)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(INNER):
            one_step()
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {"decode_ms": ts, "median_ms": statistics.median(ts),
           "device_ms": device_ms / 1e3 / INNER,
           "engine_param_bytes": held,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "logits_checksum": float(logits.float().abs().sum())}
    del eng, params, cache, logits
    torch.cuda.empty_cache()
    return out


def danube_decode(torch, seed):
    return _serve_decode(torch, "h2o_danube_1_8b", DANUBE_PROMPT, seed)


def gemma_decode(torch, seed):
    return _serve_decode(torch, "gemma2_2b", GEMMA_PROMPT, seed)


def profile_after(torch, seed, runs):
    """``runs``: [(arch, prompt), ...] profiled in order, each prefill
    followed by two profiles of the bf16 SWA backward's three calls."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import swa
    from repro_torch.models import (ServeEngine, init_lm, prefill, ssm,
                                    transformer)

    dcfg = get_config("h2o_danube_1_8b")
    H, KV, D, w = dcfg.n_heads, dcfg.n_kv_heads, dcfg.d_head, dcfg.window
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16) for s in ((1, TRAIN_SEQ, H, D), (1, TRAIN_SEQ, KV, D),
                                  (1, TRAIN_SEQ, KV, D), (1, TRAIN_SEQ, H, D)))
    o, lse = swa.swa_cuda_lse(q, k, v, window=w)

    def backward_records(cuda_only=False, pad=(0.0, 0.0)):
        """Kernel records of three backward calls and of one PyTorch op
        (a sum over q), which tells a blind profiler from one blind to the
        library's launches alone; ``pad``: host seconds slept inside the
        session before the calls and after their synchronise."""
        acts = [ProfilerActivity.CUDA] if cuda_only else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            time.sleep(pad[0])
            for _ in range(3):
                swa.swa_cuda_backward(q, k, v, o, do, window=w, lse=lse)
            q.float().sum()
            torch.cuda.synchronize()
            time.sleep(pad[1])
        n = {"dq": 0, "dkdv": 0, "torch_kernels": 0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "swa_bwd_mma_dkdv" in e.key:
                n["dkdv"] += e.count
            elif "swa_bwd_mma_dq" in e.key:
                n["dq"] += e.count
            else:
                n["torch_kernels"] += e.count
        n["s"] = time.perf_counter() - t0
        return n

    rec = {"before": backward_records(),
           "before_cuda_only": backward_records(True)}
    plain = {(ssm, f"{c}_apply"): c for c in ("mamba", "mlstm", "slstm")}
    plain[(transformer, "moe_apply")] = "moe"
    saved = {key: getattr(*key) for key in plain}

    def ranged(key):
        def run(*a, **kw):
            with torch.profiler.record_function(plain[key]):
                return saved[key](*a, **kw)
        return run

    for key in plain:
        setattr(*key, ranged(key))
    try:
        for arch, S in runs:
            if arch == "sleep":
                time.sleep(S)
                rec[f"after sleep {S} s"] = backward_records()
                continue
            cfg = get_config(arch)
            eng = ServeEngine(cfg, init_lm(cfg, gen), batch=SERVE_BATCH,
                              max_len=S + 16)
            toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, S),
                                 generator=gen, device="cuda")
            prefill(cfg, eng.params, toks, S + 16)
            t0 = time.perf_counter()
            pr = chip_smoke.device_profile(
                lambda: prefill(cfg, eng.params, toks, S + 16), torch,
                chip_smoke.FAMILY_RANGES)
            tag = f"{arch}@{S}"
            rec[tag] = {"profile_s": time.perf_counter() - t0,
                        "host_ms": pr["host_ms"],
                        "device_ms": pr["device_ms"],
                        "idle_share": pr["idle_share"],
                        "kernel_launches": pr["kernel_launches"],
                        "device_ms_by": pr["device_ms_by"],
                        "host_ms_by_range": pr["host_ms_by_range"]}
            rec[f"after {tag}"] = backward_records()
            rec[f"after {tag}, CUDA only"] = backward_records(True)
            for pad in PADS:
                rec[f"after {tag}, pad {pad}"] = backward_records(pad=pad)
            del eng, toks
            torch.cuda.empty_cache()
    finally:
        for key, f in saved.items():
            setattr(*key, f)
    return rec


TASKS = {f.__name__: f for f in (danube_train, danube_decode, gemma_decode)}


def run_task(torch, name, seed):
    """A task of ``TASKS``, or ``profile_after:arch@prompt/arch@prompt``."""
    if name.startswith("profile_after:"):
        runs = [(a, int(n)) for a, n in (r.split("@") for r in
                                         name.split(":", 1)[1].split("/"))]
        return profile_after(torch, seed, runs)
    return TASKS[name](torch, seed)


def child(tree: str, tasks: list, seed: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"src": repro_torch.__file__}
    for t in tasks:
        t0 = time.perf_counter()
        out[t] = run_task(torch, t, seed)
        out[t]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="label=path of a checkout")
    ap.add_argument("--order", default="", help="labels, comma-separated")
    ap.add_argument("--tasks", action="append", default=[],
                    help="labels=task,task (labels comma-separated)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "lm_turns.json"))
    ap.add_argument("--child", nargs=2, metavar=("TREE", "TASKS"))
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child[0], args.child[1].split(","),
                               args.seed)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("lm_turns: no CUDA device is available", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    tasks = {}
    for spec in args.tasks:
        labels, names = spec.split("=", 1)
        for label in labels.split(","):
            tasks[label] = names
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    turns = []
    for label in args.order.split(","):
        env = dict(os.environ,
                   REPRO_TORCH_BUILD=str(Path(trees[label]).resolve()
                                         / "build" / "repro_torch_kernels"))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, __file__, "--seed", str(args.seed), "--child",
             trees[label], tasks[label]], capture_output=True, text=True,
            env=env, timeout=1800)
        turn = {"label": label, "tree": trees[label], "rc": run.returncode,
                "s": time.perf_counter() - t0,
                "stderr_tail": run.stderr[-3000:],
                "stderr_profiler": [ln for ln in run.stderr.splitlines()
                                    if "uffer" in ln or "xceed" in ln
                                    or "CUPTI" in ln][:40]}
        if run.returncode == 0:
            turn.update(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    return 0 if all(t["rc"] == 0 for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
