"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python examples_torch/train_lm.py --preset tiny --steps 30
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 3

Full production loop: synthetic (restartable) data pipeline, AdamW with
cosine schedule, grad clipping, async atomic checkpoints every 50 steps,
auto-resume — kill it mid-run and re-launch to see recovery.  On the H100
a local layer whose sequence is longer than its window runs the
hand-written sliding-window attention kernels, forward and backward.
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import resolve_device
from repro_torch.data import BatchSpec, SyntheticLM
from repro_torch.train import OptConfig, TrainConfig, Trainer


def preset(name: str):
    if name == "tiny":        # CI-speed sanity run
        cfg = ModelConfig(name="tiny-lm", n_layers=2, d_model=128,
                          n_heads=4, n_kv_heads=2, d_ff=256, vocab=2048,
                          window=64, layer_pattern=("local",))
        spec = BatchSpec(global_batch=8, seq_len=64, vocab=cfg.vocab)
        return cfg, spec
    if name == "100m":        # ~100M params (danube-family reduction)
        cfg = ModelConfig(name="lm-100m", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000,
                          window=1024, layer_pattern=("local",))
        spec = BatchSpec(global_batch=4, seq_len=256, vocab=cfg.vocab)
        return cfg, spec
    raise KeyError(name)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, spec = preset(args.preset)
    print(f"model {cfg.name}: {cfg.num_params()/1e6:.1f}M params")
    tcfg = TrainConfig(
        opt=OptConfig(lr=3e-4, warmup_steps=20, total_steps=max(args.steps,
                                                                100)),
        ckpt_every=50, ckpt_dir=args.ckpt_dir, log_every=10)
    trainer = Trainer(cfg, tcfg, SyntheticLM(spec, seed=0), device=device)
    if trainer.step:
        print(f"resumed from checkpoint at step {trainer.step}")
    hist = trainer.run(args.steps)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    print("train_lm OK")
    return hist


if __name__ == "__main__":
    main()
