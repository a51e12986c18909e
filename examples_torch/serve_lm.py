"""Batched serving example: prefill + ring-buffer decode.

    PYTHONPATH=src python examples_torch/serve_lm.py \\
        --arch gemma2_2b --tokens 24
    PYTHONPATH=src python examples_torch/serve_lm.py --arch gemma3_1b
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

Uses the reduced (smoke) config of the chosen architecture, with random
weights from a seeded generator, so it also runs on the CPU; the
sliding-window layers keep bounded ring-buffer KV caches (the sequence
shift buffer) while global layers keep full caches.  On the H100 a local
layer whose prompt is longer than its window and which has no logit
softcap runs the hand-written sliding-window attention kernel in the
prefill (``gemma3_1b``'s smoke config: window 8, 12-token prompts).
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_smoke
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import ServeEngine, init_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b",
                    choices=[a for a in ARCHS if a != "whisper_small"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch)
    params = init_lm(cfg, torch.Generator(device).manual_seed(0), device)
    engine = ServeEngine(cfg, params, batch=args.batch, max_len=256,
                         temperature=args.temperature, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, 12)).astype(np.int32)
    out = engine.generate(prompts, max_new_tokens=args.tokens, seed=1)
    for i, row in enumerate(out):
        print(f"seq {i}: {row.tolist()}")
    print(f"decoded {engine.stats.decode_tokens} tokens "
          f"(prefill {engine.stats.prefill_tokens})")
    print("serve_lm OK")
    return out


if __name__ == "__main__":
    main()
