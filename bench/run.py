"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Runs on the cards it is started on
(``cuda:0 .. chips-1``) and on no other device: with fewer cards than the
workload's chips, or a mesh that is not of their size, it exits with code
2 and prints no result. The last line of standard output is the run's JSON
result; the numbers compared for ``correct`` are the last lines of
standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness, power  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.fixed_caches(ROOT)
    try:
        cell = harness.load_cell(ROOT, args.workload)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    need = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    t_torch = time.perf_counter() - T0
    if found < need:
        print(f"needs {need} CUDA card(s); {found} found", file=sys.stderr)
        return 2
    cards = [power.probe(power.card_uuid(torch, i)) for i in range(need)]
    for card in cards:
        print(f"card {card['name']} ({card['card']}), power limit "
              f"{card['power_limit_w']} W", file=sys.stderr)
    print(f"torch at {t_torch:.3f} s, the cards probed at "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)
    result, rows = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t0=T0,
        power=power.Cards([c["card"] for c in cards]))
    held = harness.forbidden_modules()
    if held:
        print("the run's process holds " + ", ".join(held), file=sys.stderr)
        return 3
    for name, v, limit in rows:
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
