"""The readings a cell's limits are set from, in one process on the card:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out chiprun_out/calib.json]

For each seed of ``--seeds``, one call of the cell's compiled executable
(the timed path, at the cell's own size) against the float32 reference:
the lower readings. For each seed of ``--control-seeds``, the reference
computed in bfloat16, the next precision below the configuration's,
against the float32 reference: the control's readings, the upper ones.
Each reading is ``compare.rel_err`` of every field the update changes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import compare, harness, inputs  # noqa: E402


def readings(cell, seeds, control_seeds, device="cuda", grid=None) -> dict:
    import torch

    cfg, tr = cell.config, cell.traffic
    grid = tuple(int(g) for g in (grid or cfg["grid"]))
    steps = int(tr["steps"])
    ref = harness.reference(cell.root, cfg["reference"]["module"])
    rargs = cfg["reference"].get("args", {})
    on_card = torch.device(device).type == "cuda"
    ex = harness.compile_cell(cell, grid, None if on_card else device)

    def reference(fields, scalars, coeffs, dtype):
        return ref.run(cfg["reference"]["scheme"], fields, scalars, coeffs,
                       steps, dtype=dtype, **rargs)

    out = {"workload": cell.name, "grid": list(grid), "steps": steps,
           "program": {}, "control": {}}
    for seed in seeds:
        f, s, c = inputs.make(cfg, grid, seed, device)
        got = {k: v.clone() for k, v in ex(f, s, c).items()
               if k in cfg["writes"]}
        want = reference(f, s, c, torch.float32)
        out["program"][str(seed)] = {k: compare.rel_err(got[k], want[k])
                                     for k in cfg["writes"]}
        del got, want
    for seed in control_seeds:
        f, s, c = inputs.make(cfg, grid, seed, device)
        want = reference(f, s, c, torch.float32)
        low = reference(f, s, c, torch.bfloat16)
        out["control"][str(seed)] = {k: compare.rel_err(low[k], want[k])
                                     for k in cfg["writes"]}
        del want, low
    worst = [max(v.values()) for v in out["program"].values()]
    ctrl = [max(v.values()) for v in out["control"].values()]
    out["lower"] = max(worst) if worst else None
    out["upper"] = min(ctrl) if ctrl else None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.fixed_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    t = time.perf_counter()
    res = readings(cell, ints(args.seeds), ints(args.control_seeds))
    res["seconds"] = time.perf_counter() - t
    res["card"] = torch.cuda.get_device_name()
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(json.dumps({k: res[k] for k in ("workload", "lower", "upper",
                                          "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
