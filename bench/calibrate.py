"""The readings a cell's limits are set from, in one process on the card:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out chiprun_out/calib.json]

For each seed of ``--seeds``, one call of the cell's compiled executable
(the timed path, at the cell's own size) against the float32 reference:
the lower readings. For each seed of ``--control-seeds``, the reference
computed in bfloat16, the next precision below the configuration's,
against the float32 reference: the control's readings, the upper ones.
Each reading is ``compare.rel_err`` of every field the update changes. A
cell over a mesh is compared as its runs compare it: the reference in
slabs on the cards after the first (``bench/slabs.py``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import compare, harness, inputs, slabs  # noqa: E402


def readings(cell, seeds, control_seeds, device="cuda", grid=None) -> dict:
    import torch

    cfg, tr = cell.config, cell.traffic
    grid = tuple(int(g) for g in (grid or cfg["grid"]))
    steps = int(tr["steps"])
    writes = cfg["writes"]
    ref = harness.reference(cell.root, cfg["reference"]["module"])
    rargs = cfg["reference"].get("args", {})
    on_card = torch.device(device).type == "cuda"
    ex = harness.compile_cell(cell, grid, None if on_card else device)
    f32, low = torch.float32, torch.bfloat16
    if "mesh" in cfg:
        # as the benchmark's run compares: the reference in slabs on the
        # cards after the first
        n = harness.mesh_size(cfg)
        cards = ([torch.device("cuda", i) for i in range(n)] if on_card
                 else [torch.device(device)] * n)
        plan = slabs.plan(cfg, grid, steps, cards[1:] or cards)

    def reference(fields, scalars, coeffs, dtype):
        return ref.run(cfg["reference"]["scheme"], fields, scalars, coeffs,
                       steps, dtype=dtype, **rargs)

    def errors(f, s, c, got=None) -> dict:
        """Each changed field's ``rel_err`` against the float32 reference:
        of the program's ``got``, or of the bfloat16 reference where None."""
        if "mesh" in cfg:
            res = slabs.run(ref, cfg, f, s, c, steps, plan,
                            (f32,) if got is not None else (f32, low))
            parts = slabs.errors(res, writes,
                                 (lambda a, b, _: got[(a, b)])
                                 if got is not None
                                 else (lambda a, b, r: r[low]))
            return {k: compare.rel_err_of_parts(parts[k]) for k in writes}
        want = reference(f, s, c, f32)
        other = got if got is not None else reference(f, s, c, low)
        return {k: compare.rel_err(other[k], want[k]) for k in writes}

    out = {"workload": cell.name, "grid": list(grid), "steps": steps,
           "program": {}, "control": {}}
    for seed in seeds:
        f, s, c = inputs.make(cfg, grid, seed, device)
        res = ex(f, s, c)
        got = (slabs.park(res, writes, plan) if "mesh" in cfg
               else {k: res[k].clone() for k in writes})
        del res
        out["program"][str(seed)] = errors(f, s, c, got)
        del got
    for seed in control_seeds:
        f, s, c = inputs.make(cfg, grid, seed, device)
        out["control"][str(seed)] = errors(f, s, c)
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
