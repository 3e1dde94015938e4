"""Readings that a cell's limits are set from, on the chip at the cell's own
size (never part of a benchmark run):

    python3 rtbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --base-seed <n> [--out FILE]

For each of `--seeds` seeds it runs one request of the program through the
cell's entry and compares it with the float64 reference: the lower readings.
For the first `--control-seeds` of them it runs the control, whose readings
have to fail the limits: the traffic mix's "control" names it. With an
"engine" it is the program's own path one precision below the cell's (the
float32 kernels for an f64-grade cell); else the reference computed at that
"dtype" (bfloat16 for a float32 cell) in the program's place.
Each reading is a JSON line on standard output (and in FILE).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

import harness  # noqa: E402
import run  # noqa: E402


def control_numbers(spec, entry, i: int) -> dict:
    """The numbers compared for the control on request `i`'s input."""
    ctl = spec.traffic["control"]
    if ctl.get("engine"):
        ctx = copy.copy(entry.ctx)
        ctx.traffic = dict(spec.traffic, **ctl)
        prog = harness.entry_module(spec.traffic["entry"]).make(ctx)
        res = prog.request(entry.make_input(i))
        prog.close()
        return entry.check([(i, res)])
    return entry.check([(i, None)], dtype=getattr(torch, ctl["dtype"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=2**31 + 11)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    spec = harness.cell_spec(args.workload)
    ctx = run.build_context(spec, args.base_seed, "cuda")
    entry = harness.entry_module(spec.traffic["entry"]).make(ctx)
    lines = []
    for k in range(args.seeds):
        ctx.seed = args.base_seed + 7919 * k
        t0 = time.perf_counter()
        res = entry.request(entry.make_input(0))
        rec = {"cell": args.workload, "seed": ctx.seed, "side": "program",
               "numbers": entry.check([(0, res)])}
        del res
        if k < args.control_seeds:
            rec_c = {"cell": args.workload, "seed": ctx.seed,
                     "side": "control " + json.dumps(spec.traffic["control"]),
                     "numbers": control_numbers(spec, entry, 0)}
        else:
            rec_c = None
        for r in (rec, rec_c):
            if r is not None:
                r["seconds"] = time.perf_counter() - t0
                lines.append(json.dumps(r))
                print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
