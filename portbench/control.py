#!/usr/bin/env python3
"""Readings from which a cell's comparison limits are set.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--out readings.json]

For each seed, in one process on the card: the cell's pool made from the
seed, each pool batch fitted once by the program through the cell's own
entry (as the window calls it), and fitted by the plain reference three
times: in float64 (the reference), in TF32 (the control: the reference in
the precision below the configuration's float32) and in plain float32
(the witness: what float32 arithmetic alone gives).  Prints, a seed, the
largest of each compared number over every answer, for the program, the
control and the witness, each against the float64 reference (every
number compare.numbers gives, the cell's limits or not), the
reference's seconds and its most Newton iterations.  The benchmark's
own runs do not run this.
"""

# the precisions the plain reference is run in besides float64
OTHERS = {"control": "tf32", "witness": "float32"}

import argparse
import contextlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed, device):
    """{"program": {number: largest}, "control": {...}, "witness": {...},
    "seconds": ..., "newton_iterations": ...}."""
    from portbench import compare
    split = {}
    entry = cell.entry().Entry(cell.config, cell.mix, seed, device, split)
    for j in range(cell.mix["pool"]):
        entry.call(j, lambda _: contextlib.nullcontext())
        entry.keep()
    entry.release()
    out = {who: {} for who in ("program", *OTHERS)}
    secs = {who: 0.0 for who in ("reference", *OTHERS)}
    iters = {who: 0 for who in ("reference", *OTHERS)}
    for j in range(cell.mix["pool"]):
        t = time.perf_counter()
        ref = entry.reference_fit(j)
        secs["reference"] += time.perf_counter() - t
        iters["reference"] = max(iters["reference"], ref.iters)
        answers = {"program": [a for a in entry.answers if a["pool"] == j]}
        for who, precision in OTHERS.items():
            t = time.perf_counter()
            got = entry.reference_fit(j, precision=precision)
            secs[who] += time.perf_counter() - t
            iters[who] = max(iters[who], got.iters)
            answers[who] = [{"pool": j, "params": got.params.cpu().numpy(),
                             "cov": got.cov.cpu().numpy(),
                             "nu_DM": got.nu_DM.cpu().numpy(),
                             "nu_tau": got.nu_tau.cpu().numpy(),
                             "red_chi2": got.red_chi2.cpu().numpy()}]
        for who, ans in answers.items():
            nums = entry.numbers(ans, ref)
            _, worst = compare.judge(nums, {n: math.inf for n in nums})
            out[who] = {n: max(out[who].get(n, 0.0), worst[n])
                        for n in worst}
    out["seconds"] = secs
    out["newton_iterations"] = iters
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench.run import Cell
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    rec = {}
    for seed in args.seeds:
        rec[seed] = readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **rec[seed]}), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
