#!/usr/bin/env python3
"""Readings from which the pipeline cell's comparison limits are set.

    python3 portbench/control_toa.py --workload lband_pipe_phidm \
        --seeds 1 2 3 ... [--out readings.json]

control.py's counterpart for cells whose answers are TOA lines (the
get_toas entry).  For each seed, in one process on the card: the cell's
pool made from the seed, each pool entry run once by the program through
the cell's entry (as the window calls it), and each archive's lines made
by the plain reference three times: in float64 (the reference), in TF32
(the control) and in plain float32 (the witness).  Prints, a seed, the
largest of each compared number over every line for the program, the
control and the witness, each against the float64 reference, and the
reference's seconds.  The benchmark's own runs do not run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the precisions the plain reference is run in besides float64
OTHERS = {"control": "tf32", "witness": "float32"}


def readings(cell, seed, device):
    """{"program": {number: largest}, "control": {...}, "witness": {...},
    "seconds": {...}}."""
    split = {}
    entry = cell.entry().Entry(cell.config, cell.mix, seed, device, split)
    npool = cell.mix["pool"]
    for j in range(npool):
        entry.call(j, lambda _: contextlib.nullcontext())
        entry.keep()
    entry.release()
    out = {who: {} for who in ("program", *OTHERS)}
    secs = {who: 0.0 for who in ("reference", *OTHERS)}
    k, nsub = cell.mix["archives_per_call"], cell.mix["subints"]
    every = [(a, s) for a in range(k) for s in range(nsub)]
    for j in range(npool):
        t = time.perf_counter()
        ref = entry.reference_lines(j)
        secs["reference"] += time.perf_counter() - t
        answers = {"program": entry.answers[j]}
        for who, precision in OTHERS.items():
            t = time.perf_counter()
            got = entry.reference_lines(j, precision)
            secs[who] += time.perf_counter() - t
            answers[who] = dict(pool=j, subint=every, lines={
                n: [float(got[a][n][s]) for a, s in every]
                for n in got[0]})
        for who, ans in answers.items():
            nums = entry.numbers(ans, ref)
            out[who] = {n: max(out[who].get(n, 0.0), float(v.max()))
                        for n, v in nums.items()}
    out["seconds"] = secs
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
        print("control_toa: no CUDA card", file=sys.stderr)
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
