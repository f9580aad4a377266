#!/usr/bin/env python3
"""The scattering-moments kernel (csrc/scat_moments.cu) on one NVIDIA
card: its time over lanes per row and rows per block, beside the twin.

    python3 scripts/torch_scat_tune.py [--out tune.json]

1. Builds the kernels and prints what ptxas says of scat_moments.cu
   (registers, spills, per lane count).
2. Sweep at chip_smoke.py's four shapes (SCAT_SHAPES: B=32 x 4096
   channels against a shared M2, and 4096 items of one channel with an M2
   row each; nh=128 and 1025): lanes per row in {8, 16, 32} x threads per
   block in {32, 64, 128, 256}; with a shared M2, the rows in tiles of 4,
   16 or 64 M2 rows and in row order; and the wrapper's own choice
   (scat_geometry); CUDA events, mean of 20 launches after 3 warm-ups.
   Beside them, in the same call: the wrapper's choice with every group
   read by 32-bit loads (Gi placed 4 bytes off Gr's offset mod 16; the
   same bits), the plain float32 twin and the byte bound.
Needs a card.  (tests/test_torch_kernels.py holds every one of these
geometries against the float64 twin.)
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep(dev):
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch.ops import moments as mom

    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for name, lead, nh, per_item in cs.SCAT_SHAPES:
        t = cs.scat_inputs(dev, gen, lead, nh, per_item)
        rec = {"rows": t[0].numel(), "nh": nh}
        default = mom.scat_launch_geometry(t[0], t[4])
        m2_rows = t[4].numel() // nh
        for lanes in mom.SCAT_LANES:
            for threads in (32, 64, 128, 256):
                geo = (lanes, threads // lanes, default[2])
                rec[f"lanes{lanes}_rows{geo[1]}_ms"] = cs.cuda_ms(
                    lambda: mom._launch_scat(*t, geometry=geo), reps=20,
                    warm=3)
        if m2_rows < t[0].numel():       # the order of rows: tiles of M2 rows
            for tile in sorted({4, mom.SCAT_TILE, 64, m2_rows}):
                geo = default[:2] + (tile,)
                rec[f"tile{tile}_ms"] = cs.cuda_ms(
                    lambda: mom._launch_scat(*t, geometry=geo), reps=20,
                    warm=3)
        rec["default"] = list(default)
        rec["default_ms"] = cs.cuda_ms(lambda: mom.scattering_moments(*t),
                                       reps=20, warm=3)
        # Gi 4 bytes off Gr's offset mod 16: every group by 32-bit loads
        buf = torch.empty(t[3].numel() + 1, device=dev)
        gi = buf[1:].view(t[3].shape)
        gi.copy_(t[3])
        u = (t[0], t[1], t[2], gi, t[4])
        rec["scalar_loads_ms"] = cs.cuda_ms(
            lambda: mom.scattering_moments(*u), reps=20, warm=3)
        if not all(torch.equal(a, b) for a, b in zip(
                mom.scattering_moments(*u), mom.scattering_moments(*t))):
            raise AssertionError(f"{name}: the 32-bit loads gave other bits")
        del buf, gi, u
        rec["plain_ms"] = cs.cuda_ms(
            lambda: mom.scattering_moments_reference(*t), reps=5, warm=1)
        rec["bound_ms"], rec["bound_by"] = cs.scat_bound(t[0], t[4], nh)
        out[name] = rec
        print(f"sweep {name}: {json.dumps(rec)}", flush=True)
        del t
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_scat_tune: no card (torch.cuda.is_available() is "
              "False)")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _build

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.load_kernels()
    print(f"kernel build: {_build.build_info['seconds']:.2f} s", flush=True)
    entry = ""
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "scat_moments_kernel" in entry and ("registers" in line or
                                               "spill" in line):
            print("ptxas: " + line.strip(), flush=True)
    res = {"card": cs.card_line(), "sweep": sweep(dev)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
