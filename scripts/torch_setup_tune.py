#!/usr/bin/env python3
"""The FFT setup kernel (csrc/setup_fft.cu) on one NVIDIA card: its time
over the tile size (channels per block), beside the other routes.

    python3 scripts/torch_setup_tune.py [--nbin 2048] [--out tune.json]

1. Builds the kernels and prints what ptxas says of setup_fft.cu
   (registers, spills, shared memory).
2. Sweep, at 4096 channels x nbin bins (chip_smoke.py's data; nbin
   2048 unless --nbin names another width the FFT route takes): B=4
   (B=64 up to 512 bins) with two seed columns, capped (the band cap's
   nh, or the full band where the cap does not apply), full band and
   int16 capped; one item without seed weights, capped and full band;
   rows per block over the powers of two from 4 to 16 times the rows a
   block transforms at once (at least 64) and the wrapper's own choice
   (_fft_rows); CUDA events, mean of 20 launches after 3 warm-ups.
   Beside them, in the same call: the rfft twin and the byte bound.
Needs a card.  (tests/test_torch_kernels.py holds the kernel against its
float64 twin at small and ragged shapes.)
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep(dev, nbin):
    import numpy as np
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch.io.native import quantize_i2
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    B = 64 if nbin <= 512 else 4
    data, _, model, _, _, _ = cs.phidm_recipe(dev, B, seed=1, nbin=nbin)
    routes = cs.template_routes(model, nbin)
    capped = "capped" if "capped" in routes else "full_band"
    _, _, wpb, per_sm = sdft._fft_layout(nbin)
    sweep_rows = [4]
    while sweep_rows[-1] < 16 * max(wpb, 4):
        sweep_rows.append(2 * sweep_rows[-1])

    def on_card(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)
    w = torch.ones((B, cs.NCHAN, 2), dtype=torch.float32, device=dev)
    raw, scl, _ = quantize_i2(data.cpu().numpy())
    raw = torch.from_numpy(raw).to(dev)
    scl = torch.from_numpy(scl.astype(np.float32)).to(dev)
    x1 = data[:1].contiguous()
    cases = {"capped": (data, capped, w, None),
             "full_band": (data, "full_band", w, None),
             "i16": (raw, capped, w, scl),
             "one_item_capped": (x1, capped, None, None),
             "one_item_full_band": (x1, "full_band", None, None)}
    out = {}
    for name, (x, route, ww, sc) in cases.items():
        mr, mi = (on_card(a) for a in routes[route])
        nh = mr.shape[-1]
        rec = {"nh": nh}
        for rows in sweep_rows:
            rec[f"fft_rows{rows}_ms"] = cs.cuda_ms(
                lambda: sdft._launch_fft(x, mr, mi, False, ww, sc,
                                         rows=rows), reps=20, warm=3)
        rec["default_rows"] = sdft._fft_rows(
            x.shape[0], x.shape[1], torch.cuda.get_device_properties(
                dev).multi_processor_count, per_sm, wpb)
        rec["fft_default_ms"] = cs.cuda_ms(
            lambda: sdft._launch_fft(x, mr, mi, False, ww, sc), reps=20,
            warm=3)
        rec["rfft_twin_ms"] = cs.cuda_ms(
            lambda: sdft.fused_setup_reference(x, mr, mi, False, ww, sc),
            reps=10)
        rec["bound_ms"], rec["bound_by"] = cs.setup_bound(
            x.shape[0], nbin, nh, 0 if ww is None else 2,
            x.element_size(), sc is not None)
        out[name] = rec
        print(f"sweep {name}: {json.dumps(rec)}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nbin", type=int, default=2048,
                    help="bins (a width the FFT route takes)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_setup_tune: no card (torch.cuda.is_available() is "
              "False)")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _build

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    _build.load_kernels()
    print(f"kernel build: {_build.build_info['seconds']:.2f} s", flush=True)
    for line in _build.build_info["log"].splitlines():
        if "setup_fft" in line or "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)
    res = {"card": cs.card_line(), "nbin": args.nbin,
           "sweep": sweep(dev, args.nbin)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
