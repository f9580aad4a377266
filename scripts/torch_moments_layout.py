#!/usr/bin/env python
"""On the card: the phase-moments kernel on split Gr/Gi streams against
the merged single-stream layout g = [Gr | Gi], against copy ceilings.

    python scripts/torch_moments_layout.py [--root DIR] [--out layout.json]

The counterpart of scripts/tpu_moments_layout.py for the port.  At the
probe's shape (B=16 items x 4096 channels, 2048 bins) and at nh=1024 (the
full band without its Nyquist term) and nh=128 (the capped prefix), with
CUDA events:
  * a two-stream and a one-stream torch.sum over the same bytes (what a
    plain reduction reaches on two pointers and on one);
  * ops.moments.phase_moments (split: csrc/moments.cu) and
    ops.moments.phase_moments_merged (merged: csrc/moments_merged.cu),
    in turns (split, merged, merged, split), twice; and the merged kernel
    on a copy of g that starts 4 bytes off a 16-byte boundary, which
    takes its scalar loads: one stream without the 128-bit loads;
  * GB/s of each over the 8 bytes per harmonic both layouts read, and the
    largest difference between the two kernels' outputs relative to the
    largest output.
Prints the card's name and power limit.  --root DIR times the package
of another checkout (a parent commit unpacked with git archive), its
kernels built from its own sources: run parent, tree, tree, parent in
one call to compare two versions on one card.  Needs a card: it stops
without one.  Storage formats are not changed here: the fits keep Gr and Gi
apart, the narrowband fitters build the merged stream themselves.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NCHAN, B = 4096, 16


def cuda_ms(fn, reps=20, warm=3):
    """Mean milliseconds per call by CUDA events over reps launches."""
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_moments_layout: torch.cuda.is_available() is False")
        return 2
    from pulseportraiture_tpu_torch.ops import moments as mom

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"package: {mom.__file__}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card, "root": args.root, "shapes": []}
    for nh in (1024, 128):
        f32 = dict(dtype=torch.float32, device=dev, generator=gen)
        g = torch.randn((B, NCHAN, 2 * nh), **f32)
        Gr, Gi = g[..., :nh].contiguous(), g[..., nh:].contiguous()
        phis = torch.rand((B, NCHAN), **f32) - 0.5
        nbytes = B * NCHAN * nh * 8
        rec = {"nh": nh, "rows": B * NCHAN, "bytes": nbytes}

        def gbs(ms):
            return nbytes / (ms * 1e-3) / 1e9

        t2 = cuda_ms(lambda: torch.sum(Gr, dim=-1) + torch.sum(Gi, dim=-1))
        t1 = cuda_ms(lambda: torch.sum(g, dim=-1))
        rec.update(sum_two_streams_ms=t2, sum_one_stream_ms=t1)
        print(f"nh={nh:5d} torch.sum two streams {t2:8.4f} ms "
              f"{gbs(t2):7.1f} GB/s", flush=True)
        print(f"nh={nh:5d} torch.sum one stream  {t1:8.4f} ms "
              f"{gbs(t1):7.1f} GB/s", flush=True)
        split = mom.phase_moments(phis, Gr, Gi)
        merged = mom.phase_moments_merged(phis, g)
        torch.cuda.synchronize()
        rel = max(float((m - s).abs().max() / s.abs().max())
                  for m, s in zip(merged, split))
        ts, tm = [], []
        for _ in range(2):          # split, merged, merged, split
            ts.append(cuda_ms(lambda: mom.phase_moments(phis, Gr, Gi)))
            tm.append(cuda_ms(lambda: mom.phase_moments_merged(phis, g)))
            tm.append(cuda_ms(lambda: mom.phase_moments_merged(phis, g)))
            ts.append(cuda_ms(lambda: mom.phase_moments(phis, Gr, Gi)))
        buf = torch.empty(g.numel() + 1, dtype=torch.float32, device=dev)
        g_off = buf[1:].view(g.shape)
        g_off.copy_(g)
        t_sc = cuda_ms(lambda: mom.phase_moments_merged(phis, g_off))
        rec.update(split_ms=ts, merged_ms=tm, merged_scalar_loads_ms=t_sc,
                   max_rel_diff=rel)
        print(f"nh={nh:5d} kernel split  {min(ts):8.4f}..{max(ts):8.4f} ms "
              f"{gbs(max(ts)):7.1f}..{gbs(min(ts)):7.1f} GB/s", flush=True)
        print(f"nh={nh:5d} kernel merged {min(tm):8.4f}..{max(tm):8.4f} ms "
              f"{gbs(max(tm)):7.1f}..{gbs(min(tm)):7.1f} GB/s  largest "
              f"relative difference from split {rel:.1e}", flush=True)
        print(f"nh={nh:5d} kernel merged, scalar loads {t_sc:8.4f} ms "
              f"{gbs(t_sc):7.1f} GB/s", flush=True)
        out["shapes"].append(rec)
        del g, Gr, Gi, buf, g_off
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
