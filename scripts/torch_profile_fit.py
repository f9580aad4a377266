#!/usr/bin/env python3
"""Where the device time of one warm batched fit goes, on one NVIDIA card.

    python3 scripts/torch_profile_fit.py [--nbin N [--batch B]]
        [--out profile.json]

Profiles (torch.profiler, CPU + CUDA activities) one warm batch of the
port's fit_portrait_full_batch at 4096 channels x 2048 bins, float32,
template spectrum resident on the card, for:
  * the (phi, DM) fit, B=64, on bench.py's data recipe (chip_smoke.py);
  * the (phi, DM, GM) fit, B=64, on the same recipe with a GM injected
    (chip_smoke.gm_recipe);
  * the scattering fit (phi, DM, tau, alpha), B=32, on
    scripts/tpu_scaling.py's --scat recipe (chip_smoke.py);
each with the band-capped and the full-band template spectrum; and for
one narrowband subint (the first item of the scattering recipe, 4096
channels as 4096 rows):
  * fitters.phase_shift.fit_phase_shift_batch (FFTFIT: two rffts, the
    brute-grid product, 7 launches of the merged-stream moments kernel);
  * the per-channel scattering fits of get_narrowband_TOAs(fit_scat=True):
    4096 single-channel (phi, tau) items in one fit_portrait_full_batch,
    band-capped template, started from the FFTFIT phases.
The data recipes are chip_smoke.py's own (phidm_recipe, gm_recipe,
scat_recipe).  --nbin N profiles only the (phi, DM) fit, at 4096
channels x N bins (both templates where the band cap applies, else the
full band), B items (--batch, default 64).
Prints, per case: the batch's unprofiled wall ms (host clock to a
synchronize, median of 3) and its profiled wall ms (the profiler slows
the host), device busy ms (the union of kernel intervals), the setup
kernels' (either route's hand kernels, with their seed and data-power
reductions), the library FFT kernels' (cuFFT: the rfft route's
transform, and any other FFT), the moments kernel's and all other
kernels' ms, the kernel
launch count, and the idle share 1 - busy/wall against each wall
(idle_share: the unprofiled wall; idle_share_profiled).  Needs a card.
"""

import argparse
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def union_ms(intervals):
    """Total length [ms] of a union of (start, end) intervals in us."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile(run):
    """Time three unprofiled calls of run() and profile a fourth, after
    two warm calls; returns a dict."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_plain = statistics.median(walls)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    iv = [(e.time_range.start, e.time_range.end) for e in kernels]
    by = {"setup": 0.0, "fft": 0.0, "moments": 0.0, "other": 0.0}
    for e in kernels:
        dt = (e.time_range.end - e.time_range.start) / 1e3
        if "setup_" in e.name or "_reduce_epilogue" in e.name or \
                "seed_reduce" in e.name:
            by["setup"] += dt
        elif "fft" in e.name.lower():
            by["fft"] += dt
        elif "moments" in e.name and "kernel" in e.name:
            by["moments"] += dt
        else:
            by["other"] += dt
    busy = union_ms(iv)
    return dict(wall_ms=wall_plain, wall_profiled_ms=wall, busy_ms=busy,
                setup_ms=by["setup"], fft_ms=by["fft"],
                moments_ms=by["moments"],
                other_ms=by["other"], kernels=len(kernels),
                idle_share=1.0 - busy / wall_plain,
                idle_share_profiled=1.0 - busy / wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nbin", type=int, default=None,
                    help="only the (phi, DM) fit, at this width")
    ap.add_argument("--batch", type=int, default=64,
                    help="items of the --nbin (phi, DM) batch")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_fit: no card (torch.cuda.is_available() is "
              "False)")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pulseportraiture_tpu_torch.fitters.portrait import \
        fit_portrait_full_batch

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    N, P = cs.NCHAN, cs.P
    t32 = dict(dtype=torch.float32, device=dev)
    out = {}

    def on_card(mft):
        return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.float32, device=dev)
                     for a in mft)

    # (phi, DM), B=64 (--batch with --nbin): bench.py's recipe
    B = args.batch if args.nbin else 64
    nbin = args.nbin or cs.NBIN
    at = "" if nbin == cs.NBIN else f"/nbin{nbin}"
    data, freqs, model, _, _, _ = cs.phidm_recipe(dev, B, nbin=nbin)
    for name, mft in cs.template_routes(model, nbin).items():
        mft = on_card(mft)
        rec = profile(lambda: fit_portrait_full_batch(
            data, mft, torch.zeros((B, 5), **t32),
            torch.full((B,), P, **t32), freqs.float(),
            torch.full((B, N), cs.NOISE, **t32)))
        out[f"phi_dm/{name}/B{B}{at}"] = rec
        print(f"phi_dm {name} B={B}{at}: {json.dumps(rec)}", flush=True)
    del data
    if args.nbin is not None:
        return write(args.out, cs.card_line(), out)

    # (phi, DM, GM), B=64: chip_smoke.py's gm_recipe
    data, freqs, model, _, _, _, _ = cs.gm_recipe(dev, B)
    for name, mft in cs.template_routes(model).items():
        mft = on_card(mft)
        rec = profile(lambda: fit_portrait_full_batch(
            data, mft, torch.zeros((B, 5), **t32),
            torch.full((B,), P, **t32), freqs.float(),
            torch.full((B, N), cs.NOISE, **t32), fit_flags=(1, 1, 1, 0, 0)))
        out[f"phi_dm_gm/{name}/B{B}"] = rec
        print(f"phi_dm_gm {name} B={B}: {json.dumps(rec)}", flush=True)
    del data

    # the scattering fit, B=32: scripts/tpu_scaling.py --scat
    B = 32
    data, freqs, model = cs.scat_recipe(dev, B)
    init = torch.zeros((B, 5), **t32)
    init[:, 3], init[:, 4] = math.log10(0.5 * cs.TAU0), cs.ALPHA0
    for name, mft in cs.template_routes(model).items():
        mft = on_card(mft)
        rec = profile(lambda: fit_portrait_full_batch(
            data, mft, init, torch.full((B,), P, **t32), freqs.float(),
            torch.full((B, N), cs.NOISE, **t32), fit_flags=(1, 1, 0, 1, 1),
            log10_tau=True))
        out[f"scattering/{name}/B{B}"] = rec
        print(f"scattering {name} B={B}: {json.dumps(rec)}", flush=True)
    # one narrowband subint: 4096 channels as rows / single-channel items
    from pulseportraiture_tpu_torch.fitters.phase_shift import \
        fit_phase_shift_batch
    x = data[0].contiguous()
    model_t = torch.as_tensor(model, **t32)
    noise = torch.full((N,), cs.NOISE, **t32)
    rec = profile(lambda: fit_phase_shift_batch(x, model_t, noise=noise))
    out["narrowband/fftfit/rows4096"] = rec
    print(f"narrowband fftfit rows={N}: {json.dumps(rec)}", flush=True)
    mr, mi = on_card(cs.template_routes(model)["capped"])
    nu = freqs.float()
    init = torch.zeros((N, 5), **t32)
    init[:, 0] = fit_phase_shift_batch(x, model_t, noise=noise).phase
    init[:, 3] = torch.log10(0.5 * cs.TAU0 * (nu / 1500.0) ** cs.ALPHA0)
    init[:, 4] = cs.ALPHA0
    niter = []

    def scat_items():
        res = fit_portrait_full_batch(
            x[:, None, :], (mr[:, None, :], mi[:, None, :]), init,
            torch.full((N,), P, **t32), nu[:, None], noise[:, None],
            nu_fits=nu[:, None].expand(N, 3), fit_flags=(1, 0, 0, 1, 0),
            log10_tau=True, seed_phase=False)
        niter.append(res.niter)
    rec = profile(scat_items)
    rec["max_niter"] = int(niter[-1].max())
    rec["mean_niter"] = float(niter[-1].double().mean())
    out["narrowband/fit_scat/items4096"] = rec
    print(f"narrowband fit_scat items={N}: {json.dumps(rec)}", flush=True)
    return write(args.out, cs.card_line(), out)


def write(path, card, cases):
    """The cases as JSON to path (when one is given); returns 0."""
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(card=card, cases=cases), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
