#!/usr/bin/env python3
"""The fit setup at every power-of-two width 64..8192 (or the widths
named) on one NVIDIA card, timed beside its yardsticks.

    python3 scripts/torch_setup_pow2.py [--root DIR] [--warp-worker]
        [--nbin N ...] [--batch B] [--out FILE]

At 4096 channels x nbin bins (chip_smoke.setup_inputs' data; B=64 up to
512 bins, so that a time is not one launch's latency, and B=4 above,
unless --batch names B; two seed columns), float32 rows and int16 rows
+ scale, full band and capped where the band cap applies: fused_setup on
the route the package's setup_route names, torch.fft.rfft +
cross-spectrum, the cuBLAS float32 DFT-as-GEMM and the bound
(chip_smoke.setup_bound; on the "rfft" route also the epilogue kernel
alone and the route's own bound, chip_smoke.setup_bound's "route").  CUDA
events, chip_smoke.cuda_ms.  No correctness checks: chip_smoke.py's
setup phases hold the kernels against their twins at these shapes.

--root DIR times the package of another checkout (a parent commit
unpacked with git archive), its kernels built from its own sources: a
parent whose setup_route sends a width to its DFT-as-SGEMM kernel
(csrc/setup.cu, route "gemm") times that kernel there.
--warp-worker times a copy of the root's package whose
csrc/setup_fft.cu gives every plan a worker of at least a warp (the
alternative to the packed worker of 64..512 bins), built under
build/warp_worker/.  Needs a card.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NBINS = tuple(1 << n for n in range(6, 14))
# the worker rule of csrc/setup_fft.cu, and the same rule without the
# packed worker
PACKED_RULE = ("return na < 32 && (na & (na - 1)) == 0 ? na : "
               "pow2_at_least(na);")
WARP_RULE = "return pow2_at_least(na);"


def warp_worker_copy(root):
    """A copy of root's package under build/warp_worker/ whose worker rule
    rounds every worker up to a warp; returns the copy's root."""
    dst = os.path.join(HERE, "build", "warp_worker")
    pkg = os.path.join(dst, "pulseportraiture_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "pulseportraiture_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(pkg, "csrc", "setup_fft.cu")
    with open(src) as f:
        text = f.read()
    if text.count(PACKED_RULE) != 1:
        raise SystemExit(f"{src}: the worker rule {PACKED_RULE!r} is not "
                         "there once")
    with open(src, "w") as f:
        f.write(text.replace(PACKED_RULE, WARP_RULE))
    return dst


def sweep(cs, dev, nbins, batch=None):
    import torch

    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    out = {}
    for nbin in nbins:
        B = batch or (64 if nbin <= 512 else 4)
        x, raw, scl, wt, routes = cs.setup_inputs(dev, nbin, B)
        route = sdft.setup_route(nbin)
        for tname, (mr, mi) in routes.items():
            nh = mr.shape[-1]
            E = cs.dft_matrix(nh, dev, nbin)
            for rows, xx, sc in (("f32", x, None), ("i16", raw, scl)):
                rec = dict(nbin=nbin, B=B, nh=nh, route=route)
                rec["ms"] = cs.cuda_ms(lambda: sdft.fused_setup(
                    xx, mr, mi, w=wt, scale=sc))
                if route == "rfft":
                    X = torch.fft.rfft(xx.float(), dim=-1)
                    rec["epilogue_ms"] = cs.cuda_ms(
                        lambda: sdft._launch_epilogue(X, mr, mi, False, wt,
                                                      sc))
                    del X
                    rec["route_bound_ms"], _ = cs.setup_bound(
                        B, nbin, nh, 2, xx.element_size(), sc is not None,
                        "route")
                rec["rfft_ms"] = cs.cuda_ms(
                    lambda: cs.rfft_cross_spectrum(xx, mr, mi, sc))
                rec["gemm_ms"] = cs.cuda_ms(
                    lambda: cs.gemm_cross_spectrum(xx, E, mr, mi, sc))
                rec["bound_ms"], rec["bound_by"] = cs.setup_bound(
                    B, nbin, nh, 2, xx.element_size(), sc is not None)
                name = f"{nbin}_{tname}_{rows}"
                out[name] = rec
                print(f"{name}: {json.dumps(rec)}", flush=True)
            del E
        del x, raw, scl
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed")
    ap.add_argument("--warp-worker", action="store_true",
                    help="time the root's package with warp-sized workers")
    ap.add_argument("--nbin", type=int, nargs="*", default=NBINS)
    ap.add_argument("--batch", type=int, default=None,
                    help="items a call at every width")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_setup_pow2: no card (torch.cuda.is_available() is "
              "False)")
        return 2
    root = os.path.abspath(args.root)
    if args.warp_worker:
        root = warp_worker_copy(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pulseportraiture_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    print(f"package: {_build.__file__}", flush=True)
    _build.load_kernels()
    print(f"kernel build: {_build.build_info['seconds']:.2f} s", flush=True)
    for line in _build.build_info["log"].splitlines():
        if "setup_fft" in line or "registers" in line or "spill" in line:
            print("ptxas: " + line.strip(), flush=True)
    res = {"card": card, "root": args.root, "warp_worker": args.warp_worker,
           "sweep": sweep(cs, dev, args.nbin, args.batch)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
