#!/usr/bin/env python3
"""What bounds the scattering-moments kernel (csrc/scat_moments.cu) on one
NVIDIA card: the kernel beside variants of its own source with one part
cut out or changed, on the same inputs.

    python3 scripts/torch_scat_variants.py [--out variants.json]

Variants (each built from csrc/scat_moments.cu by one text substitution,
one nvcc each, in parallel, into build/pp_kernels/scat_variants/; the
script stops if a substitution no longer matches the source):
  kernel           the source as it is;
  loads_only       each harmonic's arithmetic replaced by one add of the
                   loaded values (the loads and the loop remain);
  arithmetic_only  the loads replaced by values made from the group index
                   (the arithmetic and the loop remain);
  rcp_approx       __fdividef(1, d) for the correctly rounded reciprocal;
  regs64           __launch_bounds__ capping registers at 64 a thread.
Timed at chip_smoke.py's four shapes (SCAT_SHAPES) at the wrapper's own
geometry (scat_launch_geometry): CUDA events, mean of 20 launches after 3
warm-ups, beside the byte bound.  Only `kernel` computes the moments; the
others are for timing.  Needs a card.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "pulseportraiture_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "pp_kernels", "scat_variants")


def between(src, start, end):
    """The text of src from `start` up to and including `end`."""
    i = src.index(start)
    return src[i:src.index(end, i) + len(end)]


def variants(src):
    arith = between(src, "  const float c = tk * kf;\n",
                    "fmaf(3.0f * c, c, -1.0f), acc[8]);\n")
    loads = between(src, "  const int k0 = h0 + 4 * g;\n",
                    "  q.m = load4(m, k0, nh, full && vec_m);\n")
    bounds = "__launch_bounds__(kMaxThreads)"
    rcp = "__frcp_rn(fmaf(c, c, 1.0f))"
    return {
        "kernel": src,
        "loads_only": src.replace(
            arith, "  acc[0] += x + y + mm + pr + pi + kf + tk;\n"),
        "arithmetic_only": src.replace(
            loads, "  const float v = 1e-3f * g;\n"
                   "  q.x = make_float4(v, v + 1, v + 2, v + 3);\n"
                   "  q.y = q.x;\n  q.m = q.x;\n"),
        "rcp_approx": src.replace(rcp, "__fdividef(1.0f, fmaf(c, c, 1.0f))"),
        "regs64": src.replace(bounds, "__launch_bounds__(kMaxThreads, 4)"),
    }


def build(nvcc):
    """{name: (ctypes library, ptxas registers)} of every variant."""
    with open(os.path.join(CSRC, "scat_moments.cu")) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"variant {name}: its substitution no longer "
                               "matches csrc/scat_moments.cu")
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I",
             CSRC, "-o", os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        lib.pp_scat_moments.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64,
                                        i32, i32, i32, i64, vp]
        libs[name] = (lib, sorted(set(re.findall(r"Used (\d+) registers",
                                                 log))))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_scat_variants: no card (torch.cuda.is_available() is "
              "False)")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _build
    from pulseportraiture_tpu_torch.ops import moments as mom

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = build(_build._nvcc())
    for name, (_, regs) in libs.items():
        print(f"{name}: registers {regs}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {"card": cs.card_line(), "registers": {
        n: r for n, (_, r) in libs.items()}, "shapes": {}}
    for shape, lead, nh, per_item in cs.SCAT_SHAPES:
        t = cs.scat_inputs(dev, gen, lead, nh, per_item)
        rows, m2_rows = t[0].numel(), t[4].numel() // nh
        lanes, rpb, tile = mom.scat_launch_geometry(t[0], t[4])
        out = torch.empty((9, rows), device=dev)
        ptrs = [ctypes.c_void_p(a.data_ptr()) for a in t + (out,)]
        rec = {"geometry": [lanes, rpb, tile]}
        for name, (lib, _) in libs.items():
            def run():
                err = lib.pp_scat_moments(
                    *ptrs, rows, m2_rows, nh, lanes, rpb, tile,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            rec[f"{name}_ms"] = cs.cuda_ms(run, reps=20, warm=3)
        rec["bound_ms"], rec["bound_by"] = cs.scat_bound(t[0], t[4], nh)
        res["shapes"][shape] = rec
        print(f"{shape}: {json.dumps(rec)}", flush=True)
        del t, out
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
