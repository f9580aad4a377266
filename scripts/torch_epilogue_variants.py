#!/usr/bin/env python3
"""What bounds the setup epilogue (csrc/setup_epilogue.cu) on one NVIDIA
card: the kernel beside variants of its own source with one part cut out
or changed, on the same spectrum, at the rfft route's widths.

    python3 scripts/torch_epilogue_variants.py [--root DIR ...]
        [--nhf N ...] [--batch B] [--rows R ...] [--out FILE]

Each --root (default: this checkout) names a checkout whose package is
timed: its csrc/setup_epilogue.cu is built once as it is and once for
each variant whose text substitutions match that source (one nvcc each,
in parallel, into build/pp_kernels/epilogue_variants/), and every
variant is launched through that package's own wrapper
(setup_dft._launch_epilogue, with its tile and thread geometry) by
handing the wrapper the variant's library.  Variants:
  kernel       the source as it is;
  no_store     Gr/Gi not stored (the cross-spectrum still feeds the seed
               sums);
  no_load      X and the model not read: values made from the harmonic
               and the row instead (the stores and the seed sums remain);
  no_sd        the data power neither reduced nor written;
  no_seed      the same source launched with K = 0 (no seed sums, no
               scratch, no second pass);
  rows<n>      the same source with n channels a tile (the wrapper's rule
               replaced);
and, per source, variants of its own structure where it has them
(unroll1 / unroll8 for the earlier kernel's row loop; lb1, unroll2,
no_model, ldcg, stream_x and stream for the current kernel's register
cap, step loop, model loads and cache hints; see VARIANTS).  Only
`kernel` (and rows<n>, no_seed) compute the outputs; the others are for
timing.

Inputs: a random spectrum X (B, 4096, nhf) complex64 and a model (4096,
nhf) float32 (the full band: nh = nhf), seed weights (B, 4096, 2) and,
for the int16 rows, a scale (B, 4096); default B = 4 and nhf 2305 and
8193 (4608 and 16384 bins, the rfft route's widths that the design is
judged at) with 2304 / 2306 and 8192 / 8194 beside them: an even nhf
starts every row on a 16-byte boundary, and 8192 fills the old kernel's
last chunk.  CUDA events (chip_smoke.cuda_ms, 20 launches after 3
warm-ups) beside chip_smoke.setup_bound(..., part="epilogue").  Needs a
card.
"""

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "pp_kernels", "epilogue_variants")
NHFS = (2304, 2305, 2306, 8192, 8193, 8194)

# (name, [(old, new), ...]): a variant is built for a source when every
# `old` occurs in it exactly once; the first form of each pair is the
# earlier kernel's (scalar stores inside cross(), the pair load), the
# second the current one's (128-bit accesses, groups of 4 harmonics)
NEW_STORES = """      if (vec_g && k0 >= 0 && k0 + 4 <= nh) {
        *reinterpret_cast<float4*>(pr + k0) =
            make_float4(gr[0], gr[1], gr[2], gr[3]);
        *reinterpret_cast<float4*>(pi + k0) =
            make_float4(gi[0], gi[1], gi[2], gi[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (k0 + m >= 0 && k0 + m < nh) {
            pr[k0 + m] = gr[m];
            pi[k0 + m] = gi[m];
          }
      }
"""
NEW_SD = """    float t = sdp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(kFull, t, off);
    if ((lane & 31) == 0) sdw[grp + a.groups * u][lane >> 5] = t;
"""
VARIANTS = [
    ("no_store", [("  gr[k] = g.x;\n  gi[k] = g.y;\n", "")]),
    ("no_store", [(NEW_STORES, "      (void)pr;\n      (void)pi;\n")]),
    ("no_load", [
        ("      load_pair(xr, k, nhf, vec, &v0, &v1);\n",
         "      v0 = make_float2(1e-3f * k, 1e-3f * r);\n"
         "      v1 = make_float2(1e-3f * (k + 1), 2e-3f * r);\n"),
        ("  const float a = __ldg(mr + k);\n"
         "  const float m = __ldg(mi + k);\n",
         "  const float a = 1e-4f * k;\n  const float m = 2e-4f * k;\n")]),
    ("no_load", [
        ("    if (!owner || g >= gend) return;\n",
         "    if (!owner || g >= gend) return;\n"
         "#pragma unroll\n"
         "    for (int m = 0; m < 4; ++m) {\n"
         "      st.x[m] = make_float2(1e-3f * (k0 + m), 1e-3f * u);\n"
         "      st.mr[m] = 1e-4f * (k0 + m);\n"
         "      st.mi[m] = 2e-4f * (k0 + m);\n"
         "    }\n"
         "    if (u >= 0) return;\n")]),
    ("no_sd", [
        ("#pragma unroll\n      for (int off = 16; off > 0; off >>= 1)\n"
         "        p += __shfl_xor_sync(kFull, p, off);\n"
         "      if ((lane & 31) == 0) sdacc[r][lane >> 5] += p;\n", "")]),
    ("no_sd", [(NEW_SD, "")]),
    # the earlier kernel: how many rows' loads the compiler may overlap
    ("unroll1", [("#pragma unroll 4\n    for (int r = g;",
                  "#pragma unroll 1\n    for (int r = g;")]),
    ("unroll8", [("#pragma unroll 4\n    for (int r = g;",
                  "#pragma unroll 8\n    for (int r = g;")]),
    # the current kernel: no cap of 64 registers; two rows' steps unrolled
    # (their loads may overlap); the model not read; X and the model read
    # through L2 only; X read, and Gr/Gi written, with streaming
    # (evict-first) cache hints
    ("lb1", [("__launch_bounds__(kMaxThreads, 2)",
              "__launch_bounds__(kMaxThreads)")]),
    ("unroll2", [("  for (int u = 0; u < per; ++u) {\n    for (int j = 0;",
                  "#pragma unroll 2\n  for (int u = 0; u < per; ++u) {\n"
                  "    for (int j = 0;")]),
    ("no_model", [
        ("      const float4 u = "
         "__ldg(reinterpret_cast<const float4*>(pr + k0));\n"
         "      const float4 v = "
         "__ldg(reinterpret_cast<const float4*>(pi + k0));\n",
         "      const float4 u = "
         "make_float4(1e-4f * k0, 1e-4f, 1e-4f, 1e-4f);\n"
         "      const float4 v = "
         "make_float4(2e-4f * k0, 2e-4f, 2e-4f, 2e-4f);\n")]),
    ("ldcg", [
        ("__ldg(reinterpret_cast<const float4*>(xr + k0));",
         "__ldcg(reinterpret_cast<const float4*>(xr + k0));"),
        ("__ldg(reinterpret_cast<const float4*>(xr + k0 + 2));",
         "__ldcg(reinterpret_cast<const float4*>(xr + k0 + 2));"),
        ("__ldg(reinterpret_cast<const float4*>(pr + k0));",
         "__ldcg(reinterpret_cast<const float4*>(pr + k0));"),
        ("__ldg(reinterpret_cast<const float4*>(pi + k0));",
         "__ldcg(reinterpret_cast<const float4*>(pi + k0));")]),
    ("stream_x", [
        ("__ldg(reinterpret_cast<const float4*>(xr + k0));",
         "__ldcs(reinterpret_cast<const float4*>(xr + k0));"),
        ("__ldg(reinterpret_cast<const float4*>(xr + k0 + 2));",
         "__ldcs(reinterpret_cast<const float4*>(xr + k0 + 2));")]),
    ("stream", [
        ("__ldg(reinterpret_cast<const float4*>(xr + k0));",
         "__ldcs(reinterpret_cast<const float4*>(xr + k0));"),
        ("__ldg(reinterpret_cast<const float4*>(xr + k0 + 2));",
         "__ldcs(reinterpret_cast<const float4*>(xr + k0 + 2));"),
        ("        *reinterpret_cast<float4*>(pr + k0) =\n"
         "            make_float4(gr[0], gr[1], gr[2], gr[3]);\n"
         "        *reinterpret_cast<float4*>(pi + k0) =\n"
         "            make_float4(gi[0], gi[1], gi[2], gi[3]);\n",
         "        __stcs(reinterpret_cast<float4*>(pr + k0),\n"
         "               make_float4(gr[0], gr[1], gr[2], gr[3]));\n"
         "        __stcs(reinterpret_cast<float4*>(pi + k0),\n"
         "               make_float4(gi[0], gi[1], gi[2], gi[3]));\n")]),
]


def variants(src):
    """{name: text} of the variants whose substitutions all match src."""
    out = {"kernel": src}
    for name, subs in VARIANTS:
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                break
            text = text.replace(old, new)
        else:
            out[name] = text
    return out


def build(nvcc, root, tag):
    """{name: (ctypes library, ptxas lines)} of every variant of root's
    csrc/setup_epilogue.cu."""
    csrc = os.path.join(root, "pulseportraiture_tpu_torch", "csrc")
    with open(os.path.join(csrc, "setup_epilogue.cu")) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        cu = os.path.join(OUT, f"{tag}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I",
             csrc, "-o", os.path.join(OUT, f"{tag}_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tag} variant {name}:\n{log}")
        libs[name] = (ctypes.CDLL(os.path.join(OUT, f"{tag}_{name}.so")),
                      [ln.strip() for ln in log.splitlines()
                       if re.search(r"registers|spill|Compiling entry", ln)])
    return libs


def load_root(root):
    """root's package, imported fresh (its own modules, not another
    root's)."""
    for mod in [m for m in sys.modules
                if m.split(".")[0] == "pulseportraiture_tpu_torch"]:
        del sys.modules[mod]
    sys.path.insert(0, root)
    try:
        build_mod = importlib.import_module(
            "pulseportraiture_tpu_torch._build")
        sdft = importlib.import_module(
            "pulseportraiture_tpu_torch.ops.setup_dft")
    finally:
        sys.path.remove(root)
    return build_mod, sdft


def inputs(dev, gen, B, nchan, nhf):
    import torch

    X = torch.randn((B, nchan, nhf), dtype=torch.complex64, device=dev,
                    generator=gen)
    mr = torch.randn((nchan, nhf), device=dev, generator=gen)
    mi = torch.randn((nchan, nhf), device=dev, generator=gen)
    w = torch.rand((B, nchan, 2), device=dev, generator=gen) + 0.5
    sc = torch.rand((B, nchan), device=dev, generator=gen) + 0.5
    return X, mr, mi, w, sc


def tiles(sdft, B, nchan, nhf, dev):
    """The channels a tile the package's own rule gives (K = 2)."""
    import torch

    if hasattr(sdft, "epilogue_geometry"):
        return sdft.epilogue_geometry(B, nchan, nhf, nhf, 2, dev).rows
    return sdft._epilogue_rows(B, nchan, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def set_tiles(sdft, rows):
    """Make the package's wrapper use tiles of `rows` channels (None: its
    own rule); returns what undoes it."""
    if rows is None:
        return lambda: None
    if hasattr(sdft, "epilogue_geometry"):
        orig = sdft.epilogue_geometry

        def geometry(B, nchan, *a):
            return orig(B, nchan, *a)._replace(
                rows=rows, ntile=sdft._epilogue_ntile(nchan, rows))
        sdft.epilogue_geometry = geometry
    else:
        orig = sdft._epilogue_rows
        sdft._epilogue_rows = lambda *a: rows

    def restore():
        if hasattr(sdft, "epilogue_geometry"):
            sdft.epilogue_geometry = orig
        else:
            sdft._epilogue_rows = orig
    return restore


def time_root(cs, root, tag, dev, nhfs, B, rows_sweep):
    import torch

    build_mod, sdft = load_root(root)
    main_lib = build_mod.load_kernels()
    libs = build(build_mod._nvcc(), root, tag)
    rec = {"root": root, "ptxas": {n: p for n, (_, p) in libs.items()},
           "widths": {}}
    for name, (_, p) in libs.items():
        print(f"[{tag}] {name}: " + "; ".join(p), flush=True)
    wrapped = {}
    for name, (lib, _) in libs.items():
        fn = lib.pp_setup_epilogue
        fn.argtypes = main_lib.pp_setup_epilogue.argtypes
        fn.restype = main_lib.pp_setup_epilogue.restype
        # the launch geometry (blocks an SM) stays the package's own
        wrapped[name] = types.SimpleNamespace(
            pp_setup_epilogue=fn, pp_error_string=main_lib.pp_error_string,
            pp_setup_epilogue_blocks_per_sm=getattr(
                main_lib, "pp_setup_epilogue_blocks_per_sm", None))
    gen = torch.Generator(device=dev).manual_seed(12)
    for nhf in nhfs:
        X, mr, mi, w, sc = inputs(dev, gen, B, cs.NCHAN, nhf)
        nbin = 2 * (nhf - 1)
        out = {"rows": tiles(sdft, B, cs.NCHAN, nhf, dev)}
        for rows, scale in (("f32", None), ("i16", sc)):
            cases = [(n, n, w, None) for n in wrapped]
            cases.append(("no_seed", "kernel", None, None))
            cases += [(f"rows{r}", "kernel", w, r) for r in rows_sweep
                      if r <= getattr(sdft, "EPI_MAX_ROWS", 64)]
            for name, lib, wt, tile in cases:
                build_mod.load_kernels = lambda lib=lib: wrapped[lib]
                restore = set_tiles(sdft, tile)
                try:
                    out[f"{name}_{rows}_ms"] = cs.cuda_ms(
                        lambda: sdft._launch_epilogue(X, mr, mi, False, wt,
                                                      scale), reps=20,
                        warm=3)
                finally:
                    build_mod.load_kernels = lambda: main_lib
                    restore()
            bnd, _ = cs.setup_bound(B, nbin, nhf, 2, 4, scale is not None,
                                    "epilogue")
            out[f"bound_{rows}_ms"] = bnd
            out[f"share_{rows}"] = bnd / out[f"kernel_{rows}_ms"]
        rec["widths"][nhf] = out
        print(f"[{tag}] nhf={nhf}: {json.dumps(out)}", flush=True)
        del X, mr, mi, w, sc
        torch.cuda.empty_cache()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="*", default=[HERE],
                    help="checkouts whose epilogue is timed, in turn")
    ap.add_argument("--nhf", type=int, nargs="*", default=NHFS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rows", type=int, nargs="*", default=(16, 32, 64, 128),
                    help="tiles of these channel counts timed beside the "
                         "package's own")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_epilogue_variants: no card (torch.cuda.is_available() "
              "is False)")
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    res = {"card": card, "batch": args.batch, "runs": []}
    for i, root in enumerate(args.root):
        res["runs"].append(time_root(cs, os.path.abspath(root), f"r{i}", dev,
                                     args.nhf, args.batch, args.rows))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
