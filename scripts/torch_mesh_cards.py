#!/usr/bin/env python3
"""The sharded fit and get_TOAs(mesh=...) over every visible card.

    python scripts/torch_mesh_cards.py [--out FILE] [--rehearse]

On a host with several cards:
  1. each kernel wrapper (fused_setup, phase_moments, scattering_moments)
     is called from the main thread, whose current card is card 0, on
     tensors of every card, and held bitwise against the same call on
     card 0 (the wrappers make the tensor's card current);
  2. fit_portrait_full_sharded on a (1, n) mesh of the cards (channel
     slabs, one a card) against the single-card fit: bitwise;
  3. chip_smoke.py's pipeline recipe (2 int16 archives x 8 subints, 4096
     channels x 2048 bins) through get_TOAs on card 0 unsharded and with
     the meshes (n, 1) (make_mesh()), (n/2, 2) and (1, n) of the cards:
     every TOA and DM within 0.01 sigma of the unsharded run, every shard
     launched the setup (once a chunk) and the phase-moments kernel; the
     walls and fit_s of each run, each mesh run twice (the first is the
     cards' first use).
--rehearse runs the same steps on the CPU over 4 repeated CPU devices at
64 channels (the plain twins; no launches are counted there): a check of
the script, not of the cards.  The last line of standard output is one
JSON object; --out also writes it to FILE.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402


def log(*a):
    print(*a, flush=True)


def kernels_on_every_card(devices, gen_seed=3):
    """Each wrapper's output on each device, bitwise against device 0's;
    returns {wrapper: [equal on device i]}."""
    import torch

    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    gen = torch.Generator().manual_seed(gen_seed)
    B, nchan, nbin, nh = 4, 512, 2048, 129
    x = torch.randn((B, nchan, nbin), generator=gen)
    mr, mi = (torch.randn((nchan, nh), generator=gen) for _ in range(2))
    w = torch.rand((B, nchan, 2), generator=gen)
    Gr, Gi = (torch.randn((B, nchan, nh), generator=gen) for _ in range(2))
    M2 = torch.rand((nchan, nh), generator=gen)
    phis = 6.0 * torch.rand((B, nchan), generator=gen) - 3.0
    taus = 1e-3 * torch.rand((B, nchan), generator=gen)
    calls = {
        "fused_setup": lambda d: sdft.fused_setup(
            x.to(d), mr.to(d), mi.to(d), w=w.to(d)),
        "phase_moments": lambda d: mom.phase_moments(
            phis.to(d), Gr.to(d), Gi.to(d)),
        "scattering_moments": lambda d: mom.scattering_moments(
            phis.to(d), taus.to(d), Gr.to(d), Gi.to(d), M2.to(d))}
    out = {}
    for name, call in calls.items():
        want = [t.cpu() for t in call(devices[0])]
        out[name] = [all(torch.equal(a.cpu(), b) for a, b in
                         zip(call(d), want)) for d in devices]
    return out


def sharded_fit_slabs(devices, cpu):
    """fit_portrait_full_sharded on a (1, n) mesh of the devices against
    the fit on device 0 (seed_phase=False): the fields that differ."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full_batch, template_spectrum)
    from pulseportraiture_tpu_torch.parallel.mesh import (
        fit_portrait_full_sharded, make_mesh)

    rng = np.random.default_rng(8)
    B, nchan, nbin = 6, 256, 512
    freqs = np.linspace(1100.0, 1900.0, nchan)
    model = cs.bench_template(freqs, nbin)
    data = model[None] + rng.normal(0.0, cs.NOISE, (B, nchan, nbin))
    dt = torch.float64 if cpu else torch.float32
    t = dict(dtype=dt, device=devices[0])
    args = (torch.as_tensor(data, **t), template_spectrum(model),
            torch.zeros((B, 5), **t), torch.full((B,), cs.P, **t),
            torch.as_tensor(freqs, **t), torch.full((B, nchan), cs.NOISE,
                                                     **t))
    mesh = make_mesh(1, len(devices), devices=devices)
    want = fit_portrait_full_batch(*args, seed_phase=False)
    got = fit_portrait_full_sharded(mesh, *args, seed_phase=False)
    return [f for f, a, b in zip(want._fields, got, want)
            if not torch.equal(a.cpu(), b.cpu())], mesh.launches


def pipelines(devices, cpu):
    """get_TOAs unsharded on device 0 and over meshes of the devices."""
    import numpy as np

    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    n = len(devices)
    t0 = time.perf_counter()
    files, _, tmpl, _ = cs.write_archives(
        np.random.default_rng(0), nsub=2 if cpu else 8,
        nchan=64 if cpu else cs.NCHAN)
    log(f"wrote {len(files)} archives in {time.perf_counter() - t0:.2f} s")
    dev = devices[0]
    gt = GetTOAs(files, tmpl, device=dev, quiet=True)
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    ref, ref_wall = gt.TOA_list, time.perf_counter() - t0
    rec = {"unsharded": dict(wall_s=ref_wall, timing=gt.fit_timing)}
    log(f"unsharded on {dev}: {len(ref)} TOAs in {ref_wall:.2f} s "
        f"(timing {json.dumps(gt.fit_timing)})")
    meshes = [(f"{n}x1", make_mesh(n, 1, devices=devices) if cpu
               else make_mesh()),
              (f"{n // 2}x2", make_mesh(n // 2, 2, devices=devices)),
              (f"1x{n}", make_mesh(1, n, devices=devices))]
    ok = True
    # twice: the first run is each card's first use of the fit's torch
    # work (cuBLAS/cuSOLVER handles, the kernels' modules)
    for name, mesh in meshes + [(name + " again", mesh)
                                for name, mesh in meshes]:
        gm = GetTOAs(files, tmpl, device=dev, quiet=True)
        cs.reset_launches()
        mesh.reset_launches()
        t0 = time.perf_counter()
        gm.get_TOAs(quiet=True, mesh=mesh)
        wall = time.perf_counter() - t0
        launches = cs.read_launches()
        z = cs.toa_sigmas(gm.TOA_list, ref)
        chunks = gm.fit_timing["batched_chunks"]
        shard_ok = cpu or all(
            c.get("fused_setup", 0) == chunks and c.get("phase_moments", 0)
            > 0 for c in mesh.launches.values())
        good = len(gm.TOA_list) == len(ref) and max(z) <= 1e-2 and shard_ok
        ok &= good
        log(f"mesh {name} over {mesh.device_list}: {len(gm.TOA_list)} TOAs "
            f"in {wall:.2f} s (timing {json.dumps(gm.fit_timing)}); vs "
            f"unsharded (TOA, DM, GM) {z} sigma; launches {launches}; per "
            f"shard {mesh.launches}; {'ok' if good else 'FAILED'}")
        rec[name] = dict(wall_s=wall, timing=gm.fit_timing,
                         vs_unsharded_sigma=z, chunks=chunks,
                         launches_by_shard={f"{k[0]},{k[1]}": v for k, v in
                                            mesh.launches.items()})
    return ok, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", action="store_true",
                    help="the same steps on 4 repeated CPU devices")
    args = ap.parse_args(argv)
    import torch

    if args.rehearse:
        torch.set_num_threads(2)
        devices = [torch.device("cpu")] * 4
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            log(f"torch_mesh_cards: needs several cards, {n} visible")
            return 2
        devices = [torch.device("cuda", i) for i in range(n)]
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.strip())
        log(f"{n} cards: {[torch.cuda.get_device_name(i) for i in range(n)]}"
            f", torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = {"devices": [str(d) for d in devices]}
    kern = kernels_on_every_card(devices)
    log(f"each wrapper on each device, bitwise vs device 0: {kern}")
    diff, launches = sharded_fit_slabs(devices, args.rehearse)
    log(f"fit_portrait_full_sharded, (1, {len(devices)}) mesh vs one "
        f"device: fields that differ {diff}; launches per shard {launches}")
    ok, rec = pipelines(devices, args.rehearse)
    ok &= all(all(v) for v in kern.values()) and not diff
    out.update(kernels_bitwise=kern, slab_fit_differs=diff,
               slab_fit_launches={f"{k[0]},{k[1]}": v
                                  for k, v in launches.items()},
               pipelines=rec, ok=bool(ok))
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
