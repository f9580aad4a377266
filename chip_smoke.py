#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel), then:
  1. prints the card (nvidia-smi name, power limit), torch/CUDA versions
     and the kernel build time;
  2. holds each kernel against its plain torch twin on the card at 4096
     channels x 2048 bins (setup B=4: capped nh=128 with K=2 seed sums,
     full band nh=1025, int16+scale; phase moments B=32, phases in
     [-3, 3] turns) and times both; the setup runs on its FFT route
     (csrc/setup_fft.cu) there, its error must also stay within 4x of a
     cuBLAS float32 DFT-as-GEMM's, below a TF32-input GEMM's, and it is
     timed beside that GEMM and beside torch.fft.rfft + cross-spectrum;
     the setup also as the per-item route calls it, one item of 4096 rows
     without seed weights, nh=128 and 1025; the FFT route's mixed-radix
     plans at 4096 channels x 768, 1280, 1536 and 3840 bins (odd factors
     3, 5, 3, 15), B=4, K=2, capped and full band, float32 and int16 +
     scale: the same checks, the same bits from a second call, timed
     beside the same library calls on the same inputs;
     the same at every power of two 64 .. 8192 (setup_pow2: B=64 up to
     512 bins, B=4 above; capped where the band cap applies); and the
     setup's second route ("rfft": torch.fft.rfft + csrc/setup_epilogue.cu)
     at the widths the FFT route has no plan for, 4096 channels x 255,
     1000, 4352, 4608, 6144, 7680 and 16384 bins, B=4, full band (and the
     prefix nh=125 at 1000), float32 and int16 + scale (setup_no_plan): the
     same checks, the epilogue alone against setup_epilogue_reference on
     the same spectrum (the same bits from a second call), timed beside
     rfft alone, the same library calls, the fused bound, the route's
     two-kernel bound and the epilogue's own bound (its share printed);
  3. the scattering-moments kernel against its float64 twin at B=32,
     nh=128 and 1025, phases in [-3, 3] turns, taus around
     8e-3 (nu/1500)^-4 rot over two decades: each of the 9 sums within
     2e-6 of sum_k |summand_k|, a second call bitwise equal; the geometry
     scat_geometry chose; kernel and plain float32 times; the same
     for 4096 items of one channel, each with an M2 row of its own (what
     the per-channel scattering fit gives the kernel); then the three
     phase kernels at nh = 8193 (16384 bins: harmonics past 4096) against
     their float64 twins (phase_kernels_wide);
  4. runs the batched (phi, DM) fit at 4096 x 2048, B=64, capped and full
     band, on bench.py's data recipe generated on the card from a seeded
     torch.Generator: every item converged, |phi - phi_inj| <= 5 sigma,
     and the card's float32 kernel route agrees with the float64 twin
     route on the CPU within 0.01 sigma on a subset; prints fits/s; then
     the same at 4096 x 1536 (the radix-3 plan), at 4096 x 8192 (full
     band only: three radix-16 passes; the twin on 2 items), at 4096 x
     64 (full band: the packed worker), at 4096 x 16384 (B=8, full band,
     the rfft setup route and harmonics past 4096; the twin on 1 item)
     and at 4096 x 4608 (full band, the rfft route; the twin on 4 items);
  5. the scattering fit (phi, DM, tau, alpha), log10 tau, at 4096 x 2048,
     B=32, capped and full band, on scripts/tpu_scaling.py's --scat recipe
     generated on the card: every item converged, phi, DM, log10 tau at
     1500 MHz and alpha within 5 sigma of the injection, the batch-mean
     tau at 1500 MHz within 1.2% of 8e-3 rot, the card route within 0.01
     sigma of the float64 twin route on the CPU on 2 items; fits/s;
  6. runs the pipeline a user runs (GetTOAs(..., device="cuda")) on two
     int16 PSRFITS archives x 8 subints at 4096 x 2048 written here, with
     a float32 noiseless template: TOA count and injected dDM within 3
     sigma; then one such archive at 4096 x 1536 and one at 4096 x 8192
     (the template not capped there); then at 16384 bins, 512 channels
     (phase_pipeline_wide): get_TOAs on 4 subints, get_TOAs(fit_scat=True)
     on 4 scattered subints and get_narrowband_TOAs on one subint, each
     within 0.01 sigma of the port's float64 CPU run of the same archive,
     dDM and scat_time within 3 sigma of the injection, the narrowband
     phases within 5 sigma above S/N 8;
  7. the same with get_TOAs(fit_scat=True) on two scattered archives x 4
     subints (the template unscattered): TOA count, scat_time within 3
     sigma of the injection at scat_ref_freq, injected dDM within 3 sigma;
  8. the merged-stream phase-moments kernel against its float64 twin at
     B=16 x 4096 rows x nh=1024 (128-bit loads) and at 4096 rows x
     nh=1025 (scalar loads), phases in [-3, 3] turns: each sum within the
     split kernel's tolerance, and within 1 float32 ulp of sum |summand|
     of the split kernel on the same data; kernel and plain times;
  9. get_narrowband_TOAs on the card: 2 archives x 4 subints x 4096
     channels, 32768 TOAs; every channel's phase within 5 sigma of the
     injection above S/N 8; the card's float32 route within 0.01 sigma of
     the float64 twin route on the CPU for one archive; TOAs/s;
 10. get_narrowband_TOAs(fit_scat=True) on one scattered subint: 4096
     single-channel (phi, tau) fits; the median pull of the per-channel
     log scattering times against the injected tau(nu) within 3 sigma of
     the median's own scatter; the card's float32 route within 0.01 sigma
     of the float64 twin route on the CPU in phase and scat_time on the
     channels whose scat_time the twin measures at 1 sigma or better (the
     others, whose chi2 has no or a barely curved minimum in log10 tau,
     within one sigma);
 11. get_psrchive_TOAs with each of the six estimators on one subint: PGS
     and SIS shifts within 1e-6 rot, PIS and GIS within one bin of PGS,
     every error finite and positive above S/N 8;
 12. the (phi, DM) pipeline once more with a two-component .gmodel
     template written here: injected dDM within 3 sigma;
 13. the batched (phi, DM, GM) fit at 4096 x 2048, B=64, capped and full
     band, on phase 4's recipe with a GM whose nu^-4 delay spans up to
     +-0.005 rot across the band: every item converged, phi (at the fit
     frequency), DM and GM within 5 sigma of the injection, nu_DM inside
     the band, the card's float32 route within 0.01 sigma of the float64
     twin route on the CPU on 8 items; fits/s and mean niter;
 14. get_TOAs(fit_GM=True) on phase 6's archives and, with fit_scat, on
     phase 7's: gm and gm_err on every .tim line, injected dDM within 3
     sigma, and one archive's TOAs, DMs and GMs within 0.01 sigma of the
     port's float64 run on the CPU;
 15. channel zapping: one archive x 4 subints whose four channels carry
     interference; get_channels_to_zap after the card run returns them,
     as its show_fit path and the float64 CPU run do; the model-free
     zap_archive writes an archive whose weights zero them, and get_TOAs
     runs on it;
 16. the template workflow (phase_template_build), first at 512 x 2048
     on a profile that evolves across the band: the chain (align ->
     ppspline, ppgauss -> get_TOAs) on the card against the float64 CPU
     port: Gaussian parameters within 0.01 of their errors, through the
     whole chain and built from one aligned portrait; the same nonempty
     set of spline eigenprofiles, knots within 1e-6 MHz, the spline
     coefficients, both models and the aligned portrait within 1e-3 of
     the noise sigma; the TOAs and DMs each chain's templates give within
     0.01 sigma.  Then, the builders warm, at 4096 x 2048: align (what
     ppalign -I -T runs) of two int16 archives x 8 coherent subints, each
     archive with its own phase offset and dDM, which align's fits must
     recover within 5 of their errors; ppspline (normalize 'prof',
     smoothed PCA + spline) and ppgauss (2 components, niter 1) on the
     average, get_TOAs with each template: 16 TOAs with gof < 2 and the
     relative dDM structure within 5 sigma; the Gaussian model against
     bench_template's truth (separation, widths, amplitude ratio,
     amplitude index) within 5 of its errors; align and ppgauss must
     launch the setup, phase-moments and merged kernels.  The walls
     (PCA / smoothing / spline fit, bootstrap / LM / check_convergence),
     the LM's Jacobians and rejected steps and its ms per Jacobian are
     printed, at 512 both at the builders' first use and again;
 17. profiling (phase_profiling, run before phase 6): profiling.trace
     around one B=64 capped (phi, DM) batch at 4096 x 2048 under an
     annotate range; the Chrome trace must name the setup FFT and
     phase-moments kernels and the range;
 18. the sharded pipeline (phase_mesh, after phase 14):
     get_TOAs(mesh=make_mesh(2, 2, devices=["cuda:0"] * 4)) on phase 6's
     archives with and without fit_GM and on phase 7's with fit_scat:
     every TOA, DM (GM, log10 scat_time) within 0.01 sigma of the
     unsharded card run; each of the 4 shards launched the setup and
     moments kernels, the setup shards x chunks times; with more than one
     card visible also make_mesh() over the cards (one card: a line says
     the multi-card run did not happen).
 19. the trust-region subproblem (phase_tr_solve, after phase 8):
     csrc/tr_solve.cu at B=64, n=5 in float32 (with the hard case) and
     float64 against tr_solve_reference in float64 on the CPU, timed by
     CUDA events beside the eager path's wall (tr_solve_reference on the
     card); the batched fits (phase 4) must launch it.
 20. the load statistics (phase_load_stats, after phase 19):
     csrc/load_stats.cu at 4096 profiles (8 subints x 512 channels) x
     2048 and x 1536 bins against profile_stats_reference on the CPU
     (baseline, sum and max to the bit, the noise within 2e-6), timed
     by CUDA events beside the twin on the card and the bound; the walls
     of archive_stats on the card and of the host route it replaces;
     every int16 archive of phase 6's pipelines (2048, 1536, 8192 bins)
     must launch it once.
ptxas's registers and spills are printed for every kernel; a spill in the
setup FFT, the setup epilogue or the scattering kernel fails the run.
Launch counts are reset before each pipeline run (the main paths) and
read after it; every kernel of that path must have launched there, and
every setup launch of a path must have taken the route setup_route
names: the FFT route at 2048, 1536 and 8192 bins, the rfft route at
16384.  The
line before last is a JSON summary of the kernels (times, the bound from
this run's shapes, the library call's time); the last is {"ok": true,
"device": ...}.  Exits non-zero without a card, or when any phase fails.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
NCHAN, NBIN, P, NOISE = 4096, 2048, 0.003, 0.1
# one H100 SXM (NVIDIA data sheet, at a 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# float32 operations per harmonic: csrc/moments.cu (adds and multiplies;
# sincosf and rintf counted as one each, so the bound stays a lower bound)
# and csrc/scat_moments.cu's closed forms (the phasor's complex multiply
# 6, G P, z and w 6 each, Re v 3, c, 1 + c^2 and its reciprocal 4, bi 1,
# k and k^2 2, the nine accumulations and their products 22; an FMA
# counts 2, the reciprocal 1)
PHASE_OPS, SCAT_OPS = 19, 56
TAU0, ALPHA0 = 8e-3, -4.0     # [rot] at 1500 MHz (scripts/tpu_scaling.py)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes, nops):
    """(least ms, "bytes" or "operations"): bytes over the HBM rate or
    float32 operations over the peak rate, whichever is longer."""
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def setup_bound(B, nbin, nh, K, x_itemsize, scaled, part="fused"):
    """The fit setup's least time, or that of one part of its "rfft"
    route.  Every part reads the model spectrum, weights and scales,
    writes Gr/Gi, sd and the K seed sums, and does the cross-spectrum and
    seed sums (6 nh + 4 K nh operations a row).  Besides, by part:
      "fused": fused_setup as one kernel, the fused minimum: x read once;
        an FFT's 2.5 nbin log2(nbin) operations a row (the DFT of
        setup_fft.cu's passes) and Parseval's 3 nbin;
      "route": the "rfft" route as two kernels: cuFFT reads the float32
        rows (int16 rows cast first: read as int16, written and read as
        float32) and writes the spectrum X (nbin/2 + 1 complex64 a row),
        the epilogue reads X once; the operations of "fused".  Beside
        "fused" it shows what the unfused transform costs;
      "epilogue": csrc/setup_epilogue.cu alone: X read once; |X|^2 over
        every harmonic."""
    rows = B * NCHAN
    nhf = nbin // 2 + 1
    spectrum = rows * nhf * 8
    if part == "fused":
        inbytes = rows * nbin * x_itemsize
    elif part == "route":
        inbytes = (rows * nbin * (4 if x_itemsize == 4 else x_itemsize + 8) +
                   2 * spectrum)
    elif part == "epilogue":
        inbytes = spectrum
    else:
        raise ValueError(f"setup_bound: no part {part!r}")
    row_ops = (3 * nhf if part == "epilogue" else
               2.5 * nbin * math.log2(nbin) + 3 * nbin)
    nbytes = (inbytes + NCHAN * nh * 8 + rows * K * 4 +
              (rows * 4 if scaled else 0) + rows * nh * 8 + rows * 4 +
              B * K * nh * 8)
    return bound_ms(nbytes, rows * (row_ops + 6 * nh + 4 * K * nh))


def cuda_ms(fn, reps=10, warm=2):
    """Mean milliseconds per call by CUDA events over reps launches.  The
    launches are queued while the card works off ~20 ms of matmul, so they
    run back to back: a call the host takes 0.1 ms to make would otherwise
    read 0.1 ms however short its kernel is."""
    import torch
    for _ in range(warm):
        fn()
    if not hasattr(cuda_ms, "busy"):
        cuda_ms.busy = torch.ones((8192, 8192), device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.matmul(cuda_ms.busy, cuda_ms.busy)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_template(freqs, nbin=NBIN, index2=-1.5):
    """bench.py's two-component template (nchan, nbin), float32.  index2:
    the second component's spectral index (the main one's is -1.5; any
    other value makes the profile's shape evolve across the band)."""
    import numpy as np
    x = (np.arange(nbin) + 0.5) / nbin
    r = freqs[:, None] / 1500.0
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2)[None, :] + \
        0.4 * np.exp(-0.5 * ((x - 0.47) / 0.01) ** 2) * r ** (index2 + 1.5)
    return (prof * r ** -1.5).astype(np.float32)


def shifted_data(mft, shifts, gen, noise, dev, nbin=NBIN):
    """irfft(mft e^{-2 pi i k shift}) + N(0, noise) in f32 on the card;
    mft (nchan, nh) complex128, shifts (B, nchan) float64 [rot]."""
    import torch
    k = torch.arange(mft.shape[-1], dtype=torch.float64, device=dev)
    out = []
    for s in shifts.split(8):
        ang = torch.remainder(s[..., None] * k, 1.0) * (2.0 * math.pi)
        spec = mft * torch.polar(torch.ones_like(ang), -ang)
        d = torch.fft.irfft(spec, n=nbin, dim=-1)
        d = d + noise * torch.randn(d.shape, generator=gen,
                                    dtype=torch.float64, device=dev)
        out.append(d.to(torch.float32))
    return torch.cat(out)


def template_routes(model, nbin=NBIN):
    """The template's split spectra (mr, mi), host float64: "capped", the
    band-capped prefix (band_cap_model_ft), where the band cap applies
    (cap_supported), and "full_band"."""
    import numpy as np

    from pulseportraiture_tpu_torch.fitters.portrait import template_spectrum
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    out = {}
    if sdft.cap_supported(nbin):
        mf = np.fft.rfft(np.asarray(model, np.float64), axis=-1)
        mr_c, mi_c, mh = sdft.band_cap_model_ft(mf.real, mf.imag, nbin)
        nh_c = sdft.cap_nharm(nbin, mh)
        out["capped"] = (mr_c[:, :nh_c], mi_c[:, :nh_c])
    out["full_band"] = template_spectrum(model)
    return out


def phidm_recipe(dev, B, seed=0, nbin=NBIN):
    """bench.py's (phi, DM) data on the card: bench_template shifted by
    phi ~ U(-0.01, 0.01) rot and DM ~ U(-2e-4, 2e-4) at the band's mean
    frequency, noise NOISE.  Returns (data (B, nchan, nbin) float32,
    freqs float64, model, phis, dms, nu_fit)."""
    import torch

    from pulseportraiture_tpu_torch.config import DCONST
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    freqs = torch.linspace(1100.0, 1900.0, NCHAN, **f64)
    model = bench_template(freqs.cpu().numpy(), nbin)
    nu_fit = float(freqs.mean())
    phis = torch.rand(B, generator=gen, **f64) * 0.02 - 0.01
    dms = torch.rand(B, generator=gen, **f64) * 4e-4 - 2e-4
    shifts = phis[:, None] + DCONST * dms[:, None] / P * (
        freqs[None, :] ** -2 - nu_fit ** -2)
    mft = torch.fft.rfft(torch.as_tensor(model, **f64), dim=-1)
    data = shifted_data(mft, shifts, gen, NOISE, dev, nbin)
    return data, freqs, model, phis, dms, nu_fit


def scat_recipe(dev, B, seed=3):
    """scripts/tpu_scaling.py's --scat data on the card: a Gaussian at
    phase 0.4, width 0.02, spectral index -1.5, scattered by TAU0 rot at
    1500 MHz with index ALPHA0, noise NOISE.  Returns (data (B, nchan,
    nbin) float32, freqs float64, model (nchan, nbin) float64)."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops.scattering import \
        scattering_portrait_FT
    gen = torch.Generator(device=dev).manual_seed(seed)
    freqs = torch.linspace(1100.0, 1900.0, NCHAN, dtype=torch.float64,
                           device=dev)
    x = (np.arange(NBIN) + 0.5) / NBIN
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2)
    model = prof[None] * (freqs.cpu().numpy()[:, None] / 1500.0) ** -1.5
    mft = torch.fft.rfft(torch.as_tensor(model, device=dev), dim=-1)
    scat = torch.fft.irfft(mft * scattering_portrait_FT(
        TAU0 * (freqs / 1500.0) ** ALPHA0, NBIN), n=NBIN, dim=-1)
    data = torch.empty((B, NCHAN, NBIN), dtype=torch.float32, device=dev)
    for i in range(0, B, 8):
        noise = torch.randn((min(8, B - i), NCHAN, NBIN), generator=gen,
                            dtype=torch.float64, device=dev)
        data[i:i + 8] = (scat + NOISE * noise).to(torch.float32)
    return data, freqs, model


def tf32_round(t):
    """Round float32 values to TF32's 10-bit mantissa (half away from 0)."""
    import torch
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def dft_matrix(nh, dev, nbin=NBIN):
    """(nbin, 2 nh) float32 [cos | -sin] of the first nh harmonics."""
    import torch
    j = torch.arange(nbin, dtype=torch.int64, device=dev)
    k = torch.arange(nh, dtype=torch.int64, device=dev)
    ang = torch.remainder(j[:, None] * k[None, :], nbin).double() * (
        2.0 * math.pi / nbin)
    return torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1).float()


def gemm_cross_spectrum(xx, E, mr, mi, sc, tf32_inputs=False):
    """(Gr, Gi) from a cuBLAS float32 DFT-as-GEMM against E =
    dft_matrix(nh): the accuracy class the setup kernel must meet, and
    its library call.  With tf32_inputs the data and trig matrix are
    first rounded to TF32, the class the kernel must beat."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the float32 GEMM reference needs "
                             "allow_tf32 = False")
    nh = mr.shape[-1]
    xf = xx.float()
    if tf32_inputs:
        xf, E = tf32_round(xf), tf32_round(E)
    X = xf @ E
    Xr, Xi = X[..., :nh], X[..., nh:]
    if sc is not None:
        Xr, Xi = Xr * sc[..., None], Xi * sc[..., None]
    Gr = Xr * mr + Xi * mi
    Gi = Xi * mr - Xr * mi
    Gr[..., 0] = 0.0
    Gi[..., 0] = 0.0
    return Gr, Gi


def rfft_cross_spectrum(xx, mr, mi, sc):
    """(Gr, Gi) from torch.fft.rfft and the cross-spectrum: the setup
    kernel's second library yardstick (cuFFT)."""
    import torch
    nh = mr.shape[-1]
    X = torch.fft.rfft(xx.float(), dim=-1)[..., :nh]
    if sc is not None:
        X = X * sc[..., None]
    Gr = X.real * mr + X.imag * mi
    Gi = X.imag * mr - X.real * mi
    Gr[..., 0] = 0.0
    Gi[..., 0] = 0.0
    return Gr, Gi


def setup_case(tag, xx, mr_t, mi_t, wt, sc, nbin):
    """One fused_setup call on the route setup_route names against the
    float64 twin on the card (2e-5 of the largest |output|, 4e-6 above
    8192 bins),
    float32-class (within 4x of a cuBLAS float32 DFT-as-GEMM's error, a
    bound a TF32 DFT exceeds), the same bits from a second call; then
    timed beside the plain twin and the two library calls (float32 GEMM,
    rfft + cross-spectrum).  On the "rfft" route also the epilogue
    (csrc/setup_epilogue.cu) alone on the same spectrum against
    setup_epilogue_reference in float64 (4e-6 of the largest |output|),
    timed beside torch.fft.rfft alone, with the route's two-kernel bound
    (setup_bound's "route") and the epilogue's own.  Returns the record."""
    import torch

    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    B = xx.shape[0]
    route = sdft.setup_route(nbin)
    f0 = sdft.fused_setup.routes[route]
    got = sdft.fused_setup(xx, mr_t, mi_t, w=wt, scale=sc)
    torch.cuda.synchronize()
    if sdft.fused_setup.routes[route] != f0 + 1:
        raise AssertionError(f"setup[{tag}] did not take the {route} route")
    again = sdft.fused_setup(xx, mr_t, mi_t, w=wt, scale=sc)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"setup[{tag}]: a second call gave other bits")
    del again
    ref = sdft.fused_setup_reference(
        xx, mr_t.double(), mi_t.double(), w=wt.double(),
        scale=None if sc is None else sc.double())
    gmax = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
    smax = max(float(ref[3].abs().max()), float(ref[4].abs().max()))
    errs = [float((g.double() - r).abs().max()) for g, r in zip(got, ref)]
    # 2e-5 of the largest |output|, and 4e-6 above 8192 bins: at 16384
    # 2e-5 of it (47.5) lies above a TF32 DFT's error (43.0), while the
    # route's own is 0.48 (f32) and 0.55 (int16), so 4e-6 (9.5) sits 17x
    # above the route's and 4.5x below TF32's
    rel = 2e-5 if nbin <= 8192 else 4e-6
    bounds = [rel * gmax, rel * gmax, rel * float(ref[2].abs().max()),
              rel * smax, rel * smax]
    nh = mr_t.shape[-1]
    log(f"setup[{tag}] {route} route, nh={nh} max abs err Gr/Gi/sd/gsr/gsi "
        f"{errs} bounds {bounds}")
    if any(e > b for e, b in zip(errs, bounds)):
        raise AssertionError(f"setup[{tag}] disagrees with its twin")
    # The DFT must be float32-class: within 4x of a cuBLAS float32
    # GEMM's error on the same inputs, a bound a TF32 DFT must exceed, and
    # a quarter of a TF32 DFT's error or less.  Above 8192 bins the GEMM
    # sums so many terms that its own error nears the TF32 one (16384:
    # 4x the GEMM's is above the TF32 DFT's), so there only the last
    # holds the line between the two classes.
    e_cls = {}
    E = dft_matrix(nh, xx.device, nbin)
    for cls, tf in (("f32", False), ("tf32", True)):
        g = gemm_cross_spectrum(xx, E, mr_t, mi_t, sc, tf32_inputs=tf)
        e_cls[cls] = max(float((a.double() - r).abs().max())
                         for a, r in zip(g, ref[:2]))
        del g
    del got, ref
    log(f"setup[{tag}] Gr/Gi max abs err: kernel {max(errs[:2])}, float32 "
        f"GEMM {e_cls['f32']}, TF32-input GEMM {e_cls['tf32']}")
    if max(errs[:2]) > 4 * e_cls["f32"]:
        raise AssertionError(f"setup[{tag}] is not float32-class")
    if 4 * max(errs[:2]) >= e_cls["tf32"]:
        raise AssertionError(f"setup[{tag}] is within 4x of a TF32 DFT's "
                             "error")
    if nbin <= 8192 and 4 * e_cls["f32"] >= e_cls["tf32"]:
        raise AssertionError(f"setup[{tag}]: the float32-class bound does "
                             "not exclude a TF32 DFT")
    ms = cuda_ms(lambda: sdft.fused_setup(xx, mr_t, mi_t, w=wt, scale=sc))
    plain = cuda_ms(lambda: sdft.fused_setup_reference(
        xx, mr_t, mi_t, w=wt, scale=sc))
    lib = cuda_ms(lambda: gemm_cross_spectrum(xx, E, mr_t, mi_t, sc))
    lib_fft = cuda_ms(lambda: rfft_cross_spectrum(xx, mr_t, mi_t, sc))
    del E
    bnd, by = setup_bound(B, nbin, nh, 2, xx.element_size(), sc is not None)
    rec = dict(route=route, max_abs_err=max(errs[:2]), ms=ms, plain_ms=plain,
               library_ms=min(lib, lib_fft), library_gemm_ms=lib,
               library_rfft_ms=lib_fft, bound_ms=bnd, bound_by=by)
    extra = ""
    if route == "rfft":
        X = torch.fft.rfft(xx.float(), dim=-1)
        epi = sdft._launch_epilogue(X, mr_t, mi_t, False, wt, sc)
        again = sdft._launch_epilogue(X, mr_t, mi_t, False, wt, sc)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(epi, again)):
            raise AssertionError(f"setup[{tag}]: a second epilogue call gave "
                                 "other bits")
        del again
        geo = sdft.epilogue_geometry(B, NCHAN, X.shape[-1], nh, 2,
                                     xx.device)
        twin = sdft.setup_epilogue_reference(
            X, mr_t.double(), mi_t.double(), w=wt.double(),
            scale=None if sc is None else sc.double(), rows=geo.rows)
        e_epi = [float((g.double() - r).abs().max()) / float(r.abs().max())
                 for g, r in zip(epi, twin)]
        del epi, twin
        if max(e_epi) > 4e-6:
            raise AssertionError(f"setup[{tag}] epilogue disagrees with "
                                 f"setup_epilogue_reference: {e_epi}")
        rec["epilogue_geometry"] = geo._asdict()
        rec["epilogue_ms"] = cuda_ms(lambda: sdft._launch_epilogue(
            X, mr_t, mi_t, False, wt, sc))
        rec["epilogue_rel_err"] = max(e_epi)
        rec["rfft_alone_ms"] = cuda_ms(
            lambda: torch.fft.rfft(xx.float(), dim=-1))
        del X
        rec["route_bound_ms"], _ = setup_bound(
            B, nbin, nh, 2, xx.element_size(), sc is not None, "route")
        rec["epilogue_bound_ms"], _ = setup_bound(
            B, nbin, nh, 2, 4, sc is not None, "epilogue")
        rec["epilogue_share"] = rec["epilogue_bound_ms"] / rec["epilogue_ms"]
        extra = (f"; epilogue alone {rec['epilogue_ms']:.4f} ms (rel err "
                 f"{max(e_epi):.2e}; bound {rec['epilogue_bound_ms']:.4f} "
                 f"ms, share of its bound {rec['epilogue_share']:.1%}), "
                 f"rfft alone {rec['rfft_alone_ms']:.4f} ms, route bound "
                 f"{rec['route_bound_ms']:.4f} ms")
    log(f"setup[{tag}] kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"calls: float32 GEMM {lib:.4f} ms, rfft + cross-spectrum "
        f"{lib_fft:.4f} ms; bound {bnd:.4f} ms ({by}) (B={B}){extra}")
    return rec


# the mixed-radix plans chip_smoke.py holds at full width: nbin/2 = m 2^a
# with m = 3, 5, 3 and 15
MIXED_NBINS = (768, 1280, 1536, 3840)


def setup_inputs(dev, nbin, B):
    """A setup phase's data at 4096 channels x nbin (seeds of their own,
    so the other phases' draws stay what they were): bench_template
    shifted by one U(-0.05, 0.05) rot draw per item plus noise, as
    float32 rows (B, NCHAN, nbin) and as int16 rows + scale; seed
    weights (B, NCHAN, 2), the second column zero on half the band; and
    the template's routes (template_routes) as float32 on the card."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.native import quantize_i2

    freqs = np.linspace(1100.0, 1900.0, NCHAN)
    model = bench_template(freqs, nbin)
    gen = torch.Generator(device=dev).manual_seed(nbin)
    mft = torch.fft.rfft(torch.as_tensor(model, dtype=torch.float64,
                                         device=dev), dim=-1)
    shifts = torch.as_tensor(np.random.default_rng(nbin).uniform(
        -0.05, 0.05, (B, 1)), device=dev).expand(B, NCHAN)
    x = shifted_data(mft, shifts, gen, NOISE, dev, nbin)
    raw, scl, _ = quantize_i2(x.cpu().numpy())
    raw = torch.from_numpy(raw).to(dev)
    scl = torch.from_numpy(scl.astype(np.float32)).to(dev)
    wt = torch.ones((B, NCHAN, 2), dtype=torch.float32, device=dev)
    wt[:, : NCHAN // 2, 1] = 0.0
    routes = {name: tuple(torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=torch.float32, device=dev)
                          for a in ri)
              for name, ri in template_routes(model, nbin).items()}
    return x, raw, scl, wt, routes


def setup_mixed_radix(dev):
    """The FFT route's mixed-radix plans at 4096 channels x nbin in
    MIXED_NBINS, B=4, K=2: capped (the band cap's nh) and full band, each
    with float32 rows and with int16 rows + scale, through setup_case
    (setup_inputs' data)."""
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    rec = {}
    for nbin in MIXED_NBINS:
        if sdft.setup_route(nbin) != "fft":
            raise AssertionError(f"nbin={nbin} does not take the FFT route")
        x, raw, scl, wt, routes = setup_inputs(dev, nbin, 4)
        for route, (mr_t, mi_t) in routes.items():
            for rows, xx, sc in (("f32", x, None), ("i16", raw, scl)):
                name = f"{nbin}_{route}_{rows}"
                rec[name] = dict(nbin=nbin, nh=mr_t.shape[-1], **setup_case(
                    name, xx, mr_t, mi_t, wt, sc, nbin))
        del x, raw, scl
    return rec


# the powers of two the FFT route takes
POW2_NBINS = tuple(1 << n for n in range(6, 14))


def setup_pow2(dev):
    """The FFT route at every power of two in POW2_NBINS (64 .. 8192) at
    4096 channels, B=64 up to 512 bins (so that a time is not one launch's
    latency) and B=4 above, K=2: full band and capped where the band cap
    applies, each with float32 rows and with int16 rows + scale, through
    setup_case (setup_inputs' data; scripts/torch_setup_pow2.py times the
    same cases in another checkout)."""
    import torch

    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    rec = {}
    for nbin in POW2_NBINS:
        if sdft.setup_route(nbin) != "fft":
            raise AssertionError(f"nbin={nbin} does not take the FFT route")
        B = 64 if nbin <= 512 else 4
        x, raw, scl, wt, routes = setup_inputs(dev, nbin, B)
        for route, (mr_t, mi_t) in routes.items():
            for rows, xx, sc in (("f32", x, None), ("i16", raw, scl)):
                name = f"{nbin}_{route}_{rows}"
                rec[name] = dict(nbin=nbin, B=B, nh=mr_t.shape[-1],
                                 **setup_case(name, xx, mr_t, mi_t, wt, sc,
                                              nbin))
        del x, raw, scl
        torch.cuda.empty_cache()
    return rec


# the widths csrc/setup_fft.cu has no plan for that chip_smoke.py holds
# the "rfft" route at: odd, 8 x 125, 256 x 17, 18, 24 and 30, and 2 x 8192
NOPLAN_NBINS = (255, 1000, 4352, 4608, 6144, 7680, 16384)


def setup_no_plan(dev):
    """The "rfft" route (torch.fft.rfft + csrc/setup_epilogue.cu) at 4096
    channels x nbin in NOPLAN_NBINS, B=4, K=2: the full band (no band cap
    at these widths) and, at 1000 bins, the prefix nh=125 too, each with
    float32 rows and with int16 rows + scale, through setup_case
    (setup_inputs' data).  The DFT-as-SGEMM kernel these widths took
    before is timed against this route by scripts/torch_setup_pow2.py
    --root <parent checkout>."""
    import torch

    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    rec = {}
    for nbin in NOPLAN_NBINS:
        if sdft.setup_route(nbin) != "rfft":
            raise AssertionError(f"nbin={nbin} does not take the rfft route")
        x, raw, scl, wt, routes = setup_inputs(dev, nbin, 4)
        mr_t, mi_t = routes["full_band"]
        cases = [("full_band", mr_t, mi_t)]
        if nbin == 1000:
            cases.append(("prefix", mr_t[:, :125].contiguous(),
                          mi_t[:, :125].contiguous()))
        for band, mr_c, mi_c in cases:
            for rows, xx, sc in (("f32", x, None), ("i16", raw, scl)):
                name = f"{nbin}_{band}_{rows}"
                rec[name] = dict(nbin=nbin, B=4, nh=mr_c.shape[-1],
                                 **setup_case(name, xx, mr_c, mi_c, wt, sc,
                                              nbin))
        del x, raw, scl, routes
        torch.cuda.empty_cache()
    return rec


def phase_kernels(dev, rng):
    """Kernel vs plain twin on the card; returns per-kernel records."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.native import quantize_i2
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    freqs = np.linspace(1100.0, 1900.0, NCHAN)
    model = bench_template(freqs)
    B = 4
    gen = torch.Generator(device=dev).manual_seed(1)
    mft = torch.fft.rfft(torch.as_tensor(model, dtype=torch.float64,
                                         device=dev), dim=-1)
    shifts = torch.as_tensor(rng.uniform(-0.05, 0.05, (B, 1)),
                             device=dev).expand(B, NCHAN)
    x = shifted_data(mft, shifts, gen, NOISE, dev)
    mf = np.fft.rfft(model.astype(np.float64), axis=-1)
    mr_c, mi_c, mh = sdft.band_cap_model_ft(mf.real, mf.imag, NBIN)
    nh_c = sdft.cap_nharm(NBIN, mh)
    if nh_c != 128:
        raise AssertionError(f"bench template caps at nh={nh_c}, not 128")
    full = (mf.real.astype(np.float32), mf.imag.astype(np.float32))
    full[0][:, 0] = 0.0
    full[1][:, 0] = 0.0
    w = np.ones((B, NCHAN, 2), np.float32)
    w[:, : NCHAN // 2, 1] = 0.0
    wt = torch.from_numpy(w).to(dev)
    raw, scl, _ = quantize_i2(x.cpu().numpy())
    rec = {}
    cases = (("capped", x, (mr_c[:, :nh_c], mi_c[:, :nh_c]), None),
             ("full_band", x, full, None),
             ("i16", torch.from_numpy(raw).to(dev), (mr_c[:, :nh_c],
                                                     mi_c[:, :nh_c]),
              torch.from_numpy(scl.astype(np.float32)).to(dev)))
    for name, xx, (mr, mi), sc in cases:
        mr_t = torch.from_numpy(np.ascontiguousarray(mr)).to(dev)
        mi_t = torch.from_numpy(np.ascontiguousarray(mi)).to(dev)
        rec[name] = setup_case(name, xx, mr_t, mi_t, wt, sc, NBIN)

    # what the per-item route of fit_portrait_full_batch gives the setup
    # (the narrowband fit_scat path): ONE item of 4096 rows, each against
    # its own template row, no seed weights, so no part/gsr/gsi output
    x1 = x[:1].contiguous()
    for name, (mr, mi) in (("one_item_capped", (mr_c[:, :nh_c],
                                                mi_c[:, :nh_c])),
                           ("one_item_full_band", full)):
        mr_t = torch.from_numpy(np.ascontiguousarray(mr)).to(dev)
        mi_t = torch.from_numpy(np.ascontiguousarray(mi)).to(dev)
        f0 = sdft.fused_setup.routes["fft"]
        got = sdft.fused_setup(x1, mr_t, mi_t)
        torch.cuda.synchronize()
        if sdft.fused_setup.routes["fft"] != f0 + 1:
            raise AssertionError(f"setup[{name}] did not take the FFT route")
        ref = sdft.fused_setup_reference(x1, mr_t.double(), mi_t.double())
        if len(got) != 3 or len(ref) != 3:
            raise AssertionError(f"setup[{name}] returned seed sums without "
                                 "seed weights")
        gmax = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
        errs = [float((g.double() - r).abs().max())
                for g, r in zip(got, ref)]
        bounds = [2e-5 * gmax, 2e-5 * gmax, 2e-5 * float(ref[2].abs().max())]
        log(f"setup[{name}] nh={mr.shape[-1]} B=1, no seed weights: max abs "
            f"err Gr/Gi/sd {errs} bounds {bounds}")
        if any(e > b for e, b in zip(errs, bounds)):
            raise AssertionError(f"setup[{name}] disagrees with its twin")
        ms = cuda_ms(lambda: sdft.fused_setup(x1, mr_t, mi_t))
        plain = cuda_ms(lambda: sdft.fused_setup_reference(x1, mr_t, mi_t))
        bnd, by = setup_bound(1, NBIN, mr.shape[-1], 0, 4, False)
        log(f"setup[{name}] kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bnd:.4f} ms ({by})")
        rec[name] = dict(max_abs_err=max(errs[:2]), ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by)

    Bm = 32
    for name, nh in (("capped", nh_c), ("full_band", NBIN // 2 + 1)):
        f32 = dict(dtype=torch.float32, device=dev, generator=gen)
        Gr = torch.randn((Bm, NCHAN, nh), **f32)
        Gi = torch.randn((Bm, NCHAN, nh), **f32)
        # phases of several turns: a plain float32 phi*k loses ~1e-4
        # turn at k ~ 1000 there, the double-single phasor does not
        phis = 6.0 * torch.rand((Bm, NCHAN), **f32) - 3.0
        got = mom.phase_moments(phis, Gr, Gi)
        torch.cuda.synchronize()
        ref = mom.phase_moments_reference(phis.double(), Gr.double(),
                                          Gi.double())
        kk = torch.arange(nh, dtype=torch.float64, device=dev)
        a = (Gr.abs() + Gi.abs()).double()
        errs = []
        for p_, (g, r) in enumerate(zip(got, ref)):
            wsum = (a * kk ** p_).sum(-1) * (2 * math.pi) ** p_
            e = (g.double() - r).abs()
            errs.append(float(e.max()))
            if bool((e > 2e-6 * (wsum + a.sum(-1))).any()):
                raise AssertionError(f"moments[{name}] term {p_} disagrees")
        ms = cuda_ms(lambda: mom.phase_moments(phis, Gr, Gi))
        plain = cuda_ms(lambda: mom.phase_moments_reference(phis, Gr, Gi))
        rows = Bm * NCHAN
        bnd, by = bound_ms(rows * nh * 8 + rows * 4 + 3 * rows * 4,
                           rows * nh * PHASE_OPS)
        log(f"moments[{name}] nh={nh} max abs err C/Cp/Cpp {errs}; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}) "
            f"(B={Bm})")
        rec["moments_" + name] = dict(max_abs_err=errs[0], ms=ms,
                                      plain_ms=plain, bound_ms=bnd,
                                      bound_by=by, max_abs_err_all=errs)
        del Gr, Gi
    return rec


# the scattering kernel's shapes: (B, nchan) items against one shared M2
# (the wideband fit), then what the narrowband fit_scat path gives it: 4096
# items of one channel, each with an M2 row of its own
SCAT_SHAPES = (("capped", (32, NCHAN), 128, False),
               ("full_band", (32, NCHAN), NBIN // 2 + 1, False),
               ("per_item_capped", (NCHAN, 1), 128, True),
               ("per_item_full_band", (NCHAN, 1), NBIN // 2 + 1, True))


def scat_inputs(dev, gen, lead, nh, per_item, nbin=NBIN):
    """(phis, taus, Gr, Gi, M2) float32 on the card: Gr, Gi ~ N(0, 1),
    M2 = |rfft(bench_template at nbin bins)|^2, phases in [-3, 3] turns,
    taus around TAU0 (nu/1500)^ALPHA0 over two decades."""
    import numpy as np
    import torch
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    freqs = torch.linspace(1100.0, 1900.0, NCHAN, device=dev)
    mf = np.fft.rfft(bench_template(freqs.cpu().numpy(), nbin).astype(
        np.float64), axis=-1)
    Gr = torch.randn(lead + (nh,), **f32)
    Gi = torch.randn(lead + (nh,), **f32)
    M2 = torch.as_tensor(np.abs(mf[:, :nh]) ** 2, dtype=torch.float32,
                         device=dev)
    nu = freqs
    if per_item:
        M2, nu = M2[:, None, :].contiguous(), freqs[:, None]
    phis = 6.0 * torch.rand(lead, **f32) - 3.0
    taus = TAU0 * (nu / 1500.0) ** ALPHA0 * 10.0 ** (
        2.0 * torch.rand(lead, **f32) - 1.0)
    return phis, taus, Gr, Gi, M2


def scat_bound(phis, M2, nh):
    """Bytes: Gr/Gi, M2, phis/taus read once, the 9 sums written."""
    rows = phis.numel()
    return bound_ms(rows * nh * 8 + M2.numel() * 4 + rows * 8 + 9 * rows * 4,
                    rows * nh * SCAT_OPS)


def phase_scat_kernel(dev):
    """The scattering-moments kernel against its float64 twin on the
    card at SCAT_SHAPES."""
    import torch

    from pulseportraiture_tpu_torch.fitters.stats import SCAT_NAMES
    from pulseportraiture_tpu_torch.ops import moments as mom

    Bm = 32
    gen = torch.Generator(device=dev).manual_seed(2)
    rec = {}
    for name, lead, nh, per_item in SCAT_SHAPES:
        phis, taus, Gr, Gi, M2 = scat_inputs(dev, gen, lead, nh, per_item)
        got = mom.scattering_moments(phis, taus, Gr, Gi, M2)
        torch.cuda.synchronize()
        geometry = mom.scat_launch_geometry(phis, M2)
        again = mom.scattering_moments(phis, taus, Gr, Gi, M2)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"scattering_moments[{name}]: a second call "
                                 "gave other bits")
        errs = [0.0] * 9
        step = lead[0] * 4 // Bm            # the float64 twin, in 8 pieces
        for i in range(0, lead[0], step):
            sl = slice(i, i + step)
            args = [a.double() for a in (phis[sl], taus[sl], Gr[sl], Gi[sl],
                                         M2[sl] if per_item else M2)]
            ref = mom.scattering_moments_reference(*args)
            scale = mom.scattering_moments_reference(*args, absolute=True)
            for j, (g, r, b) in enumerate(zip(got, ref, scale)):
                e = (g[sl].double() - r).abs()
                errs[j] = max(errs[j], float(e.max()))
                if bool((e > 2e-6 * b).any()):
                    raise AssertionError(f"scattering_moments[{name}] "
                                         f"{SCAT_NAMES[j]} disagrees")
            del args, ref, scale
        ms = cuda_ms(lambda: mom.scattering_moments(phis, taus, Gr, Gi, M2))
        plain = cuda_ms(lambda: mom.scattering_moments_reference(
            phis, taus, Gr, Gi, M2))
        bnd, by = scat_bound(phis, M2, nh)
        log(f"scattering_moments[{name}] nh={nh} max abs err "
            f"{dict(zip(SCAT_NAMES, errs))}; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}) (items x channels "
            f"{lead[0]} x {lead[1]}; lanes per row, rows per block, M2 rows "
            f"a tile {geometry}; a second call bitwise equal)")
        rec[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by,
                         max_abs_err_all=errs, geometry=list(geometry))
        del Gr, Gi
    return rec


def load_stats_archive(rng, nbin, nsub=8, nchan=512):
    """(raw (nsub, nchan, nbin) int16, scale, offs (nsub, nchan) float32):
    a pulse on a DC level with noise, quantized over the int16 range
    profile by profile."""
    import numpy as np
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.uniform(0.05, 1.0, (nsub, nchan, 1)) * np.exp(
        -0.5 * ((ph - 0.4) / 0.02) ** 2) + \
        rng.normal(0.0, NOISE, (nsub, nchan, nbin)) + \
        rng.uniform(-1.0, 1.0, (nsub, nchan, 1))
    lo, hi = x.min(-1), x.max(-1)
    scale = ((hi - lo) / 65534.0).astype(np.float32)
    offs = (0.5 * (lo + hi)).astype(np.float32)
    raw = np.clip(np.round((x - offs[..., None]) / scale[..., None]),
                  -32767, 32767).astype(np.int16)
    return raw, scale, offs


def load_stats_host_s(raw, scale, offs):
    """The wall of load_data's host route over the decoded cube: the
    baseline, the noise (a float32 rfft of every profile) and the S/N."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.mjd import MJD
    from pulseportraiture_tpu_torch.io.psrfits import Archive
    from pulseportraiture_tpu_torch.ops.noise import get_noise_PS, get_SNR
    nsub, nchan, _ = raw.shape
    cube = (scale[..., None] * raw + offs[..., None]).astype(np.float32)
    a = Archive(data=cube[:, None], freqs=np.ones((nsub, nchan)),
                weights=np.ones((nsub, nchan)), Ps=np.ones(nsub),
                epochs=[MJD(58000, 0, 0.0)] * nsub, subtimes=np.ones(nsub))
    t0 = time.perf_counter()
    a.remove_baseline()
    d = np.asarray(a.data, dtype=np.float32)
    noise = np.asarray(get_noise_PS(d, chans=True), dtype=np.float64)
    nz = noise[noise > 0.0]
    get_SNR(d, noise=np.float32(np.sqrt(np.mean(nz ** 2))))
    return time.perf_counter() - t0


def phase_load_stats(dev):
    """The load statistics kernel (csrc/load_stats.cu) at an archive of 8
    subints x 512 channels (4096 profiles) x 2048 and x 1536 bins:
    baseline, sum and max the same bits as profile_stats_reference on the
    CPU, the noise within 2e-6; kernel and twin on the card timed by CUDA
    events (mean of 20 launches) beside the bound, max(bytes / 3.35 TB/s,
    FP32 flops / 67 TFLOP/s) with the int16 read once and 2.5 (nbin/2)
    log2(nbin/2) + 12 a top-quarter harmonic flops a profile; the walls
    (median of 5) of archive_stats on the card (the copies, the kernel,
    the S/N) and of the host route it replaces in get_TOAs."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops import load_stats as ls

    rec = {}
    for nbin in (2048, 1536):
        raw, scale, offs = load_stats_archive(np.random.default_rng(nbin),
                                              nbin)
        r, s = torch.from_numpy(raw).to(dev), torch.from_numpy(scale).to(dev)
        n0 = ls.profile_stats.launches
        got = [t.cpu() for t in ls.profile_stats(r, s)]
        if ls.profile_stats.launches != n0 + 1:
            raise AssertionError("load_stats: not one launch")
        want = ls.profile_stats_reference(torch.from_numpy(raw),
                                          torch.from_numpy(scale))
        rel = float(((got[1] - want[1]).abs() / want[1]).max())
        if not all(torch.equal(got[i], want[i]) for i in (0, 2, 3)) or \
                rel > 2e-6:
            raise AssertionError(f"load_stats at {nbin} bins: baseline, sum "
                                 f"or max not the twin's bits, or the "
                                 f"noise {rel:.3e} from the twin's")
        nprof, nz = raw.size // nbin, nbin // 2
        nbytes = nprof * (2 * nbin + 4 + 16)
        flops = nprof * (2.5 * nz * math.log2(nz) +
                         12 * (nz - (3 * (nz + 1)) // 4 + 1))
        bound = max(nbytes / 3.35e12, flops / 67e12) * 1e3
        ms = cuda_ms(lambda: ls.profile_stats(r, s), reps=20, warm=3)
        plain = cuda_ms(lambda: ls.profile_stats_reference(r, s), reps=20,
                        warm=3)
        walls = []
        for _ in range(6):
            t0 = time.perf_counter()
            ls.archive_stats(raw, scale, dev)
            walls.append(time.perf_counter() - t0)
        card = 1e3 * statistics.median(walls[1:])
        host = 1e3 * statistics.median(load_stats_host_s(raw, scale, offs)
                                       for _ in range(5))
        log(f"load_stats {nprof} x {nbin}: noise within {rel:.3e} of the "
            f"twin; kernel {ms:.4f} ms (CUDA events), twin on the card "
            f"{plain:.4f} ms, bound {bound:.4f} ms (bytes {nbytes}, flops "
            f"{flops:.4g}); walls: archive_stats on the card {card:.2f} "
            f"ms, the host route {host:.2f} ms")
        rec[nbin] = dict(max_abs_err=rel, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by="bytes" if nbytes /
                         3.35e12 > flops / 67e12 else "flops",
                         card_route_ms=card, host_route_ms=host)
    return rec


def phase_kernels_wide(dev):
    """The three phase kernels at nh = 8193 (16384 bins, full band: k past
    4096, where phase_trig reduces k mod 8192 and the scattering
    kernel's float64 factor angles take it as it is) against their
    float64 twins: moments.cu at B=4 x 4096 rows, moments_merged.cu at
    one 4096-row subint, scat_moments.cu at B=4 x 4096 rows against one
    shared M2 (the twin in 8 pieces), with the tolerances of the 2048-bin
    phases (2e-6 of the summed magnitudes); kernel, plain float32 twin
    and bound times."""
    import torch

    from pulseportraiture_tpu_torch.fitters.stats import SCAT_NAMES
    from pulseportraiture_tpu_torch.ops import moments as mom

    nbin, nh, Bm = 16384, 8193, 4
    gen = torch.Generator(device=dev).manual_seed(11)
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    kk = torch.arange(nh, dtype=torch.float64, device=dev)
    rec = {}
    # moments.cu
    Gr = torch.randn((Bm, NCHAN, nh), **f32)
    Gi = torch.randn((Bm, NCHAN, nh), **f32)
    phis = 6.0 * torch.rand((Bm, NCHAN), **f32) - 3.0
    got = mom.phase_moments(phis, Gr, Gi)
    torch.cuda.synchronize()
    errs = [0.0] * 3
    for i in range(Bm):
        ref = mom.phase_moments_reference(phis[i].double(), Gr[i].double(),
                                          Gi[i].double())
        a = (Gr[i].abs() + Gi[i].abs()).double()
        for p_, (g, r) in enumerate(zip(got, ref)):
            wsum = (a * kk ** p_).sum(-1) * (2 * math.pi) ** p_
            e = (g[i].double() - r).abs()
            errs[p_] = max(errs[p_], float(e.max()))
            if bool((e > 2e-6 * (wsum + a.sum(-1))).any()):
                raise AssertionError(f"moments[nh={nh}] term {p_} disagrees")
        del ref, a
    ms = cuda_ms(lambda: mom.phase_moments(phis, Gr, Gi))
    plain = cuda_ms(lambda: mom.phase_moments_reference(phis, Gr, Gi),
                    reps=3, warm=1)
    rows = Bm * NCHAN
    bnd, by = bound_ms(rows * nh * 8 + rows * 4 + 3 * rows * 4,
                       rows * nh * PHASE_OPS)
    log(f"moments[nh={nh}] max abs err C/Cp/Cpp {errs}; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}) (B={Bm})")
    rec["moments"] = dict(nh=nh, B=Bm, max_abs_err=errs[0],
                          max_abs_err_all=errs, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by)
    # moments_merged.cu on one subint, the merged stream [Gr | Gi]
    g = torch.cat([Gr[0], Gi[0]], dim=-1).contiguous()
    p0 = phis[0].contiguous()
    del Gr, Gi
    got = mom.phase_moments_merged(p0, g)
    torch.cuda.synchronize()
    ref = mom.phase_moments_merged_reference(p0.double(), g.double())
    a = (g[:, :nh].abs() + g[:, nh:].abs()).double()
    errs = []
    for p_, (o, r) in enumerate(zip(got, ref)):
        wsum = (a * kk ** p_).sum(-1) * (2 * math.pi) ** p_
        e = (o.double() - r).abs()
        errs.append(float(e.max()))
        if bool((e > 2e-6 * (wsum + a.sum(-1))).any()):
            raise AssertionError(f"merged moments[nh={nh}] term {p_} "
                                 "disagrees with its twin")
    ms = cuda_ms(lambda: mom.phase_moments_merged(p0, g))
    plain = cuda_ms(lambda: mom.phase_moments_merged_reference(p0, g))
    bnd, by = bound_ms(NCHAN * nh * 8 + NCHAN * 4 + 3 * NCHAN * 4,
                       NCHAN * nh * PHASE_OPS)
    log(f"merged moments[nh={nh}] one subint ({NCHAN} rows) max abs err "
        f"{errs}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    rec["merged"] = dict(nh=nh, rows=NCHAN, max_abs_err=errs[0],
                         max_abs_err_all=errs, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by)
    del g, ref, a
    # scat_moments.cu
    sphis, taus, Gr, Gi, M2 = scat_inputs(dev, gen, (Bm, NCHAN), nh, False,
                                          nbin)
    got = mom.scattering_moments(sphis, taus, Gr, Gi, M2)
    torch.cuda.synchronize()
    geometry = mom.scat_launch_geometry(sphis, M2)
    again = mom.scattering_moments(sphis, taus, Gr, Gi, M2)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"scattering_moments[nh={nh}]: a second call "
                             "gave other bits")
    del again
    errs = [0.0] * 9
    step = NCHAN // 2
    for i in range(Bm):
        for c in range(0, NCHAN, step):
            sl = (i, slice(c, c + step))
            args = [x.double() for x in (sphis[sl], taus[sl], Gr[sl],
                                         Gi[sl], M2[c:c + step])]
            ref = mom.scattering_moments_reference(*args)
            scale = mom.scattering_moments_reference(*args, absolute=True)
            for j, (o, r, b) in enumerate(zip(got, ref, scale)):
                e = (o[sl].double() - r).abs()
                errs[j] = max(errs[j], float(e.max()))
                if bool((e > 2e-6 * b).any()):
                    raise AssertionError(f"scattering_moments[nh={nh}] "
                                         f"{SCAT_NAMES[j]} disagrees")
            del args, ref, scale
    ms = cuda_ms(lambda: mom.scattering_moments(sphis, taus, Gr, Gi, M2))
    plain = cuda_ms(lambda: mom.scattering_moments_reference(
        sphis, taus, Gr, Gi, M2), reps=2, warm=1)
    bnd, by = scat_bound(sphis, M2, nh)
    log(f"scattering_moments[nh={nh}] max abs err "
        f"{dict(zip(SCAT_NAMES, errs))}; kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}) (B={Bm}; lanes per row, "
        f"rows per block, M2 rows a tile {geometry}; a second call bitwise "
        f"equal)")
    rec["scattering_moments"] = dict(
        nh=nh, B=Bm, max_abs_err=max(errs), max_abs_err_all=errs, ms=ms,
        plain_ms=plain, bound_ms=bnd, bound_by=by, geometry=list(geometry))
    return rec


def phase_fit(dev, nbin=NBIN, nc=8, B=64):
    """Batched fits at 4096 x nbin, B items, capped (where the band cap
    applies) and full band; the float64 twin route on the CPU on nc
    items; every setup launch on the route setup_route names."""
    import torch

    from pulseportraiture_tpu_torch.config import DCONST
    from pulseportraiture_tpu_torch.fitters.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    from pulseportraiture_tpu_torch.ops.transform import phase_transform

    data, freqs, model, phis, dms, nu_fit = phidm_recipe(dev, B, nbin=nbin)
    routes = template_routes(model, nbin)
    at = "" if nbin == NBIN else f" at {nbin} bins"

    def args(d, dt, n):
        t = dict(dtype=dt, device=d)
        return (torch.zeros((n, 5), **t), torch.full((n,), P, **t),
                freqs.to(**t), torch.full((n, NCHAN), NOISE, **t))

    out = {}
    sd0, mm0 = sdft.fused_setup.launches, mom.phase_moments.launches
    ts0 = trs.tr_solve.launches
    route = sdft.setup_route(nbin)
    r0 = sdft.fused_setup.routes[route]
    for name, mft_ri in routes.items():
        def run():
            return fit_portrait_full_batch(
                data, mft_ri, *args(dev, torch.float32, B),
                nu_fits=torch.full((B, 3), nu_fit, dtype=torch.float32,
                                   device=dev), dtype=torch.float32)
        res = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        rc = res.return_code.cpu()
        if not bool((rc < 3).all()):
            raise AssertionError(f"fit[{name}]{at} items not converged: {rc}")
        p = res.params.double()
        nu_out = res.nu_DM.double()
        phi_back = phase_transform(p[:, 0], p[:, 1], nu_out, nu_fit, P,
                                   mod=True)
        lever = DCONST / P * (nu_fit ** -2 - nu_out ** -2)
        e = res.param_errs.double()
        sig_phi = torch.sqrt(e[:, 0] ** 2 + (lever * e[:, 1]) ** 2)
        zphi = ((phi_back - phis) / sig_phi).abs().max().item()
        zdm = ((p[:, 1] - dms) / e[:, 1]).abs().max().item()
        if zphi > 5 or zdm > 5:
            raise AssertionError(f"fit[{name}]{at} off the injection: "
                                 f"{zphi:.2f}, {zdm:.2f} sigma")
        # the same data through the float64 twin route on the CPU
        cpu = torch.device("cpu")
        ref = fit_portrait_full_batch(
            data[:nc].cpu(), mft_ri, *args(cpu, torch.float64, nc),
            nu_fits=torch.full((nc, 3), nu_fit, dtype=torch.float64),
            dtype=torch.float64)
        r_back = phase_transform(ref.params[:, 0], ref.params[:, 1],
                                 ref.nu_DM, nu_fit, P, mod=True)
        dphi = ((phi_back[:nc].cpu() - r_back) / sig_phi[:nc].cpu()).abs()
        ddm = ((p[:nc, 1].cpu() - ref.params[:, 1]) / e[:nc, 1].cpu()).abs()
        agree = max(float(dphi.max()), float(ddm.max()))
        mean_niter = float(res.niter.double().mean())
        log(f"fit[{name}]{at} B={B} nh={mft_ri[0].shape[-1]}: "
            f"{B / sec:.2f} fits/s ({sec * 1e3:.2f} ms/batch, median of 3), "
            f"mean niter {mean_niter}, max |dphi|/sigma {zphi:.3f}, "
            f"max |dDM|/sigma {zdm:.3f}, card route vs f64 twin route "
            f"{agree:.2e} sigma, max|dphi| "
            f"{float((phi_back - phis).abs().max()):.3e} rot")
        if agree > 1e-2:
            raise AssertionError(f"fit[{name}]{at} kernel route vs f64 twin "
                                 f"route: {agree:.3e} sigma > 0.01")
        out[name] = dict(fits_per_s=B / sec, sec_per_batch=sec,
                         mean_niter=mean_niter, twin_sigma=agree)
    launches = (sdft.fused_setup.launches - sd0,
                mom.phase_moments.launches - mm0,
                trs.tr_solve.launches - ts0)
    log(f"batched-fit phase{at} launches: fused_setup {launches[0]}, "
        f"phase_moments {launches[1]}, tr_solve {launches[2]}")
    if min(launches) <= 0:
        raise AssertionError("a kernel did not launch in the fit phase")
    if sdft.fused_setup.routes[route] - r0 != launches[0]:
        raise AssertionError(f"a setup launch of the fit phase left the "
                             f"{route} route")
    return out


def phase_scat_fit(dev):
    """The scattering fit at 4096 x 2048, B=32, capped and full band, on
    scripts/tpu_scaling.py's --scat recipe (a Gaussian at phase 0.4,
    width 0.02, index -1.5; tau 8e-3 rot at 1500 MHz, alpha -4; noise
    0.1; start log10 tau = log10(4e-3), alpha = -4)."""
    import torch

    from pulseportraiture_tpu_torch.fitters.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops.transform import phase_transform

    B, ff = 32, (1, 1, 0, 1, 1)
    data, freqs, model = scat_recipe(dev, B)
    routes = template_routes(model)
    nu_fit = float(freqs.mean())

    def args(d, dt, n):
        t = dict(dtype=dt, device=d)
        init = torch.zeros((n, 5), **t)
        init[:, 3], init[:, 4] = math.log10(0.5 * TAU0), ALPHA0
        return (init, torch.full((n,), P, **t), freqs.to(**t),
                torch.full((n, NCHAN), NOISE, **t))

    def at_refs(p, nu_DM, nu_tau, to_DM, to_tau):
        """(phi, DM, log10 tau, alpha) moved to other references."""
        p = p.double().clone()
        p[:, 0] = phase_transform(p[:, 0], p[:, 1], nu_DM, to_DM, P)
        p[:, 3] = p[:, 3] + p[:, 4] * torch.log10(to_tau / nu_tau)
        return p

    out = {}
    sm0 = mom.scattering_moments.launches
    for name, mft_ri in routes.items():
        def run():
            return fit_portrait_full_batch(
                data, mft_ri, *args(dev, torch.float32, B), fit_flags=ff,
                log10_tau=True, dtype=torch.float32)
        res = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        rc = res.return_code.cpu()
        if not bool((rc < 3).all()):
            raise AssertionError(f"scat fit[{name}] not converged: {rc}")
        p, e = res.params.double(), res.param_errs.double()
        nu_tau = res.nu_tau.double()
        lr = torch.log10(1500.0 / nu_tau)
        x1500 = p[:, 3] + p[:, 4] * lr
        # tau and alpha do not covary at nu_tau
        s1500 = torch.sqrt(e[:, 3] ** 2 + (e[:, 4] * lr) ** 2)
        z = {"phi": (p[:, 0] / e[:, 0]).abs().max().item(),
             "DM": (p[:, 1] / e[:, 1]).abs().max().item(),
             "log10 tau_1500": ((x1500 - math.log10(TAU0)) /
                                s1500).abs().max().item(),
             "alpha": ((p[:, 4] - ALPHA0) / e[:, 4]).abs().max().item()}
        tau_mean = float((10.0 ** x1500).mean())
        if max(z.values()) > 5:
            raise AssertionError(f"scat fit[{name}] off the injection: {z}")
        if abs(tau_mean / TAU0 - 1.0) > 0.012:
            raise AssertionError(f"scat fit[{name}] mean tau_1500 "
                                 f"{tau_mean} not within 1.2% of {TAU0}")
        # 2 items through the float64 twin route on the CPU, compared at
        # the twin's references
        nc = 2
        cpu = torch.device("cpu")
        ref = fit_portrait_full_batch(
            data[:nc].cpu(), mft_ri, *args(cpu, torch.float64, nc),
            fit_flags=ff, log10_tau=True, dtype=torch.float64)
        pc = at_refs(p[:nc].cpu(), res.nu_DM[:nc].double().cpu(),
                     nu_tau[:nc].cpu(), ref.nu_DM, ref.nu_tau)
        agree = float(((pc - ref.params)[:, [0, 1, 3, 4]] /
                       ref.param_errs[:, [0, 1, 3, 4]]).abs().max())
        mean_niter = float(res.niter.double().mean())
        log(f"scat fit[{name}] B={B} nh={mft_ri[0].shape[-1]}: "
            f"{B / sec:.2f} fits/s ({sec * 1e3:.2f} ms/batch, median of 3), "
            f"mean niter {mean_niter}, max |z| {z}, mean tau_1500 "
            f"{tau_mean:.6e} ({(tau_mean / TAU0 - 1) * 100:+.3f}%), mean "
            f"alpha {float(p[:, 4].mean()):.4f}, card route vs f64 twin "
            f"route {agree:.2e} sigma")
        if agree > 1e-2:
            raise AssertionError(f"scat fit[{name}] kernel route vs f64 "
                                 f"twin route: {agree:.3e} sigma > 0.01")
        out[name] = dict(fits_per_s=B / sec, sec_per_batch=sec,
                         mean_niter=mean_niter, twin_sigma=agree,
                         tau_1500_mean=tau_mean, max_z=z)
    launches = mom.scattering_moments.launches - sm0
    log(f"scattering-fit phase launches: scattering_moments {launches}")
    if launches <= 0:
        raise AssertionError("scattering_moments did not launch")
    return out


def write_archives(rng, nsub=8, t_scat=0.0, tag="epoch", narch=2,
                   rfi_chans=(), nchan=NCHAN, jitter=0.2,
                   dDMs=(3e-4, -2e-4), offsets=(0.0, 0.0), index2=-1.5,
                   nbin=NBIN):
    """narch (at most two) int16 archives x nsub subints (scattered by
    t_scat [s] at 1500 MHz, index -4, when t_scat > 0) + a float32
    noiseless template.  rfi_chans get 5x the noise, white, and as much
    again confined to the lower half of the spectrum (interference the
    power-spectrum noise estimate does not see).  Returns (files, dDMs,
    template file, the injected per-channel phases [rot] of every
    subint, (narch, nsub, nchan): the data are the template rotated
    EARLIER by that much).  Each subint's phase is its archive's offset
    [rot] plus a draw from U(-jitter, jitter) rot (0: coherent subints,
    as folding with a good ephemeris leaves them); archive i is
    dispersed by DM + dDMs[i].  index2: bench_template's second
    component's spectral index.  nbin: the archives' and the template's
    bins (the template's file is named by it at other widths than NBIN,
    so that a second width does not overwrite the first's)."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import DCONST
    from pulseportraiture_tpu_torch.io.mjd import MJD
    from pulseportraiture_tpu_torch.io.psrfits import Archive, write_psrfits
    from pulseportraiture_tpu_torch.ops.scattering import \
        scattering_portrait_FT_np

    os.makedirs(WORK, exist_ok=True)
    nu0, bw, DM = 1500.0, 800.0, 30.0
    cw = bw / nchan
    freqs = np.linspace(nu0 - bw / 2 + cw / 2, nu0 + bw / 2 - cw / 2, nchan)
    model = bench_template(freqs, nbin, index2).astype(np.float64)
    mft = np.fft.rfft(model, axis=-1)
    if t_scat:
        mft_d = mft * scattering_portrait_FT_np(
            t_scat / P * (freqs / nu0) ** ALPHA0, nbin)
    else:
        mft_d = mft
    k = np.arange(nbin // 2 + 1)
    inv2 = freqs ** -2.0 - nu0 ** -2.0

    def arch(data, DM_, dDM_epoch):
        n = data.shape[0]
        return Archive(
            data=data, freqs=np.broadcast_to(freqs, (n, nchan)).copy(),
            weights=np.ones((n, nchan)), Ps=np.full(n, P),
            epochs=[MJD(57000 + 30 * dDM_epoch).add_seconds(30.0 + 60 * i)
                    for i in range(n)],
            subtimes=np.full(n, 60.0), DM=DM_, dedispersed=False,
            nu0=nu0, bw=bw, source="J0000+0000", telescope="GBT",
            frontend="rx", backend="be")

    tmpl = os.path.join(WORK, "template.fits" if nbin == NBIN else
                        f"template{nbin}.fits")
    write_psrfits(tmpl, arch(model[None, None], 0.0, 0), dtype="f4")
    files, dDMs = [], list(dDMs[:narch])
    injected = np.empty((narch, nsub, nchan))
    for ia, dDM in enumerate(dDMs):
        data = np.empty((nsub, 1, nchan, nbin))
        for i in range(nsub):
            phase = offsets[ia] + rng.uniform(-jitter, jitter)
            phis = -phase - DCONST * (DM + dDM) / P * inv2
            injected[ia, i] = phis
            theta = np.mod(phis[:, None] * k, 1.0) * (2.0 * np.pi)
            data[i, 0] = np.fft.irfft(mft_d * np.exp(1j * theta), n=nbin,
                                      axis=-1)
        data += rng.normal(0.0, NOISE, data.shape)
        if len(rfi_chans):
            rfi = list(rfi_chans)
            data[:, 0, rfi] += rng.normal(0.0, 5 * NOISE,
                                          (nsub, len(rfi), nbin))
            spec = np.fft.rfft(rng.normal(0.0, 5 * NOISE,
                                          (nsub, len(rfi), nbin)), axis=-1)
            spec[..., nbin // 4:] = 0.0
            data[:, 0, rfi] += np.fft.irfft(spec, n=nbin, axis=-1)
        path = os.path.join(WORK, f"{tag}{ia}.fits")
        write_psrfits(path, arch(data, DM, ia + 1), dtype="i2")
        files.append(path)
    return files, dDMs, tmpl, injected


def reset_launches():
    from pulseportraiture_tpu_torch.ops import load_stats as ls
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    sdft.fused_setup.launches = 0
    sdft.fused_setup.routes = {"fft": 0, "rfft": 0}
    mom.phase_moments.launches = 0
    mom.scattering_moments.launches = 0
    mom.phase_moments_merged.launches = 0
    trs.tr_solve.launches = 0
    ls.profile_stats.launches = 0


def read_launches(nbin=NBIN):
    """The launch counts since reset_launches, beside the width nbin of
    the path that made them (the route check reads setup_route(nbin))."""
    from pulseportraiture_tpu_torch.ops import load_stats as ls
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    return {"nbin": nbin, "fused_setup": sdft.fused_setup.launches,
            "fused_setup_routes": dict(sdft.fused_setup.routes),
            "phase_moments": mom.phase_moments.launches,
            "scattering_moments": mom.scattering_moments.launches,
            "phase_moments_merged": mom.phase_moments_merged.launches,
            "tr_solve": trs.tr_solve.launches,
            "profile_stats": ls.profile_stats.launches}


def phase_pipeline(rng, nbin=NBIN, narch=2):
    """GetTOAs on the card (narch archives x 8 subints x nbin bins);
    returns the launch counts of its run, its archives (files, dDMs,
    template), its TOAs and a record of the run."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.tim import write_TOAs
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    t0 = time.perf_counter()
    tag = "pipeline" if nbin == NBIN else f"pipeline {nbin}"
    files, dDMs, tmpl, _ = write_archives(
        rng, narch=narch, nbin=nbin,
        tag="epoch" if nbin == NBIN else f"epoch{nbin}_")
    log(f"{tag}: wrote {narch} x 8 x {NCHAN} x {nbin} int16 archives in "
        f"{time.perf_counter() - t0:.2f} s")
    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    # the main path: every launch count from 0, read right after
    reset_launches()
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    wall = time.perf_counter() - t0
    launches = read_launches(nbin)
    tim = os.path.join(WORK, "smoke.tim")
    lines = write_TOAs(gt.TOA_list, outfile=tim, append=False)
    log(f"{tag}: {len(lines)} TOAs in {wall:.2f} s "
        f"(timing {json.dumps(gt.fit_timing)}); mharm {gt.mharms}; "
        f"launches {launches}")
    log(f"{tag}: " + lines[0])
    if len(lines) != 8 * narch:
        raise AssertionError(f"{tag}: expected {8 * narch} TOAs, got "
                             f"{len(lines)}")
    ddm = np.asarray(gt.DeltaDM_means)
    err = np.asarray(gt.DeltaDM_errs)
    log(f"{tag}: DeltaDM {ddm.tolist()} +- {err.tolist()}, injected "
        f"{dDMs}")
    if not np.all(np.abs(ddm - dDMs) <= 3 * err):
        raise AssertionError(f"{tag}: injected dDM not recovered within 3 "
                             "sigma")
    if sdft.cap_supported(nbin) and (not gt.mharms or min(gt.mharms) <= 0):
        raise AssertionError(f"the f32 template did not cap: {gt.mharms}")
    if min(launches["fused_setup"], launches["phase_moments"]) <= 0 or \
            launches["profile_stats"] != narch:
        raise AssertionError(f"a kernel did not launch on the main path "
                             f"(load_stats once an archive): {launches}")
    rec = dict(nbin=nbin, ntoa=len(lines), wall_s=wall,
               delta_dm=ddm.tolist(), delta_dm_err=err.tolist(),
               injected=list(dDMs), mharms=list(gt.mharms),
               launches=launches)
    return launches, (files, dDMs, tmpl), gt.TOA_list, rec


def phase_pipeline_scat(rng):
    """GetTOAs(fit_scat=True) on the card; returns its launch counts and
    its archives (files, dDMs, template)."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.tim import write_TOAs
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    t_scat = TAU0 * P                         # [s] at 1500 MHz
    t0 = time.perf_counter()
    files, dDMs, tmpl, _ = write_archives(rng, nsub=4, t_scat=t_scat,
                                          tag="scat")
    log(f"scat pipeline: wrote 2 x 4 x {NCHAN} x {NBIN} scattered int16 "
        f"archives in {time.perf_counter() - t0:.2f} s")
    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    reset_launches()
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True, fit_scat=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    lines = write_TOAs(gt.TOA_list, outfile=os.path.join(WORK, "scat.tim"),
                       append=False)
    log(f"scat pipeline: {len(lines)} TOAs in {wall:.2f} s (timing "
        f"{json.dumps(gt.fit_timing)}); launches {launches}")
    log("scat pipeline: " + lines[0])
    if len(lines) != 8:
        raise AssertionError(f"expected 8 TOAs, got {len(lines)}")
    zs = []
    for t in gt.TOA_list:
        f = t.flags
        inj = t_scat * (f["scat_ref_freq"] / 1500.0) ** ALPHA0
        zs.append((math.log10(f["scat_time"] * 1e-6) - math.log10(inj)) /
                  f["log10_scat_time_err"])
    log(f"scat pipeline: scat_time vs injection at scat_ref_freq, "
        f"sigma: {[round(z, 3) for z in zs]}")
    if max(abs(z) for z in zs) > 3:
        raise AssertionError("scat_time not within 3 sigma of the injection")
    rec = np.asarray(gt.DeltaDM_means)
    err = np.asarray(gt.DeltaDM_errs)
    log(f"scat pipeline: DeltaDM {rec.tolist()} +- {err.tolist()}, "
        f"injected {dDMs}")
    if not np.all(np.abs(rec - dDMs) <= 3 * err):
        raise AssertionError("injected dDM not recovered within 3 sigma")
    if min(launches["fused_setup"], launches["scattering_moments"]) <= 0:
        raise AssertionError(f"a kernel did not launch on the fit_scat "
                             f"path: {launches}")
    return launches, (files, dDMs, tmpl), gt.TOA_list


# the widest pipelines: 16384 bins at a depth of 512 channels x 4
# subints (loading bound the 8192-bin pipeline at 4096 channels; the
# float64 CPU run of the fit_scat path took 33.7 s at 1024 channels)
WIDE_NBIN, WIDE_NCHAN, WIDE_NSUB = 16384, 512, 4


def phase_pipeline_wide(rng):
    """The pipelines at WIDE_NBIN bins, full band (no band cap above 4096
    bins; the "rfft" setup route and the phase kernels past k = 4096), on
    WIDE_NCHAN-channel int16 archives: get_TOAs on one archive of
    WIDE_NSUB subints, get_TOAs(fit_scat=True) on a scattered one and
    get_narrowband_TOAs on one subint.  Each against the port's float64
    run of the same archive on the CPU within 0.01 sigma (TOA, DM; log10
    scat_time); dDM and scat_time within 3 sigma of the injection; the
    narrowband phases within 5 sigma of it above S/N 8 (512 channels:
    a 3-sigma bound would fail by chance).  Returns the launch counts of
    each run (the main paths: counts reset just before, read just after)
    and a record."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    nbin, nchan, nsub = WIDE_NBIN, WIDE_NCHAN, WIDE_NSUB
    t_scat = TAU0 * P
    t0 = time.perf_counter()
    common = dict(narch=1, nchan=nchan, nbin=nbin)
    files, dDMs, tmpl, _ = write_archives(rng, nsub=nsub, tag="wide",
                                          **common)
    sfiles, sdDMs, _, _ = write_archives(rng, nsub=nsub, t_scat=t_scat,
                                         tag="widescat", **common)
    nfiles, _, _, injected = write_archives(rng, nsub=1, tag="widenb",
                                            **common)
    log(f"pipelines {nbin}: wrote 1 x {nsub} (plain), 1 x {nsub} "
        f"(scattered) and 1 x 1 (narrowband) x {nchan} x {nbin} int16 "
        f"archives in {time.perf_counter() - t0:.2f} s")
    runs = (("pipeline_16384", files, dDMs, "get_TOAs", {}),
            ("pipeline_16384_fit_scat", sfiles, sdDMs, "get_TOAs",
             dict(fit_scat=True)),
            ("narrowband_16384", nfiles, None, "get_narrowband_TOAs",
             dict(print_phase=True)))
    paths, rec = {}, {}
    for name, fl, dd, method, kw in runs:
        gt = GetTOAs(fl, tmpl, device="cuda", quiet=True)
        reset_launches()
        t0 = time.perf_counter()
        getattr(gt, method)(quiet=True, **kw)
        wall = time.perf_counter() - t0
        paths[name] = launches = read_launches(WIDE_NBIN)
        t0 = time.perf_counter()
        ref = GetTOAs(fl, tmpl, device="cpu", dtype=torch.float64,
                      quiet=True)
        getattr(ref, method)(quiet=True, **kw)
        cpu_s = time.perf_counter() - t0
        n = len(gt.TOA_list)
        r = dict(toas=n, wall_s=wall, cpu_f64_s=cpu_s,
                 timing=dict(gt.fit_timing), launches=launches)
        if dd is not None:
            if n != nsub or len(ref.TOA_list) != nsub:
                raise AssertionError(f"{name}: {n} and {len(ref.TOA_list)} "
                                     f"TOAs, expected {nsub}")
            ddm = np.asarray(gt.DeltaDM_means)
            err = np.asarray(gt.DeltaDM_errs)
            if not np.all(np.abs(ddm - dd) <= 3 * err):
                raise AssertionError(f"{name}: injected dDM {dd} not within "
                                     f"3 sigma: {ddm} +- {err}")
            z = toa_sigmas(gt.TOA_list, ref.TOA_list)[:2]
            r.update(delta_dm=ddm.tolist(), delta_dm_err=err.tolist(),
                     injected=list(dd))
            if kw.get("fit_scat"):
                zs = []
                for t in gt.TOA_list:
                    f = t.flags
                    inj = t_scat * (f["scat_ref_freq"] / 1500.0) ** ALPHA0
                    zs.append((math.log10(f["scat_time"] * 1e-6) -
                               math.log10(inj)) / f["log10_scat_time_err"])
                r["scat_time_z"] = zs
                if max(abs(v) for v in zs) > 3:
                    raise AssertionError(f"{name}: scat_time not within 3 "
                                         f"sigma of the injection: {zs}")
                z.append(scat_sigmas(gt.TOA_list, ref.TOA_list))
                kern = "scattering_moments"
            else:
                kern = "phase_moments"
            need = ("fused_setup", kern)
        else:
            if n != nchan or len(ref.TOA_list) != nchan:
                raise AssertionError(f"{name}: {n} and {len(ref.TOA_list)} "
                                     f"TOAs, expected {nchan}")
            phs = np.array([t.flags["phs"] for t in gt.TOA_list])
            err = np.array([t.flags["phs_err"] for t in gt.TOA_list])
            snr = np.array([t.flags["snr"] for t in gt.TOA_list])
            zi = (np.mod(phs + injected.ravel() + 0.5, 1.0) - 0.5) / err
            ok = snr > 8.0
            if not ok.any() or np.abs(zi[ok]).max() > 5.0:
                raise AssertionError(f"{name}: phases off the injection")
            r["max_z_injection"] = float(np.abs(zi[ok]).max())
            z = [max(abs(mjd_diff_rot(a, b)) * P * 1e6 / b.TOA_error
                     for a, b in zip(gt.TOA_list, ref.TOA_list))]
            need = ("phase_moments_merged",)
        r["vs_f64_sigma"] = z
        log(f"{name}: {n} TOAs in {wall:.2f} s (timing "
            f"{json.dumps(gt.fit_timing)}); card vs the float64 CPU run "
            f"({cpu_s:.1f} s): {z} sigma; launches {launches}")
        if max(z) > 1e-2:
            raise AssertionError(f"{name}: card vs float64 CPU run {z} "
                                 "sigma > 0.01")
        if min(launches[k] for k in need) <= 0:
            raise AssertionError(f"a kernel did not launch on the {name} "
                                 f"path: {launches}")
        rec[name] = r
    return paths, rec


def phase_merged_kernel(dev):
    """The merged-stream phase-moments kernel against its float64 twin
    and against the split kernel, at the probe's shape (B=16 x 4096 rows,
    nh=1024) and at one narrowband subint (4096 rows, nh=1025)."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops import moments as mom

    gen = torch.Generator(device=dev).manual_seed(4)
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    eps = float(np.finfo(np.float32).eps)
    rec = {}
    for name, shape, nh in (("probe", (16, NCHAN), 1024),
                            ("subint", (NCHAN,), NBIN // 2 + 1)):
        g = torch.randn(shape + (2 * nh,), **f32)
        phis = 6.0 * torch.rand(shape, **f32) - 3.0
        got = mom.phase_moments_merged(phis, g)
        torch.cuda.synchronize()
        ref = mom.phase_moments_merged_reference(phis.double(), g.double())
        Gr, Gi = g[..., :nh].contiguous(), g[..., nh:].contiguous()
        split = mom.phase_moments(phis, Gr, Gi)
        kk = torch.arange(nh, dtype=torch.float64, device=dev)
        a = (Gr.abs() + Gi.abs()).double()
        errs, vs_split, bitwise = [], [], True
        for p_, (o, r, s_) in enumerate(zip(got, ref, split)):
            wsum = (a * kk ** p_).sum(-1) * (2 * math.pi) ** p_
            e = (o.double() - r).abs()
            errs.append(float(e.max()))
            if bool((e > 2e-6 * (wsum + a.sum(-1))).any()):
                raise AssertionError(f"merged moments[{name}] term {p_} "
                                     "disagrees with its twin")
            d = (o.double() - s_.double()).abs()
            vs_split.append(float((d / wsum).max()))
            bitwise = bitwise and bool(torch.equal(o, s_))
            if bool((d > eps * wsum).any()):
                raise AssertionError(f"merged moments[{name}] term {p_} "
                                     "differs from the split kernel by "
                                     "more than 1 ulp of sum |summand|")
        ms = cuda_ms(lambda: mom.phase_moments_merged(phis, g))
        split_ms = cuda_ms(lambda: mom.phase_moments(phis, Gr, Gi))
        plain = cuda_ms(lambda: mom.phase_moments_merged_reference(phis, g))
        rows = phis.numel()
        bnd, by = bound_ms(rows * (8 * nh + 16), rows * nh * PHASE_OPS)
        log(f"merged moments[{name}] rows={rows} nh={nh} max abs err "
            f"C/Cp/Cpp {errs}; vs split kernel, largest |diff| / sum "
            f"|summand| {vs_split} (bitwise equal: {bitwise}); kernel "
            f"{ms:.4f} ms, split kernel {split_ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        rec[name] = dict(max_abs_err=errs[0], ms=ms, plain_ms=plain,
                         split_kernel_ms=split_ms, bound_ms=bnd, bound_by=by,
                         max_abs_err_all=errs, bitwise_equal_split=bitwise,
                         rows=rows, nh=nh)
        del g, Gr, Gi
    return rec


def tr_solve_inputs(dev, dtype, B=64, seed=6):
    """B subproblems shaped like the (phi, DM, tau, alpha) fit's, n = 5
    with the GM row and column an identity and g 0 there: the fitted
    block's curvatures a scale 10^U(-3, 13) times eigenvalues log-uniform
    in [1e-3, 1], every fourth item's lowest eigenvalue negative; radii
    log-uniform in [1e-3, 1e4] (interior and boundary steps)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g = np.zeros((B, 5))
    H = np.zeros((B, 5, 5))
    fit = [0, 1, 3, 4]
    for b in range(B):
        Q = np.linalg.qr(rng.normal(size=(4, 4)))[0]
        lam = 10.0 ** rng.uniform(-3.0, 0.0, 4)
        if b % 4 == 3:
            lam[0] = -lam[0]
        scale = 10.0 ** rng.uniform(-3.0, 13.0)
        H[b][np.ix_(fit, fit)] = scale * (Q * lam) @ Q.T
        H[b, 2, 2] = 1.0
        g[b, fit] = scale * (Q @ rng.normal(size=4))
    r = 10.0 ** rng.uniform(-3.0, 4.0, B)
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in (g, H, r)]


def phase_tr_solve(dev):
    """The trust-region subproblem kernel (csrc/tr_solve.cu) against
    tr_solve_reference in float64 on the CPU, B = 64, n = 5, float32 with
    the hard case (what a float32 fit's Newton loop runs) and float64
    without it (a float64 fit's): |p - p_ref| within 2.5e-7 / 1e-9 of
    |p_ref| (p rounded to float32; two eigensolvers' rounding at
    condition <= 1e3), 2e-6 for the hard case's indefinite items (a
    boundary step that rounds short of the radius gets sqrt(2 delta) of
    it along v0), the GM component left out (the loop's step_mask pins
    it), and hit the same.  Timed by CUDA events beside the wall of
    the eager path it replaced (tr_solve_reference on the card: ~676
    launches and eigh's host sync), the yardstick."""
    import torch

    from pulseportraiture_tpu_torch.ops import tr_solve as trs

    rec = {}
    for dtype, hard, tol in ((torch.float32, True, 2.5e-7),
                             (torch.float64, False, 1e-9)):
        g, H, r = tr_solve_inputs(dev, dtype)
        n0 = trs.tr_solve.launches
        p, hit = trs.tr_solve(g, H, r, hard_case=hard)
        torch.cuda.synchronize()
        if trs.tr_solve.launches != n0 + 1:
            raise AssertionError("tr_solve: not one launch")
        want, want_hit = trs.tr_solve_reference(
            *(a.cpu().double() for a in (g, H, r)), hard_case=hard)
        want = want.to(dtype).double()
        keep = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], dtype=torch.float64)
        d = ((p.cpu().double() - want) * keep).norm(dim=-1)
        gap = d / (want * keep).norm(dim=-1)
        bound = torch.full_like(gap, tol)
        if hard:
            bound[3::4] = 2e-6
        rel = float(gap.max())
        if not torch.equal(hit.cpu(), want_hit) or bool((gap > bound).any()):
            raise AssertionError(f"tr_solve[{dtype}]: hit "
                                 f"{hit.cpu().tolist()} vs "
                                 f"{want_hit.tolist()}, |p - p_ref| / "
                                 f"|p_ref| {gap.tolist()} (bound {tol}, "
                                 "2e-6 where indefinite)")
        ms = cuda_ms(lambda: trs.tr_solve(g, H, r, hard_case=hard), reps=50)
        trs.tr_solve_reference(g, H, r, hard_case=hard)
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            trs.tr_solve_reference(g, H, r, hard_case=hard)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        eager = statistics.median(walls)
        name = str(dtype).split(".")[-1]
        log(f"tr_solve[{name}] B=64 n=5 hard_case={hard}: |p - p_ref| / "
            f"|p_ref| <= {rel:.3e}, {int(hit.sum())} boundary "
            f"steps; kernel {ms:.4f} ms (CUDA events), eager path "
            f"{eager:.3f} ms (wall, median of 10)")
        rec[name] = dict(max_abs_err=rel, ms=ms, plain_ms=eager,
                         eager_wall_ms=eager, bound_ms=None,
                         bound_by="latency", hard_case=hard,
                         boundary_steps=int(hit.sum()))
    return rec


def mjd_diff_rot(a, b):
    """(a - b) of two TOAs' epochs in turns of P, wrapped to [-0.5, 0.5):
    a channel whose shift lies at half a turn may come out on either
    side."""
    return ((a.MJD - b.MJD) / P + 0.5) % 1.0 - 0.5


def phase_narrowband(files, tmpl, injected):
    """get_narrowband_TOAs on the card: 2 archives x 4 subints x 4096
    channels; returns (launch counts, figures)."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    reset_launches()
    t0 = time.perf_counter()
    gt.get_narrowband_TOAs(print_phase=True, quiet=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = len(gt.TOA_list)
    log(f"narrowband: {n} TOAs in {wall:.2f} s ({n / wall:.1f} TOAs/s; "
        f"timing {json.dumps(gt.fit_timing)}); launches {launches}")
    if n != injected.size:
        raise AssertionError(f"expected {injected.size} TOAs, got {n}")
    phs = np.array([t.flags["phs"] for t in gt.TOA_list])
    err = np.array([t.flags["phs_err"] for t in gt.TOA_list])
    snr = np.array([t.flags["snr"] for t in gt.TOA_list])
    # the data are the template rotated earlier by `injected`
    z = (np.mod(phs + injected.ravel() + 0.5, 1.0) - 0.5) / err
    ok = snr > 8.0
    log(f"narrowband: {int(ok.sum())} channels above S/N 8 (median S/N "
        f"{np.median(snr):.1f}), max |phase - injection| "
        f"{np.abs(z[ok]).max():.3f} sigma, rms {np.sqrt(np.mean(z[ok] ** 2)):.3f}")
    if not ok.any() or np.abs(z[ok]).max() > 5.0:
        raise AssertionError("narrowband phases off the injection")
    # one archive through the float64 twin route on the CPU
    ref = GetTOAs(files[:1], tmpl, device="cpu", dtype=torch.float64,
                  quiet=True)
    ref.get_narrowband_TOAs(quiet=True)
    agree = max(abs(mjd_diff_rot(a, b)) * P * 1e6 / b.TOA_error
                for a, b in zip(gt.TOA_list, ref.TOA_list))
    log(f"narrowband: card float32 route vs float64 twin route on the CPU, "
        f"{len(ref.TOA_list)} TOAs: {agree:.2e} sigma")
    if agree > 1e-2:
        raise AssertionError(f"narrowband card route vs f64 twin route: "
                             f"{agree:.3e} sigma > 0.01")
    if launches["phase_moments_merged"] <= 0:
        raise AssertionError(f"phase_moments_merged did not launch on the "
                             f"narrowband path: {launches}")
    return launches, dict(toas=n, seconds=wall, toas_per_s=n / wall,
                          timing=dict(gt.fit_timing), twin_sigma=agree,
                          max_z=float(np.abs(z[ok]).max()))


def phase_narrowband_scat(rng):
    """get_narrowband_TOAs(fit_scat=True) on one scattered subint: 4096
    single-channel (phi, tau) fits on the card."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    t_scat = TAU0 * P
    files, _, tmpl, _ = write_archives(rng, nsub=1, t_scat=t_scat,
                                       tag="nbscat", narch=1)
    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    reset_launches()
    t0 = time.perf_counter()
    gt.get_narrowband_TOAs(fit_scat=True, quiet=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = len(gt.TOA_list)
    log(f"narrowband fit_scat: {n} TOAs in {wall:.2f} s (timing "
        f"{json.dumps(gt.fit_timing)}); launches {launches}")
    if n != NCHAN:
        raise AssertionError(f"expected {NCHAN} TOAs, got {n}")
    tau = np.array([t.flags["scat_time"] for t in gt.TOA_list]) * 1e-6
    tau_err = np.array([t.flags["scat_time_err"] for t in gt.TOA_list]) * 1e-6
    nu = np.array([t.frequency for t in gt.TOA_list])
    inj = t_scat * (nu / 1500.0) ** ALPHA0
    good = np.isfinite(tau) & (tau > 0) & np.isfinite(tau_err) & (tau_err > 0)
    # pulls in ln tau, the space the fit works in (log10 tau)
    z = np.log(tau[good] / inj[good]) / (tau_err[good] / tau[good])
    med = float(np.median(z))
    med_sigma = 1.2533 * float(np.std(z)) / math.sqrt(z.size)
    log(f"narrowband fit_scat: {int(good.sum())} of {n} channels with a "
        f"finite scat_time; pulls against tau(nu): median {med:+.4f}, "
        f"std {np.std(z):.3f}, the median's scatter {med_sigma:.4f}; "
        f"median scat_time / injection "
        f"{np.median(tau[good] / inj[good]):.5f}")
    if good.sum() < 0.99 * n:
        raise AssertionError("per-channel scattering fits without a result")
    if abs(med) > 3.0 * med_sigma:
        raise AssertionError(f"median per-channel scat_time off the "
                             f"injection: {med:+.4f} > 3 x {med_sigma:.4f}")
    # the same subint through the float64 twin route on the CPU
    t0 = time.perf_counter()
    ref = GetTOAs(files, tmpl, device="cpu", dtype=torch.float64, quiet=True)
    ref.get_narrowband_TOAs(fit_scat=True, quiet=True)
    if len(ref.TOA_list) != n:
        raise AssertionError(f"the float64 twin route gave "
                             f"{len(ref.TOA_list)} TOAs, the card {n}")
    dphi = np.array([abs(mjd_diff_rot(a, b)) * P * 1e6 / b.TOA_error
                     for a, b in zip(gt.TOA_list, ref.TOA_list)])
    rtau = np.array([t.flags["scat_time"] for t in ref.TOA_list])
    rtau_err = np.array([t.flags["scat_time_err"] for t in ref.TOA_list])
    dtau = np.abs(tau * 1e6 - rtau) / rtau_err
    both = good & np.isfinite(dphi) & np.isfinite(dtau)
    # A channel whose noise prefers tau <= 0 has no optimum in log10 tau:
    # chi2 falls ever more slowly towards tau -> 0, each route stops on
    # that floor where its float type resolves no further decrease, and
    # scat_time_err comes out orders of magnitude above scat_time; a
    # channel on the way there (scat_time below its error) converges
    # linearly, not quadratically, and float32 stops it a little early.
    # The routes are held to 0.01 sigma where the twin measures tau at 1
    # sigma or better; the other channels are counted and held to one
    # sigma.
    res = both & (rtau_err <= rtau)
    unres = both & ~res
    agree = max(float(dphi[res].max()), float(dtau[res].max()))
    d_un = np.maximum(dphi, dtau)[unres]
    rel_un = (rtau_err / rtau)[unres]
    mid = d_un[rel_un <= 10.0]
    loose = float(d_un.max()) if d_un.size else 0.0
    log(f"narrowband fit_scat: card float32 route vs float64 twin route on "
        f"the CPU ({time.perf_counter() - t0:.2f} s): {int(res.sum())} "
        f"channels with scat_time_err <= scat_time in the twin: phase max "
        f"{dphi[res].max():.2e}, scat_time max {dtau[res].max():.2e} sigma; "
        f"{int(unres.sum())} channels below that: {mid.size} with "
        f"scat_time_err <= 10 scat_time, max "
        f"{float(mid.max()) if mid.size else 0.0:.2e} sigma, "
        f"{d_un.size - mid.size} beyond, max {loose:.2e} sigma")
    if both.sum() < 0.99 * n or res.sum() < 0.75 * n or agree > 1e-2:
        raise AssertionError(f"narrowband fit_scat card route vs f64 twin "
                             f"route: {agree:.3e} sigma > 0.01 on "
                             f"{int(res.sum())} resolved channels")
    if loose > 1.0:
        raise AssertionError(f"narrowband fit_scat: an unresolved channel "
                             f"differs by {loose:.3e} sigma between routes")
    if min(launches["phase_moments_merged"], launches["fused_setup"],
           launches["scattering_moments"]) <= 0:
        raise AssertionError(f"a kernel did not launch on the narrowband "
                             f"fit_scat path: {launches}")
    return files, tmpl, launches, dict(toas=n, seconds=wall, median_pull=med,
                                       median_pull_sigma=med_sigma,
                                       twin_sigma=agree,
                                       unresolved=int(unres.sum()),
                                       unresolved_twin_sigma=loose)


def phase_psrchive(files, tmpl):
    """get_psrchive_TOAs on the card, each of the six estimators on one
    subint at full width."""
    import numpy as np

    from pulseportraiture_tpu_torch.fitters.arrival_time import ALGORITHMS
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    reset_launches()
    out, secs = {}, {}
    for alg in ALGORITHMS:
        t0 = time.perf_counter()
        out[alg] = gt.get_psrchive_TOAs(algorithm=alg, quiet=True)
        secs[alg] = round(time.perf_counter() - t0, 3)
    launches = read_launches()
    log(f"psrchive: 6 algorithms x {len(out['PGS'])} TOAs, seconds {secs}; "
        f"launches {launches}")
    log("psrchive: " + gt.psrchive_toas[0][0])
    snr = np.array([t.flags["snr"] for t in out["PGS"]])
    ok = snr > 8.0
    for alg in ALGORITHMS:
        if len(out[alg]) != NCHAN:
            raise AssertionError(f"psrchive[{alg}]: {len(out[alg])} TOAs")
        e = np.array([t.TOA_error for t in out[alg]])
        if not np.all(np.isfinite(e[ok]) & (e[ok] > 0.0)):
            raise AssertionError(f"psrchive[{alg}]: a shift_err is not "
                                 "finite and positive above S/N 8")
    d = {alg: float(np.abs(np.array(
        [mjd_diff_rot(a, b) for a, b in zip(out[alg], out["PGS"])]))[ok].max())
        for alg in ALGORITHMS[1:]}
    log(f"psrchive: {int(ok.sum())} channels above S/N 8; largest shift "
        f"difference from PGS [rot]: {d} (one bin: {1.0 / NBIN:.3e})")
    if d["SIS"] > 1e-6 or d["FDM"] > 1e-6:
        raise AssertionError("PGS, FDM and SIS point estimates differ")
    if max(d["PIS"], d["GIS"]) > 1.0 / NBIN:
        raise AssertionError("PIS/GIS more than one bin from PGS")
    if launches["phase_moments_merged"] <= 0:
        raise AssertionError(f"phase_moments_merged did not launch on the "
                             f"psrchive path: {launches}")
    return launches, dict(seconds=secs, max_diff_from_PGS=d)


def write_gmodel():
    """bench_template as a two-component .gmodel (code 000: power laws;
    positions and widths constant, amplitudes with index -1.5)."""
    fwhm = 2.0 * math.sqrt(2.0 * math.log(2.0))
    path = os.path.join(WORK, "bench.gmodel")
    comp = "COMP%02d % .8f %d  % .8f %d  % .8f %d  % .8f %d  % .8f %d  % .8f %d\n"
    with open(path, "w") as f:
        f.write("MODEL   bench\nCODE    000\nFREQ    1500.00000\n")
        f.write("DC      0.00000000 0\nTAU     0.00000000 0\n")
        f.write("ALPHA  -4.000      0\n")
        f.write(comp % (1, 0.4, 0, 0.0, 0, 0.02 * fwhm, 0, 0.0, 0, 1.0, 0,
                        -1.5, 0))
        f.write(comp % (2, 0.47, 0, 0.0, 0, 0.01 * fwhm, 0, 0.0, 0, 0.4, 0,
                        -1.5, 0))
    return path


def phase_pipeline_gmodel(files, dDMs):
    """The (phi, DM) pipeline on the card with a .gmodel template."""
    import numpy as np

    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gt = GetTOAs(files, write_gmodel(), device="cuda", quiet=True)
    reset_launches()
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    rec = np.asarray(gt.DeltaDM_means)
    err = np.asarray(gt.DeltaDM_errs)
    log(f".gmodel pipeline: {len(gt.TOA_list)} TOAs in {wall:.2f} s (timing "
        f"{json.dumps(gt.fit_timing)}); mharm {gt.mharms}; DeltaDM "
        f"{rec.tolist()} +- {err.tolist()}, injected {dDMs}; launches "
        f"{launches}")
    if len(gt.TOA_list) != 8:
        raise AssertionError(f"expected 8 TOAs, got {len(gt.TOA_list)}")
    if not np.all(np.abs(rec - dDMs) <= 3 * err):
        raise AssertionError("injected dDM not recovered within 3 sigma "
                             "with the .gmodel template")
    if min(launches["fused_setup"], launches["phase_moments"]) <= 0:
        raise AssertionError(f"a kernel did not launch on the .gmodel "
                             f"path: {launches}")
    return launches


def gm_recipe(dev, B, seed=5):
    """phidm_recipe's data with a GM injected: bench_template shifted by
    phi ~ U(-0.01, 0.01) rot, DM ~ U(-2e-4, 2e-4) and a GM whose nu^-4
    delay spans up to +-0.005 rot across the band, all at the band's mean
    frequency, noise NOISE.  Returns (data, freqs, model, phis, dms, gms,
    nu_fit)."""
    import torch

    from pulseportraiture_tpu_torch.config import DCONST
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    freqs = torch.linspace(1100.0, 1900.0, NCHAN, **f64)
    model = bench_template(freqs.cpu().numpy())
    nu_fit = float(freqs.mean())
    span4 = DCONST ** 2 / P * (1100.0 ** -4 - 1900.0 ** -4)
    phis = torch.rand(B, generator=gen, **f64) * 0.02 - 0.01
    dms = torch.rand(B, generator=gen, **f64) * 4e-4 - 2e-4
    gms = (torch.rand(B, generator=gen, **f64) * 2.0 - 1.0) * 0.005 / span4
    shifts = phis[:, None] + DCONST * dms[:, None] / P * (
        freqs[None, :] ** -2 - nu_fit ** -2) + \
        DCONST ** 2 * gms[:, None] / P * (freqs[None, :] ** -4 -
                                          nu_fit ** -4)
    mft = torch.fft.rfft(torch.as_tensor(model, **f64), dim=-1)
    data = shifted_data(mft, shifts, gen, NOISE, dev)
    return data, freqs, model, phis, dms, gms, nu_fit


def phase_gm_fit(dev):
    """Batched (phi, DM, GM) fits at 4096 x 2048, B=64, capped and full
    band, on gm_recipe's data."""
    import torch

    from pulseportraiture_tpu_torch.config import DCONST
    from pulseportraiture_tpu_torch.fitters.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft

    B, ff = 64, (1, 1, 1, 0, 0)
    data, freqs, model, phis, dms, gms, nu_fit = gm_recipe(dev, B)
    routes = template_routes(model)

    def args(d, dt, n):
        t = dict(dtype=dt, device=d)
        return (torch.zeros((n, 5), **t), torch.full((n,), P, **t),
                freqs.to(**t), torch.full((n, NCHAN), NOISE, **t))

    def at_fit(res):
        """(phi at nu_fit, DM, GM) and their sigmas, float64 on the CPU:
        phi moved from the output reference by DM and GM, its sigma from
        the fitted covariance."""
        p = res.params.double().cpu()
        nu = res.nu_DM.double().cpu()
        j2 = DCONST / P * (nu_fit ** -2 - nu ** -2)
        j4 = DCONST ** 2 / P * (nu_fit ** -4 - nu ** -4)
        J = torch.stack([torch.ones_like(j2), j2, j4], dim=-1)
        C = res.covariance_matrix.double().cpu()[:, :3, :3]
        sig_phi = torch.sqrt(torch.einsum("bi,bij,bj->b", J, C, J))
        e = res.param_errs.double().cpu()
        phi = p[:, 0] + j2 * p[:, 1] + j4 * p[:, 2]
        return (torch.stack([phi, p[:, 1], p[:, 2]], dim=-1),
                torch.stack([sig_phi, e[:, 1], e[:, 2]], dim=-1))

    inj = torch.stack([phis, dms, gms], dim=-1).cpu()
    out = {}
    sd0, mm0 = sdft.fused_setup.launches, mom.phase_moments.launches
    route = sdft.setup_route(NBIN)
    r0 = sdft.fused_setup.routes[route]
    for name, mft_ri in routes.items():
        def run():
            return fit_portrait_full_batch(
                data, mft_ri, *args(dev, torch.float32, B),
                nu_fits=torch.full((B, 3), nu_fit, dtype=torch.float32,
                                   device=dev), fit_flags=ff,
                dtype=torch.float32)
        res = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        rc = res.return_code.cpu()
        if not bool((rc < 3).all()):
            raise AssertionError(f"gm fit[{name}] items not converged: {rc}")
        nu = res.nu_DM.double().cpu()
        if not bool(((nu > 1100.0) & (nu < 1900.0)).all()):
            raise AssertionError(f"gm fit[{name}] nu_DM outside the band: "
                                 f"{nu.min().item()}..{nu.max().item()}")
        v, sig = at_fit(res)
        z = ((v - inj) / sig).abs().amax(dim=0).tolist()
        if max(z) > 5:
            raise AssertionError(f"gm fit[{name}] off the injection: "
                                 f"phi, DM, GM {z} sigma")
        nc = 8
        cpu = torch.device("cpu")
        ref = fit_portrait_full_batch(
            data[:nc].cpu(), mft_ri, *args(cpu, torch.float64, nc),
            nu_fits=torch.full((nc, 3), nu_fit, dtype=torch.float64),
            fit_flags=ff, dtype=torch.float64)
        rv, rsig = at_fit(ref)
        agree = ((v[:nc] - rv) / rsig).abs().amax(dim=0).tolist()
        mean_niter = float(res.niter.double().mean())
        log(f"gm fit[{name}] B={B} nh={mft_ri[0].shape[-1]}: "
            f"{B / sec:.2f} fits/s ({sec * 1e3:.2f} ms/batch, median of 3), "
            f"mean niter {mean_niter}, max |z| (phi, DM, GM) {z}, nu_DM "
            f"{nu.min().item():.3f}..{nu.max().item():.3f} MHz, card route "
            f"vs f64 twin route (phi, DM, GM) {agree} sigma")
        if max(agree) > 1e-2:
            raise AssertionError(f"gm fit[{name}] kernel route vs f64 twin "
                                 f"route: {agree} sigma > 0.01")
        out[name] = dict(fits_per_s=B / sec, sec_per_batch=sec,
                         mean_niter=mean_niter, twin_sigma=agree, max_z=z)
    launches = (sdft.fused_setup.launches - sd0,
                mom.phase_moments.launches - mm0)
    log(f"gm-fit phase launches: fused_setup {launches[0]}, "
        f"phase_moments {launches[1]}")
    if min(launches) <= 0:
        raise AssertionError("a kernel did not launch in the gm-fit phase")
    if sdft.fused_setup.routes[route] - r0 != launches[0]:
        raise AssertionError("a setup launch of the gm-fit phase left the "
                             "FFT route")
    return out


def toa_sigmas(got, want):
    """Largest |TOA| (moved to want's frequency by want's DM and GM), |DM|
    and |GM| differences of two TOA lists of one archive, in want's
    sigmas."""
    from pulseportraiture_tpu_torch.config import DCONST
    z = [0.0, 0.0, 0.0]
    for a, b in zip(got, want):
        gm = b.flags.get("gm", 0.0)
        dt = (a.MJD - b.MJD) + DCONST * b.DM * (
            b.frequency ** -2 - a.frequency ** -2) + DCONST ** 2 * gm * (
            b.frequency ** -4 - a.frequency ** -4)
        z[0] = max(z[0], abs(dt) * 1e6 / b.TOA_error)
        z[1] = max(z[1], abs(a.DM - b.DM) / b.DM_error)
        if "gm" in b.flags:
            z[2] = max(z[2], abs(a.flags["gm"] - gm) / b.flags["gm_err"])
    return z


def phase_pipeline_gm(pipe_arch, scat_arch):
    """GetTOAs(fit_GM=True) on the card on the pipeline phase's archives,
    and with fit_scat on the scattered ones; returns the launch counts of
    each run, the figures and the fit_GM run's TOAs."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.tim import write_TOAs
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    rec, launches, toas = {}, {}, {}
    for name, (files, dDMs, tmpl), kw in (
            ("pipeline_gm", pipe_arch, dict(fit_GM=True)),
            ("pipeline_gm_fit_scat", scat_arch,
             dict(fit_GM=True, fit_scat=True))):
        gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
        reset_launches()
        t0 = time.perf_counter()
        gt.get_TOAs(quiet=True, **kw)
        wall = time.perf_counter() - t0
        launches[name] = read_launches()
        toas[name] = gt.TOA_list
        lines = write_TOAs(gt.TOA_list, outfile=os.path.join(
            WORK, f"{name}.tim"), append=False)
        recd = np.asarray(gt.DeltaDM_means)
        err = np.asarray(gt.DeltaDM_errs)
        gz = [t.flags["gm"] / t.flags["gm_err"] for t in gt.TOA_list]
        log(f"{name}: {len(lines)} TOAs in {wall:.2f} s (timing "
            f"{json.dumps(gt.fit_timing)}); DeltaDM {recd.tolist()} +- "
            f"{err.tolist()}, injected {dDMs}; GM/sigma (none injected) "
            f"{[round(z, 3) for z in gz]}; launches {launches[name]}")
        log(f"{name}: " + lines[0])
        if len(lines) != (16 if name == "pipeline_gm" else 8) or not all(
                " -gm " in ln and " -gm_err " in ln for ln in lines):
            raise AssertionError(f"{name}: {len(lines)} TOA lines, or a "
                                 "line without gm/gm_err")
        if not np.all(np.abs(recd - dDMs) <= 3 * err):
            raise AssertionError(f"{name}: injected dDM not recovered "
                                 "within 3 sigma")
        kern = "scattering_moments" if "scat" in name else "phase_moments"
        if min(launches[name]["fused_setup"], launches[name][kern]) <= 0:
            raise AssertionError(f"a kernel did not launch on the {name} "
                                 f"path: {launches[name]}")
        rec[name] = dict(toas=len(lines), wall_s=wall,
                         max_gm_over_sigma=max(abs(z) for z in gz))
        # one archive through the float64 twins on the CPU
        t0 = time.perf_counter()
        ref = GetTOAs(files[:1], tmpl, device="cpu",
                      dtype=torch.float64, quiet=True)
        ref.get_TOAs(quiet=True, **kw)
        z = toa_sigmas(gt.TOA_list[:len(ref.TOA_list)], ref.TOA_list)
        log(f"{name}: card vs the float64 CPU run of {files[0]} "
            f"(TOA, DM, GM): {z} sigma ({time.perf_counter() - t0:.1f} "
            f"s on the CPU)")
        if max(z) > 1e-2:
            raise AssertionError(f"{name}: card vs float64 CPU run "
                                 f"{z} sigma > 0.01")
        rec[name]["vs_f64_sigma"] = z
    return (launches["pipeline_gm"], launches["pipeline_gm_fit_scat"], rec,
            toas["pipeline_gm"])


def scat_sigmas(got, want):
    """Largest |log10 scat_time| difference of two fit_scat TOA lists, in
    want's sigmas."""
    return max(abs(a.flags["log10_scat_time"] - b.flags["log10_scat_time"]) /
               b.flags["log10_scat_time_err"] for a, b in zip(got, want))


def phase_mesh(pipe_arch, scat_arch, unsharded):
    """get_TOAs(mesh=...) on the card: a 2 x 2 mesh laid over the one card
    (make_mesh(2, 2, devices=["cuda:0"] * 4): the sharded logic, two
    batch shards in host threads, two channel slabs each, not a speed-up)
    on phase 6's archives with and without fit_GM and on phase 7's with
    fit_scat.  Every TOA, DM (GM, log10 scat_time) within 0.01 sigma of
    the unsharded card run (`unsharded`: name -> TOA list); every shard
    launched the setup and the moments kernel, the setup once a chunk
    (the global count = shards x chunks = the shards' tallies added).
    Where several cards are visible, also make_mesh() over them.
    Returns the launch counts of each run and the figures."""
    import torch

    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    runs = [("mesh", pipe_arch, {}, "pipeline"),
            ("mesh_gm", pipe_arch, dict(fit_GM=True), "pipeline_gm"),
            ("mesh_fit_scat", scat_arch, dict(fit_scat=True),
             "pipeline_fit_scat")]
    meshes = [("2x2 on cuda:0", make_mesh(2, 2, devices=["cuda:0"] * 4))]
    ncard = torch.cuda.device_count()
    if ncard > 1:
        meshes.append((f"make_mesh() over {ncard} cards", make_mesh()))
    else:
        log("mesh: the multi-card run did not happen (1 card visible); the "
            "2 x 2 mesh runs on cuda:0")
    paths, rec = {}, {}
    for label, mesh in meshes:
        nshard = mesh.shape["batch"] * mesh.shape["chan"]
        for name, (files, _, tmpl), kw, ref in runs:
            if label != meshes[0][0]:
                name = name + "_cards"
            gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
            mesh.reset_launches()
            reset_launches()
            t0 = time.perf_counter()
            gt.get_TOAs(quiet=True, mesh=mesh, **kw)
            wall = time.perf_counter() - t0
            launches = read_launches()
            chunks = gt.fit_timing["batched_chunks"]
            z = toa_sigmas(gt.TOA_list, unsharded[ref])
            if "fit_scat" in kw:
                z.append(scat_sigmas(gt.TOA_list, unsharded[ref]))
            kern = ("scattering_moments" if "fit_scat" in kw
                    else "phase_moments")
            shard_setup = [c.get("fused_setup", 0)
                           for c in mesh.launches.values()]
            shard_mom = [c.get(kern, 0) for c in mesh.launches.values()]
            log(f"{name} ({label}): {len(gt.TOA_list)} TOAs in {wall:.2f} s "
                f"(timing {json.dumps(gt.fit_timing)}); vs the unsharded card "
                f"run (TOA, DM, GM[, log10 scat_time]): {z} sigma; launches "
                f"{launches}; per shard {mesh.launches}")
            if len(gt.TOA_list) != len(unsharded[ref]):
                raise AssertionError(f"{name}: {len(gt.TOA_list)} TOAs")
            if max(z) > 1e-2:
                raise AssertionError(f"{name}: {z} sigma from the unsharded "
                                     "card run > 0.01")
            if min(shard_mom) <= 0 or chunks <= 0 or \
                    shard_setup != [chunks] * nshard or \
                    launches["fused_setup"] != nshard * chunks:
                raise AssertionError(
                    f"{name}: a shard's kernels did not launch, or the setup "
                    f"launches ({launches['fused_setup']}, per shard "
                    f"{shard_setup}) are not shards x chunks ({nshard} x "
                    f"{chunks})")
            paths[name] = launches
            rec[name] = dict(mesh=label, toas=len(gt.TOA_list), wall_s=wall,
                             chunks=chunks, shards=nshard,
                             vs_unsharded_sigma=z,
                             launches_by_shard={f"{k[0]},{k[1]}": v for k, v
                                                in mesh.launches.items()})
    rec["multi_card"] = ncard > 1
    return paths, rec


def phase_profiling(dev):
    """profiling.trace around one B=64 (phi, DM) batch at 4096 x 2048
    (capped; a warm-up batch first): the Chrome trace must name the setup
    FFT and phase-moments kernels and the annotate range.  Returns the
    trace's figures."""
    import torch

    from pulseportraiture_tpu_torch import profiling
    from pulseportraiture_tpu_torch.fitters.portrait import \
        fit_portrait_full_batch

    B = 64
    data, freqs, model, _, _, nu_fit = phidm_recipe(dev, B, seed=11)
    mft_ri = template_routes(model)["capped"]
    t = dict(dtype=torch.float32, device=dev)

    def run():
        return fit_portrait_full_batch(
            data, mft_ri, torch.zeros((B, 5), **t), torch.full((B,), P, **t),
            freqs.to(**t), torch.full((B, NCHAN), NOISE, **t),
            nu_fits=torch.full((B, 3), nu_fit, **t), dtype=torch.float32)

    run()
    torch.cuda.synchronize()
    tdir = os.path.join(WORK, "trace")
    t0 = time.perf_counter()
    with profiling.trace(tdir):
        with profiling.annotate("pp_fit_batch"):
            run()
    wall = time.perf_counter() - t0
    (name,) = [f for f in os.listdir(tdir) if f.endswith(".json")]
    with open(os.path.join(tdir, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    names = {e.get("name", "") for e in events}
    found = {k: sum(1 for e in kernels if k in e.get("name", ""))
             for k in ("setup_fft_kernel", "phase_moments_kernel")}
    log(f"profiling: trace {name} ({os.path.getsize(os.path.join(tdir, name))}"
        f" bytes) of one B={B} capped batch, {wall:.2f} s traced; "
        f"{len(kernels)} kernels, {busy_ms:.3f} ms busy; by name {found}; "
        f"annotate range 'pp_fit_batch' {'pp_fit_batch' in names}")
    if min(found.values()) <= 0 or "pp_fit_batch" not in names:
        raise AssertionError("profiling: the trace does not name the hand "
                             "kernels and the annotate range")
    shutil.rmtree(tdir, ignore_errors=True)
    return dict(kernels=len(kernels), busy_ms=busy_ms, wall_s=wall,
                by_name=found)


def phase_zap(seed=42):
    """Channel zapping on the card: one archive x 4 subints whose channels
    at 1/42, 3/8, 1/2 and 13/16 of the band carry interference (5x the
    noise), from its own seed (the phases after it keep their data);
    returns the launch counts of its get_TOAs run and the figures."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.psrfits import read_psrfits
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    from pulseportraiture_tpu_torch.pipelines.zap import zap_archive

    chans = [NCHAN // 42, NCHAN * 3 // 8, NCHAN // 2, NCHAN * 13 // 16]
    rng = np.random.default_rng(seed)
    files, _, tmpl, _ = write_archives(rng, nsub=4, tag="zap", narch=1,
                                       rfi_chans=chans)
    gt = GetTOAs(files, tmpl, device="cuda", quiet=True)
    reset_launches()
    t0 = time.perf_counter()
    gt.get_TOAs(quiet=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    zaps = gt.get_channels_to_zap()
    zap_s = time.perf_counter() - t0
    log(f"zap: {len(gt.TOA_list)} TOAs in {wall:.2f} s; "
        f"get_channels_to_zap {zap_s * 1e3:.2f} ms: {zaps}; launches "
        f"{launches}")
    if zaps != [[chans] * 4]:
        raise AssertionError(f"zap: channels {zaps}, injected {chans}")
    gt.fit_channel_red_chi2s = []         # through show_fit on the card
    t0 = time.perf_counter()
    legacy = gt.get_channels_to_zap()
    legacy_s = time.perf_counter() - t0
    ref = GetTOAs(files, tmpl, device="cpu", dtype=torch.float64,
                  quiet=True)
    ref.get_TOAs(quiet=True)
    ref_zaps = ref.get_channels_to_zap()
    log(f"zap: show_fit path {legacy_s:.2f} s: {legacy}; float64 CPU run: "
        f"{ref_zaps}")
    if legacy != zaps or ref_zaps != zaps:
        raise AssertionError("zap: the show_fit path or the float64 CPU run "
                             "disagrees")
    out = os.path.join(WORK, "zapped.fits")
    free = zap_archive(files[0], out, device="cuda")
    w = read_psrfits(out).weights
    log(f"zap: zap_archive zapped {sorted({c for z in free for c in z})}")
    if w[:, chans].any():
        raise AssertionError("zap: zap_archive left an injected channel "
                             "weighted")
    gz = GetTOAs([out], tmpl, device="cuda", quiet=True)
    gz.get_TOAs(quiet=True)
    if len(gz.TOA_list) != 4 or gz.TOA_list[0].flags["nchx"] > \
            NCHAN - len(chans):
        raise AssertionError("zap: get_TOAs on the zapped archive")
    if min(launches["fused_setup"], launches["phase_moments"]) <= 0:
        raise AssertionError(f"a kernel did not launch on the zap path: "
                             f"{launches}")
    return launches, dict(channels=zaps[0][0], wall_s=wall,
                          get_channels_to_zap_ms=zap_s * 1e3,
                          show_fit_path_s=legacy_s,
                          model_free=sorted({c for z in free for c in z}))


TB_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))
# bench_template's truth: locs 0.4 / 0.47, sigmas 0.02 / 0.01 rot,
# amplitudes 1 / 0.4 at 1500 MHz, both with index -1.5
TB_TRUTH = dict(separation=0.07, wid_main=0.02 * TB_FWHM,
                wid_second=0.01 * TB_FWHM, amp_ratio=0.4, amp_index=-1.5)


def gauss_truth_z(params, errs):
    """(value, error) of each bench_template truth figure from a
    two-component .gmodel fit (layout [dc, tau, (loc, m_loc, wid, m_wid,
    amp, m_amp) x 2]), the main component the brighter; and the z of
    each against TB_TRUTH."""
    comps = [(params[2 + 6 * i: 8 + 6 * i], errs[2 + 6 * i: 8 + 6 * i])
             for i in range(2)]
    (a, ea), (b, eb) = sorted(comps, key=lambda c: -c[0][4])
    ratio = b[4] / a[4]
    got = dict(
        separation=((b[0] - a[0] + 0.5) % 1.0 - 0.5, math.hypot(ea[0], eb[0])),
        wid_main=(a[2], ea[2]), wid_second=(b[2], eb[2]),
        amp_ratio=(ratio, abs(ratio) * math.hypot(ea[4] / a[4],
                                                  eb[4] / b[4])),
        amp_index_main=(a[5], ea[5]), amp_index_second=(b[5], eb[5]))
    z = {}
    for key, (v, e) in got.items():
        want = TB_TRUTH["amp_index" if key.startswith("amp_index") else key]
        z[key] = (v - want) / e if e > 0 else math.inf
    return got, z


def check_template_toas(gt, dDMs, name, ntoa):
    """TOA count, gof < 2 on every TOA, and the relative dDM structure
    ((rec - mean) - (inj - mean)) within 5 sigma: a template built from
    the data absorbs their mean DM."""
    import numpy as np
    rec = np.asarray(gt.DeltaDM_means)
    err = np.asarray(gt.DeltaDM_errs)
    inj = np.asarray(dDMs)
    rel = (rec - rec.mean()) - (inj - inj.mean())
    gofs = [t.flags["gof"] for t in gt.TOA_list]
    log(f"template build: {name}: {len(gt.TOA_list)} TOAs, DeltaDM "
        f"{rec.tolist()} +- {err.tolist()}, injected {dDMs}, relative "
        f"structure {(rel / err).tolist()} sigma; gof max {max(gofs):.4f}")
    if len(gt.TOA_list) != ntoa:
        raise AssertionError(f"{name}: {len(gt.TOA_list)} TOAs, expected "
                             f"{ntoa}")
    if np.any(np.abs(rel) > 5 * err):
        raise AssertionError(f"{name}: relative dDM structure not within 5 "
                             "sigma of the injection")
    if max(gofs) >= 2.0:
        raise AssertionError(f"{name}: a TOA with gof {max(gofs)} >= 2")
    return dict(toas=len(gt.TOA_list), rel_dDM_sigma=(rel / err).tolist(),
                max_gof=max(gofs))


TB_OFFSETS, TB_DDMS = (0.1, -0.15), (3e-4, -5e-3)   # [rot], [pc cm^-3]


def check_align_fits(fits, dDMs, offsets, name):
    """align's fit of each tscrunched archive against the noiseless
    template: its DM the injected dDM, and its phase, moved to 1500 MHz
    with the header DM (30) it was rotated by first, the injected
    offset, each within 5 of its errors.  Returns the z values."""
    from pulseportraiture_tpu_torch.config import DCONST
    z = []
    for f, dDM, off in zip(fits, dDMs, offsets):
        b = DCONST / P * (1500.0 ** -2 - f["nu_fit"] ** -2)
        phi = f["phi"] + (30.0 + f["DM"]) * b
        err = math.hypot(f["phi_err"], abs(b) * f["DM_err"])
        z.append(dict(phi=((phi - off + 0.5) % 1.0 - 0.5) / err,
                      DM=(f["DM"] - dDM) / f["DM_err"]))
    log(f"template build: {name}: align's fits against the injection "
        f"(offsets {list(offsets)} rot, dDMs {list(dDMs)}): z {z}")
    if len(fits) != len(dDMs) or \
            max(abs(v) for d in z for v in d.values()) > 5:
        raise AssertionError(f"{name}: align did not recover each "
                             f"archive's phase offset and dDM: {z}")
    return z


def build_templates(files, init, device, tag, aligned=None):
    """align (what ppalign -d files -I init -T --niter 1 runs) ->
    (ppspline, ppgauss) -> get_TOAs with each template, on device
    (float32 fits on the card, float64 on the CPU); the launch counts of
    each builder path (reset just before, read just after), its walls,
    align's fits and what the comparisons need.  aligned: an aligned
    portrait to build from instead of aligning."""
    import torch

    from pulseportraiture_tpu_torch.io.psrfits import read_psrfits
    from pulseportraiture_tpu_torch.pipelines.align import align_archives
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    from pulseportraiture_tpu_torch.portrait import DataPortrait

    spl = os.path.join(WORK, f"{tag}.spl")
    gmodel = os.path.join(WORK, f"{tag}.gmodel")
    launches, walls, fits = {}, {}, None
    if aligned is None:
        aligned = os.path.join(WORK, f"{tag}_aligned.fits")
        reset_launches()
        t0 = time.perf_counter()
        _, fits = align_archives(datafiles=files, initial_guess=init,
                                 tscrunch=True, outfile=aligned, niter=1,
                                 quiet=True, device=device, return_fits=True)
        walls["align_s"] = time.perf_counter() - t0
        launches["align"] = read_launches()

    reset_launches()
    t0 = time.perf_counter()
    dp = DataPortrait(aligned, quiet=True, device=device)
    dp.normalize_portrait("prof")
    dp.make_spline_model(max_ncomp=10, smooth=True, quiet=True)
    dp.write_model(spl, quiet=True)
    walls["ppspline_s"] = time.perf_counter() - t0
    launches["ppspline"] = read_launches()
    walls["ppspline_parts"] = dict(dp.timing)

    reset_launches()
    t0 = time.perf_counter()
    dg = DataPortrait(aligned, quiet=True, device=device)
    res = dg.make_gaussian_model(ngauss=2, niter=1, outfile=gmodel,
                                 quiet=True)
    walls["ppgauss_s"] = time.perf_counter() - t0
    launches["ppgauss"] = read_launches()
    walls["ppgauss_parts"] = dict(dg.timing)
    # a rejected step costs one residual evaluation, an accepted one a
    # Jacobian: the LM's wall over its Jacobians
    walls["lm_ms_per_jacobian"] = \
        1e3 * dg.timing["lm_s"] / max(dg.timing["lm_jacobians"], 1)

    dtype = torch.float32 if device == "cuda" else torch.float64
    toas = {}
    for name, tmpl in (("spl", spl), ("gmodel", gmodel)):
        gt = GetTOAs(files, tmpl, device=device, dtype=dtype, quiet=True)
        t0 = time.perf_counter()
        gt.get_TOAs(quiet=True)
        walls[f"get_TOAs_{name}_s"] = time.perf_counter() - t0
        toas[name] = gt
    return dict(launches=launches, walls=walls, fits=fits,
                aligned_file=aligned,
                aligned=read_psrfits(aligned).data[0, 0], spline=dp,
                gauss=dg, gauss_res=res, toas=toas)


def spline_diff(a, b, sigma):
    """Largest differences of two spline builds (a against b): their
    knots [MHz], their coefficients with each eigenprofile's sign taken
    from b's (eigh's signs are the solver's), and their model portraits,
    the last two in units of sigma.  None where the knots differ in
    number."""
    import numpy as np
    ta, ca, _ = a.tck
    tb, cb, _ = b.tck
    if len(ta) != len(tb) or np.shape(ca) != np.shape(cb):
        return None
    ea = a.smooth_eigvec[:, a.ieig]
    eb = b.smooth_eigvec[:, b.ieig]
    sign = np.sign(np.sum(ea * eb, axis=0))[:, None]
    return dict(knots_MHz=float(np.max(np.abs(np.asarray(ta) -
                                              np.asarray(tb)))),
                coefs_sigma=float(np.max(np.abs(sign * np.asarray(ca) -
                                                np.asarray(cb))) / sigma),
                model_sigma=float(np.max(np.abs(a.model - b.model)) /
                                  sigma))


def phase_template_build(seed=7):
    """The template-building workflow: first at 512 x 2048 (a profile
    that evolves across the band) the chain on the card against the
    float64 CPU port, which is also the builders' first use in the
    process; then, warm, at 4096 x 2048 on the card: align of two int16
    archives x 8 coherent subints (write_archives, jitter 0, each archive
    with its own phase offset and dDM), ppspline and ppgauss on the
    aligned portrait, get_TOAs with each template.  Returns the launch
    counts of the three builder paths (at 4096) and the figures."""
    import numpy as np

    from pulseportraiture_tpu_torch.ops.noise import get_noise_PS

    rec = {}
    files5, dDMs5, init5, _ = write_archives(
        np.random.default_rng(seed + 1), tag="tb512", nchan=512,
        jitter=0.0, dDMs=TB_DDMS, offsets=TB_OFFSETS, index2=0.5)
    card = build_templates(files5, init5, "cuda", "tb512c")
    t0 = time.perf_counter()
    cpu = build_templates(files5, init5, "cpu", "tb512h")
    cpu_s = time.perf_counter() - t0
    same = build_templates(files5, init5, "cuda", "tb512s",
                           aligned=cpu["aligned_file"])
    for name, r in (("512 card", card), ("512 CPU", cpu)):
        check_align_fits(r["fits"], dDMs5, TB_OFFSETS, name)

    def param_z(a, b):
        e = np.asarray(b["gauss_res"].fit_errs)
        d = np.abs(a["gauss_res"].fitted_params -
                   b["gauss_res"].fitted_params)
        return float(np.max(d[e > 0] / e[e > 0]))

    dz_chain, dz_same = param_z(card, cpu), param_z(same, cpu)
    ieigs = [r["spline"].ieig.tolist() for r in (card, same, cpu)]
    sig_al = np.median(get_noise_PS(cpu["aligned"], chans=True))
    sig_sp = np.median(cpu["spline"].noise_stds[0, 0])
    sig_g = np.median(cpu["gauss"].noise_stds[0, 0])
    d_al = float(np.max(np.abs(card["aligned"] - cpu["aligned"])) / sig_al)
    d_sp = {name: spline_diff(r["spline"], cpu["spline"], sig_sp)
            for name, r in (("chain", card), ("same", same))}
    d_g = float(np.max(np.abs(card["gauss"].model - cpu["gauss"].model)) /
                sig_g)
    zt = {name: toa_sigmas(card["toas"][name].TOA_list,
                           cpu["toas"][name].TOA_list)[:2]
          for name in ("spl", "gmodel")}
    log(f"template build 512: card vs float64 CPU ({cpu_s:.1f} s on the "
        f"CPU): Gaussian parameters {dz_chain:.3e} of their errors through "
        f"the whole chain, {dz_same:.3e} built from one aligned portrait; "
        f"ieig (chain, same input, CPU) {ieigs}; max |d aligned| "
        f"{d_al:.3e} sigma; spline (knots MHz, coefficients and model in "
        f"sigma) {d_sp}; |d Gaussian model| {d_g:.3e} sigma; TOAs, DMs "
        f"(sigma) {zt}")
    log(f"template build 512: card walls, first use {json.dumps(card['walls'])}"
        f"; again on the CPU's aligned portrait {json.dumps(same['walls'])}")
    # limits: Gaussian parameters 0.01 of their errors, TOAs and DMs 0.01
    # sigma (PERF.md section 2); the same eigenprofiles, and knots within
    # 1e-6 MHz; the aligned portrait, the spline coefficients and both
    # models within 1e-3 of the noise sigma
    bad = [what for what, ok in (
        ("Gaussian parameters", max(dz_chain, dz_same) <= 1e-2),
        ("ieig", len(ieigs[2]) >= 1 and ieigs[0] == ieigs[2] == ieigs[1]),
        ("spline knots and coefficients", all(
            v is not None and v["knots_MHz"] <= 1e-6 and
            max(v["coefs_sigma"], v["model_sigma"]) <= 1e-3
            for v in d_sp.values())),
        ("aligned portrait", d_al <= 1e-3), ("Gaussian model", d_g <= 1e-3),
        ("TOAs and DMs", max(max(v) for v in zt.values()) <= 1e-2)) if not ok]
    if bad:
        raise AssertionError(f"template build 512: the card and the float64 "
                             f"CPU port disagree: {bad}")
    rec["vs_f64_512"] = dict(gauss_params_over_err_chain=dz_chain,
                             gauss_params_over_err=dz_same, ieig=ieigs[2],
                             aligned_sigma=d_al, spline=d_sp,
                             gauss_model_sigma=d_g, toa_dm_sigma=zt,
                             cpu_s=cpu_s, walls_first_use=card["walls"],
                             walls_again=same["walls"])

    t0 = time.perf_counter()
    files, dDMs, init, _ = write_archives(
        np.random.default_rng(seed), tag="tb", jitter=0.0, dDMs=TB_DDMS,
        offsets=TB_OFFSETS)
    log(f"template build: wrote 2 x 8 x {NCHAN} x {NBIN} int16 archives in "
        f"{time.perf_counter() - t0:.2f} s")
    full = build_templates(files, init, "cuda", "tb")
    dp, dg, res = full["spline"], full["gauss"], full["gauss_res"]
    log(f"template build: walls (builders warm) {json.dumps(full['walls'])};"
        f" spline ieig {dp.ieig.tolist()}; launches {full['launches']}")
    rec.update(walls=full["walls"], ieig=dp.ieig.tolist(),
               align_z=check_align_fits(full["fits"], dDMs, TB_OFFSETS,
                                        "4096 card"))
    for name in ("spl", "gmodel"):
        rec[f"toas_{name}"] = check_template_toas(
            full["toas"][name], dDMs, f"get_TOAs with the .{name}", 16)
    got, z = gauss_truth_z(np.asarray(res.fitted_params),
                           np.asarray(res.fit_errs))
    log(f"template build: .gmodel vs bench_template (value, error): {got}; "
        f"z {z}; red_chi2 {res.red_chi2:.4f}")
    if max(abs(v) for v in z.values()) > 5:
        raise AssertionError(f"template build: a Gaussian parameter is not "
                             f"within 5 sigma of the truth: {z}")
    rec["gauss_truth_z"] = z
    for path in ("align", "ppgauss"):
        c = full["launches"][path]
        if min(c["fused_setup"], c["phase_moments"],
               c["phase_moments_merged"]) <= 0:
            raise AssertionError(f"a kernel did not launch on the {path} "
                                 f"path: {c}")
    return full["launches"], rec


def epilogue_entry(paths, nrec):
    """fused_setup's second route in the kernels line: the "rfft" route,
    torch.fft.rfft + csrc/setup_epilogue.cu, with the launches the main
    paths made on it and its records at NOPLAN_NBINS (the headline: 1000
    bins, full band, float32 rows).  It replaces no TPU kernel (the JAX
    package sets these widths up with stats.make_setup on XLA's
    transform); `replaces` names that function."""
    head = nrec["1000_full_band_f32"]
    by_path = {p: c["fused_setup_routes"]["rfft"] for p, c in paths.items()}
    return dict(
        name="setup_epilogue", route="cuda",
        source="pulseportraiture_tpu_torch/csrc/setup_epilogue.cu",
        replaces="pulseportraiture_tpu/fitters/stats.py:120",
        taken_when="nbin is none of 64, 128, 8192 and 256 q, q = 1..16",
        launches=sum(by_path.values()), launches_by_path=by_path,
        max_abs_err=head["max_abs_err"], ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        epilogue_ms=head["epilogue_ms"],
        route_bound_ms=head["route_bound_ms"], widths=nrec)


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from pulseportraiture_tpu_torch import _build

    dev = torch.device("cuda")
    log(card_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    _build.load_kernels()
    log(f"kernel build: {_build.build_info['seconds']:.2f} s (cached: "
        f"{_build.build_info['cached']})")
    entry = ""
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())
        if "spill" in line and ("setup_fft_kernel" in entry or
                                "setup_epilogue_kernel" in entry or
                                "scat_moments_kernel" in entry) and \
                "0 bytes spill stores, 0 bytes spill loads" not in line:
            raise AssertionError(f"a kernel spills: {entry.strip()}: "
                                 f"{line.strip()}")
    walls, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """The wall since the last lap (or the kernel build), as name's."""
        now = time.perf_counter()
        walls[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"phase wall {name}: {walls[name]:.2f} s")

    rng = np.random.default_rng(0)
    krec = phase_kernels(dev, rng)
    lap("kernels_2048")
    xrec = setup_mixed_radix(dev)
    lap("setup_mixed_radix")
    prec = setup_pow2(dev)
    lap("setup_pow2")
    nrec = setup_no_plan(dev)
    lap("setup_no_plan")
    srec = phase_scat_kernel(dev)
    lap("scat_kernel")
    mrec = phase_merged_kernel(dev)
    lap("merged_kernel")
    trec = phase_tr_solve(dev)
    lap("tr_solve")
    lrec = phase_load_stats(dev)
    lap("load_stats")
    wrec = phase_kernels_wide(dev)
    lap("kernels_nh8193")
    fits = phase_fit(dev)
    lap("fit_2048")
    fits_1536 = phase_fit(dev, 1536)
    lap("fit_1536")
    # the widest width (full band only: no band cap) and the narrowest;
    # at 8192 the float64 CPU twin on 2 items keeps it under ~30 s
    fits_8192 = phase_fit(dev, 8192, nc=2)
    lap("fit_8192")
    fits_64 = phase_fit(dev, 64)
    lap("fit_64")
    # past 8192 bins (B=8, full band; the float64 CPU twin on one item
    # keeps it near the 8192-bin phase's time) and at a width without an
    # FFT plan inside 64..8192
    fits_16384 = phase_fit(dev, 16384, nc=1, B=8)
    lap("fit_16384")
    fits_4608 = phase_fit(dev, 4608, nc=4)
    lap("fit_4608")
    scat_fits = phase_scat_fit(dev)
    lap("scat_fit")
    gm_fits = phase_gm_fit(dev)
    lap("gm_fit")
    try:
        os.makedirs(WORK, exist_ok=True)
        prof = phase_profiling(dev)
        lap("profiling")
        paths, unsharded = {}, {}
        paths["pipeline"], pipe_arch, unsharded["pipeline"], _ = \
            phase_pipeline(rng)
        lap("pipeline")
        # one archive at a width that is not a power of two and one at
        # the widest (generators of their own: the other phases' draws
        # stay what they were)
        paths["pipeline_1536"], _, _, _ = phase_pipeline(
            np.random.default_rng(1536), nbin=1536, narch=1)
        lap("pipeline_1536")
        paths["pipeline_8192"], _, _, pipeline_8192 = phase_pipeline(
            np.random.default_rng(8192), nbin=8192, narch=1)
        lap("pipeline_8192")
        wide_paths, pipelines_16384 = phase_pipeline_wide(
            np.random.default_rng(16384))
        paths.update(wide_paths)
        lap("pipelines_16384")
        paths["pipeline_fit_scat"], scat_arch, \
            unsharded["pipeline_fit_scat"] = phase_pipeline_scat(rng)
        lap("pipeline_fit_scat")
        paths["pipeline_gm"], paths["pipeline_gm_fit_scat"], pipeline_gm, \
            unsharded["pipeline_gm"] = phase_pipeline_gm(pipe_arch, scat_arch)
        lap("pipeline_gm")
        mesh_paths, mesh = phase_mesh(pipe_arch, scat_arch, unsharded)
        paths.update(mesh_paths)
        lap("mesh")
        paths["zap"], zap_rec = phase_zap()
        lap("zap")
        t0 = time.perf_counter()
        nb_files, nb_dDMs, tmpl, injected = write_archives(rng, nsub=4,
                                                           tag="nb")
        log(f"narrowband: wrote 2 x 4 x {NCHAN} x {NBIN} int16 archives in "
            f"{time.perf_counter() - t0:.2f} s")
        paths["narrowband"], narrowband = phase_narrowband(nb_files, tmpl,
                                                           injected)
        lap("narrowband")
        sc_files, sc_tmpl, paths["narrowband_fit_scat"], narrowband_scat = \
            phase_narrowband_scat(rng)
        lap("narrowband_fit_scat")
        paths["psrchive"], psrchive = phase_psrchive(sc_files, sc_tmpl)
        lap("psrchive")
        paths["pipeline_gmodel"] = phase_pipeline_gmodel(nb_files, nb_dDMs)
        lap("pipeline_gmodel")
        tb_paths, template_build = phase_template_build()
        lap("template_build")
        paths.update(tb_paths)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # every path's setup launches are all on the route setup_route names
    # for its width (2048 bins unless the path says otherwise)
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    for path, c in paths.items():
        route = sdft.setup_route(c["nbin"])
        if c["fused_setup_routes"][route] != c["fused_setup"]:
            raise AssertionError(f"{path}: fused_setup launched "
                                 f"{c['fused_setup']} times, the {route} "
                                 f"route {c['fused_setup_routes']}")

    def entry(name, source, replaces, also, rec, extra):
        by_path = {p: c[name] for p, c in paths.items()}
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            also_replaces=also, launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec.get("library_ms"), **extra)

    tpu = "pulseportraiture_tpu/ops/"
    summary = {"kernels": [
        entry("fused_setup", "pulseportraiture_tpu_torch/csrc/setup_fft.cu",
              tpu + "ct_dft.py:430", [tpu + "ct_dft.py:804"],
              krec["capped"],
              dict({name: krec[name] for name in (
                  "full_band", "i16", "one_item_capped",
                  "one_item_full_band")},
                   routes_by_path={p: c["fused_setup_routes"]
                                   for p, c in paths.items()},
                   mixed_radix=xrec, pow2_widths=prec,
                   second_route=epilogue_entry(paths, nrec))),
        entry("phase_moments", "pulseportraiture_tpu_torch/csrc/moments.cu",
              tpu + "pallas_moments.py:323",
              [tpu + "pallas_moments.py:262", tpu + "pallas_moments.py:186"],
              krec["moments_capped"],
              {"full_band": krec["moments_full_band"]}),
        entry("scattering_moments",
              "pulseportraiture_tpu_torch/csrc/scat_moments.cu",
              tpu + "pallas_moments.py:805",
              [tpu + "pallas_moments.py:748", tpu + "pallas_moments.py:635"],
              srec["capped"],
              {name: srec[name] for name in (
                  "full_band", "per_item_capped", "per_item_full_band")}),
        entry("phase_moments_merged",
              "pulseportraiture_tpu_torch/csrc/moments_merged.cu",
              "scripts/tpu_moments_layout.py:138", [], mrec["subint"],
              {"probe": mrec["probe"]}),
        entry("tr_solve", "pulseportraiture_tpu_torch/csrc/tr_solve.cu",
              None, [], trec["float32"], {"float64": trec["float64"]}),
        entry("profile_stats",
              "pulseportraiture_tpu_torch/csrc/load_stats.cu", None, [],
              lrec[2048], {"nbin_1536": lrec[1536]})],
        "fits": fits, "fits_1536": fits_1536, "fits_8192": fits_8192,
        "fits_64": fits_64, "fits_16384": fits_16384,
        "fits_4608": fits_4608, "pow2_widths": prec,
        "no_plan_widths": nrec, "phase_kernels_nh8193": wrec,
        "pipeline_8192": pipeline_8192, "pipelines_16384": pipelines_16384,
        "scattering_fits": scat_fits,
        "gm_fits": gm_fits,
        "pipeline_gm": pipeline_gm, "zap": zap_rec,
        "narrowband": narrowband, "narrowband_fit_scat": narrowband_scat,
        "psrchive": psrchive, "template_build": template_build,
        "mesh": mesh, "profiling": prof, "phase_walls_s": walls}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
