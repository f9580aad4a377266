"""Per-channel harmonic moments of the Newton loop: CUDA kernels + twins.

Phase moments, for each (item, channel) row of the cross-spectrum
G = Gr + i Gi under the phase ramp P_k = e^{2 pi i phi k}:

    C   =          sum_k Re(G_k P_k)
    Cp  = -2 pi    sum_k k   Im(G_k P_k)
    Cpp = -4 pi^2  sum_k k^2 Re(G_k P_k)

Scattering moments add the scattering FT B_k = 1/(1 + 2 pi i k tau) of
the row's tau, its tau derivatives f = -2 pi i k B^2 and g2 = -8 pi^2 k^2
B^3, and the template power M2 (shared by every item of a batch): the
9 reductions C, S, Cp, Rf, S1, Cpp, If1, Rg, S2 of
pulseportraiture_tpu/ops/pallas_moments.py `_scat_terms_ref`.

Kernel notes:
  * csrc/moments.cu `pp_phase_moments` replaces the Pallas kernels
    `_phase_moments_impl`/`_phase_kernel` (natural order),
    `_phase_moments_kvec_impl` and `_phase_moments_ct_impl` (the permuted
    TPU layouts, which natural order makes unnecessary).
  * csrc/scat_moments.cu `pp_scat_moments` replaces
    `_scattering_moments_impl`, `_scattering_moments_kvec_impl` and
    `_scattering_moments_ct_impl` the same way.
  * csrc/moments_merged.cu `pp_phase_moments_merged` replaces the merged
    single-stream kernel of scripts/tpu_moments_layout.py
    (`make_merged_kernel`): the phase moments read from one buffer
    g = [Gr | Gi] of shape (rows, 2 nharm).  The narrowband fits build
    their cross-spectrum once in that layout and launch it once per
    Newton step; with nharm a multiple of 4 each half is read by 128-bit
    loads.
  * All three: one warp per row strides over the harmonics (coalesced reads,
    each element of Gr/Gi read once; M2 rows come from L2 across items),
    the double-single phasor of fitters.stats._phase_trig per element
    (csrc/phase_trig.cuh, rounded non-contracted f32 steps, precise
    sincosf), f32 accumulators and one warp-shuffle reduction.  The plain
    torch forms materialize (B, nchan, nharm) temporaries; the kernels
    none.
  * Bound on the H100: the 8 bytes of Gr/Gi per harmonic (the scattering
    kernel adds one IEEE division per harmonic).  The merged kernel at
    one narrowband subint (4096 rows, 1025 harmonics: 34 MB) is
    launch-latency sized.
"""

from __future__ import annotations

import ctypes

import torch

from pulseportraiture_tpu_torch.fitters.stats import TWO_PI, _phase_trig

# hi*k stays exact in f32 while |round(8192 p)| * k <= 2^24, i.e. k <= 4096
MAX_NHARM = 4097
# constant factors of the 9 scattering sums (C, S, Cp, Rf, S1, Cpp, If1,
# Rg, S2)
_SCAT_FACTORS = (1.0, 1.0, -TWO_PI, 1.0, 1.0, -TWO_PI * TWO_PI, -TWO_PI,
                 1.0, 1.0)


def phase_moments_reference(phis, Gr, Gi):
    """Plain torch (C, Cp, Cpp), each (..., nchan), in Gr's dtype."""
    nharm = Gr.shape[-1]
    k = torch.arange(nharm, dtype=Gr.dtype, device=Gr.device)
    c, s = _phase_trig(phis, k)
    zr = Gr * c - Gi * s
    zi = Gr * s + Gi * c
    C = torch.sum(zr, dim=-1)
    Cp = (-TWO_PI) * torch.sum(k * zi, dim=-1)
    Cpp = (-TWO_PI * TWO_PI) * torch.sum(k * k * zr, dim=-1)
    return C, Cp, Cpp


def phase_moments(phis, Gr, Gi):
    """(C, Cp, Cpp), each (..., nchan), from phis (..., nchan) and Gr/Gi
    (..., nchan, nharm).

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if Gr.device.type == "cpu":
        return phase_moments_reference(phis, Gr, Gi)
    if Gr.device.type != "cuda":
        raise ValueError(f"phase_moments: unsupported device {Gr.device}")
    return _launch(phis, Gr, Gi)


phase_moments.launches = 0


def _launch(phis, Gr, Gi):
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("phase_moments", (("phis", phis), ("Gr", Gr), ("Gi", Gi)),
               Gr.device)
    if Gi.shape != Gr.shape or phis.shape != Gr.shape[:-1]:
        raise ValueError(f"phase_moments: shapes phis {tuple(phis.shape)}, "
                         f"Gr {tuple(Gr.shape)}, Gi {tuple(Gi.shape)}")
    nharm = Gr.shape[-1]
    _check_nharm("phase_moments", nharm)
    phis = phis.contiguous()
    if not (Gr.is_contiguous() and Gi.is_contiguous()):
        raise ValueError("phase_moments kernel: Gr/Gi must be contiguous")
    rows = phis.numel()
    out = torch.empty((3,) + tuple(phis.shape), dtype=torch.float32,
                      device=Gr.device)
    if rows:
        lib = load_kernels()
        stream = torch.cuda.current_stream(Gr.device).cuda_stream
        err = lib.pp_phase_moments(
            ctypes.c_void_p(phis.data_ptr()), ctypes.c_void_p(Gr.data_ptr()),
            ctypes.c_void_p(Gi.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(rows), ctypes.c_int(nharm),
            ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pp_phase_moments launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        phase_moments.launches += 1
    return out[0], out[1], out[2]


def phase_moments_merged_reference(phis, g):
    """Plain torch (C, Cp, Cpp), each (...,), from phis (...,) and the
    merged stream g (..., 2 nharm) = [Gr | Gi]: the split twin on the two
    halves."""
    nharm = g.shape[-1] // 2
    return phase_moments_reference(phis, g[..., :nharm], g[..., nharm:])


def phase_moments_merged(phis, g):
    """(C, Cp, Cpp), each (...,), from phis (...,) and one merged stream
    g (..., 2 nharm) with g[..., :nharm] = Gr and g[..., nharm:] = Gi.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if g.shape[-1] % 2:
        raise ValueError(f"phase_moments_merged: g must hold [Gr | Gi], got "
                         f"an odd last axis {g.shape[-1]}")
    if g.device.type == "cpu":
        return phase_moments_merged_reference(phis, g)
    if g.device.type != "cuda":
        raise ValueError(f"phase_moments_merged: unsupported device "
                         f"{g.device}")
    return _launch_merged(phis, g)


phase_moments_merged.launches = 0


def _launch_merged(phis, g):
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("phase_moments_merged", (("phis", phis), ("g", g)), g.device)
    if phis.shape != g.shape[:-1]:
        raise ValueError(f"phase_moments_merged: shapes phis "
                         f"{tuple(phis.shape)}, g {tuple(g.shape)}")
    nharm = g.shape[-1] // 2
    _check_nharm("phase_moments_merged", nharm)
    phis = phis.contiguous()
    if not g.is_contiguous():
        raise ValueError("phase_moments_merged kernel: g must be contiguous")
    rows = phis.numel()
    out = torch.empty((3,) + tuple(phis.shape), dtype=torch.float32,
                      device=g.device)
    if rows:
        lib = load_kernels()
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.pp_phase_moments_merged(
            ctypes.c_void_p(phis.data_ptr()), ctypes.c_void_p(g.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(rows),
            ctypes.c_int(nharm), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pp_phase_moments_merged launch failed: CUDA "
                               f"error {err} "
                               f"({lib.pp_error_string(err).decode()})")
        phase_moments_merged.launches += 1
    return out[0], out[1], out[2]


def scattering_moments_reference(phis, taus, Gr, Gi, M2, absolute=False):
    """Plain torch (C, S, Cp, Rf, S1, Cpp, If1, Rg, S2), each (..., nchan),
    in Gr's dtype; M2 (nchan, nharm) or (..., nchan, nharm).

    absolute=True sums the magnitudes of the summands instead (with the
    constant factors' magnitudes): the scale of each sum's rounding error,
    for tolerances.  Written from pallas_moments._scat_terms_ref.
    """
    nharm = Gr.shape[-1]
    k = torch.arange(nharm, dtype=Gr.dtype, device=Gr.device)
    c, s = _phase_trig(phis, k)
    ct = TWO_PI * k * taus[..., None]
    Bden = 1.0 + ct * ct
    Br = 1.0 / Bden
    Bi = -ct / Bden
    del ct, Bden
    Ar = Gr * Br + Gi * Bi
    Ai = Gi * Br - Gr * Bi
    zr = Ar * c - Ai * s
    zi = Ar * s + Ai * c
    del Ar, Ai
    cb2r = Br * Br - Bi * Bi
    cb2i = -2.0 * Br * Bi
    cfr = TWO_PI * k * (-cb2i)
    cfi = TWO_PI * k * cb2r
    GPr = Gr * c - Gi * s
    GPi = Gr * s + Gi * c
    del c, s
    zfr = GPr * cfr - GPi * cfi
    zfi = GPr * cfi + GPi * cfr
    u1 = 2.0 * (Br * cfr - Bi * cfi)
    cb3r = cb2r * Br + cb2i * Bi
    cb3i = -cb2r * Bi + cb2i * Br
    del cb2r, cb2i
    w2k2 = -(TWO_PI ** 2) * 2.0 * k * k
    cgr = w2k2 * cb3r
    cgi = w2k2 * cb3i
    del cb3r, cb3i
    zgr = GPr * cgr - GPi * cgi
    u2 = 2.0 * ((cfr * cfr + cfi * cfi) + (Br * cgr - Bi * cgi))
    B2 = Br * Br + Bi * Bi
    terms = (zr, B2 * M2, k * zi, zfr, u1 * M2, k * k * zr, k * zfi, zgr,
             u2 * M2)
    if absolute:
        return tuple(abs(f) * torch.sum(torch.abs(t), dim=-1)
                     for f, t in zip(_SCAT_FACTORS, terms))
    return tuple(f * torch.sum(t, dim=-1)
                 for f, t in zip(_SCAT_FACTORS, terms))


def scattering_moments(phis, taus, Gr, Gi, M2):
    """(C, S, Cp, Rf, S1, Cpp, If1, Rg, S2), each (..., nchan), from phis
    and taus (..., nchan), Gr/Gi (..., nchan, nharm) and M2 (nchan, nharm)
    shared by every item, or (..., nchan, nharm).

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if Gr.device.type == "cpu":
        return scattering_moments_reference(phis, taus, Gr, Gi, M2)
    if Gr.device.type != "cuda":
        raise ValueError(f"scattering_moments: unsupported device "
                         f"{Gr.device}")
    return _launch_scat(phis, taus, Gr, Gi, M2)


scattering_moments.launches = 0


def _check_f32(name, ts, dev):
    for tname, t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, Gr on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; {tname} is "
                            f"{t.dtype}")


def _check_nharm(name, nharm):
    if not 0 < nharm <= MAX_NHARM:
        raise ValueError(f"{name} kernel: nharm={nharm} outside "
                         f"1..{MAX_NHARM} (double-single exactness bound)")


def _launch_scat(phis, taus, Gr, Gi, M2):
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("scattering_moments", (("phis", phis), ("taus", taus),
                                      ("Gr", Gr), ("Gi", Gi), ("M2", M2)),
               Gr.device)
    if Gi.shape != Gr.shape or phis.shape != Gr.shape[:-1] or \
            taus.shape != phis.shape or M2.dim() < 2 or \
            Gr.shape[-M2.dim():] != M2.shape:
        raise ValueError(f"scattering_moments: shapes phis "
                         f"{tuple(phis.shape)}, taus {tuple(taus.shape)}, "
                         f"Gr {tuple(Gr.shape)}, Gi {tuple(Gi.shape)}, "
                         f"M2 {tuple(M2.shape)}")
    nharm = Gr.shape[-1]
    _check_nharm("scattering_moments", nharm)
    phis = phis.contiguous()
    taus = taus.contiguous()
    if not (Gr.is_contiguous() and Gi.is_contiguous() and
            M2.is_contiguous()):
        raise ValueError("scattering_moments kernel: Gr/Gi/M2 must be "
                         "contiguous")
    rows = phis.numel()
    m2_rows = M2.numel() // nharm          # row r reads M2 row r % m2_rows
    out = torch.empty((9,) + tuple(phis.shape), dtype=torch.float32,
                      device=Gr.device)
    if rows:
        lib = load_kernels()
        stream = torch.cuda.current_stream(Gr.device).cuda_stream
        err = lib.pp_scat_moments(
            ctypes.c_void_p(phis.data_ptr()), ctypes.c_void_p(taus.data_ptr()),
            ctypes.c_void_p(Gr.data_ptr()), ctypes.c_void_p(Gi.data_ptr()),
            ctypes.c_void_p(M2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_longlong(rows), ctypes.c_longlong(m2_rows),
            ctypes.c_int(nharm), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pp_scat_moments launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        scattering_moments.launches += 1
    return tuple(out[j] for j in range(9))
