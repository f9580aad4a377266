"""Per-profile statistics of an int16 archive at load: CUDA kernel + twin.

For each profile of raw int16 samples and its DAT_SCL (x = scl raw; the
DAT_OFFS moves only the DC harmonic and the baseline by itself): the
windowed-minimum baseline (io/psrfits.Archive.remove_baseline's rule), the
power-spectrum noise (ops/noise.get_noise_PS(chans=True)), and the sum and
maximum of the baseline-removed profile, from which archive_snr gives
get_SNR's S/N against the rms of the archive's positive channel noises.
io/archive.load_data computes the same on the host from the decoded
float32 cube; get_TOAs' float32 fits on the card have it take this route
(stats_device, archive_stats).

Kernel notes: csrc/load_stats.cu `pp_load_stats` replaces no TPU kernel
(the JAX package computes these in numpy on the host).  One block a
profile: the int16 row in shared memory once, its nbin/2-point complex FFT
by csrc/fft_passes.cuh (so the widths are the FFT setup route's), the
noise from the top quarter's harmonics, the baseline's window from exact
int64 window sums of x in units of ulp(scl) (the first minimum, as
exact arithmetic has it, in any order of summation).  Bound: the int16
bytes read once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pulseportraiture_tpu_torch.config import SNR_FUDGE
from pulseportraiture_tpu_torch.io.psrfits import baseline_window
from pulseportraiture_tpu_torch.ops.launches import counted
from pulseportraiture_tpu_torch.ops.launches import stream as _stream
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles
from pulseportraiture_tpu_torch.ops.setup_dft import _fft_tables, setup_route
from pulseportraiture_tpu_torch.profiling import annotate


def takes(nbin: int) -> bool:
    """Whether the kernel takes profiles of nbin samples: the widths with
    a plan in csrc/fft_passes.cuh (the FFT setup route's)."""
    return setup_route(nbin) == "fft"


def stats_device(device, dtype):
    """Where get_TOAs has load_data compute an int16 archive's statistics:
    the card of a float32 fit; None (the host's numpy route) otherwise."""
    device = torch.device(device)
    return device if device.type == "cuda" and dtype == torch.float32 \
        else None


def _window_sums(d, wlen):
    """s_i = sum of d[(i + 1 + m) mod n], m < wlen, along the last axis."""
    n = d.shape[-1]
    c = torch.cumsum(torch.cat([d, d[..., :wlen]], -1), -1)
    return c[..., wlen:] - c[..., :n]


def profile_stats_reference(raw, scale):
    """Plain torch: (baseline, noise, sum, max) float32 (...,) of each
    profile of raw (..., nbin) int16 with scale (...) float32, on raw's
    device.  x = scale raw in float32; the baseline is the mean of the
    window of the first minimum of the smoothed window sums, taken on x in
    units of ulp(scale) as int64 (exact); the noise is noise_PS_profiles of
    x; sum and max are those of x - baseline."""
    nbin = raw.shape[-1]
    wlen = baseline_window(nbin)
    x = raw.float() * scale[..., None]
    a = scale.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
    q = (x.double() / ulp[..., None]).to(torch.int64)
    S = _window_sums(q, wlen)
    i = torch.argmin(_window_sums(S, wlen), -1, keepdim=True)
    base = (torch.take_along_dim(S, i, -1)[..., 0].double() * ulp /
            wlen).float()
    psum = (q.sum(-1).double() * ulp - nbin * base.double()).float()
    return base, noise_PS_profiles(x), psum, x.amax(-1) - base


def profile_stats(raw, scale):
    """(baseline, noise, sum, max) float32 (...,) of each profile of raw
    (..., nbin) int16 with scale (...) float32: CPU tensors take the plain
    twin, CUDA tensors launch csrc/load_stats.cu (or raise; no fallback).
    profile_stats.launches counts the launches."""
    if raw.device.type == "cpu":
        return profile_stats_reference(raw, scale)
    if raw.device.type != "cuda":
        raise ValueError(f"profile_stats: unsupported device {raw.device}")
    from pulseportraiture_tpu_torch._build import load_kernels

    nbin = raw.shape[-1]
    if raw.dtype != torch.int16 or scale.dtype != torch.float32:
        raise TypeError(f"profile_stats kernel takes int16 samples and "
                        f"float32 scales, got {raw.dtype}, {scale.dtype}")
    if scale.device != raw.device or scale.shape != raw.shape[:-1]:
        raise ValueError(f"profile_stats: scale {tuple(scale.shape)} on "
                         f"{scale.device} for samples {tuple(raw.shape)} "
                         f"on {raw.device}")
    if not takes(nbin):
        raise ValueError(f"the load statistics kernel does not take "
                         f"nbin={nbin}")
    if not (raw.is_contiguous() and scale.is_contiguous()):
        raise ValueError("profile_stats kernel: raw and scale must be "
                         "contiguous")
    if raw.data_ptr() % 16:
        raise ValueError("profile_stats kernel: raw must start on a "
                         "16-byte boundary (an offset view does not)")
    nprof = raw.numel() // nbin
    if nprof > 2 ** 31 - 1:
        raise ValueError(f"profile_stats kernel: {nprof} profiles above "
                         "2^31 - 1")
    out = torch.empty((4,) + raw.shape[:-1], dtype=torch.float32,
                      device=raw.device)
    if nprof:
        tw = _fft_tables(nbin, raw.device)
        lib = load_kernels()
        with torch.cuda.device(raw.device):
            err = lib.pp_load_stats(
                ctypes.c_void_p(raw.data_ptr()),
                ctypes.c_void_p(scale.data_ptr()),
                ctypes.c_void_p(tw.data_ptr()), ctypes.c_int(tw.shape[0]),
                ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(nprof),
                ctypes.c_int(nbin), ctypes.c_int(baseline_window(nbin)),
                _stream(raw.device))
        if err != 0:
            raise RuntimeError(f"pp_load_stats launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        counted(profile_stats)
    return tuple(out)


profile_stats.launches = 0


def archive_snr(noise, psum, pmax, fudge=SNR_FUDGE):
    """get_SNR's S/N (float32) of each profile from its baseline-removed
    sum and max, against the rms of the positive noises (in float64,
    rounded to float32), as load_data takes it; on the tensors' device,
    with no host sync."""
    n64 = noise.double()
    pos = n64 > 0
    count = pos.sum()
    rms = torch.where(
        count > 0, torch.sqrt(torch.where(pos, n64 * n64, 0.0).sum() /
                              count.clamp(min=1)), 1.0).float()
    weq = psum / pmax
    bad = weq <= 0
    snr = psum / (rms * torch.sqrt(torch.where(bad, 1.0, weq)))
    return (snr.double() * ~bad / fudge).float()


def archive_stats(raw, scale, device):
    """load_data's statistics of an int16 archive computed on `device`:
    raw (nsub, nchan, nbin) int16 and scale (nsub, nchan) float32 host
    arrays -> (baseline float32, noise_stds float64, SNRs float64) host
    arrays (nsub, nchan).  One copy to the device, one launch, one copy
    back (the only sync); traced as pp:load.stats."""
    with annotate("pp:load.stats"):
        r = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
        s = torch.from_numpy(np.ascontiguousarray(scale,
                                                  dtype=np.float32)).to(device)
        base, noise, psum, pmax = profile_stats(r, s)
        out = torch.stack([base, noise, archive_snr(noise, psum, pmax)])
        out = out.cpu().numpy()
    return out[0], out[1].astype(np.float64), out[2].astype(np.float64)
