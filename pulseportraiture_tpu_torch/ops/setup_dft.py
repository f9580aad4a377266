"""Fused fit setup (DFT + cross-spectrum + data power + seed sums).

fused_setup(x, mr, mi) builds, per item b and channel c, over the first
nh = mr.shape[-1] harmonics (natural order):

    X = rfft(x)[..., :nh] (x dequantized by `scale` after the DFT)
    Gr + i Gi = X conj(M),  harmonic 0 zeroed unless f0_fact
    sd = sum_{k >= 1} |X_k|^2 over ALL harmonics (+ |X_0|^2 with f0_fact)
    gs[b, kk] = sum_c w[b, c, kk] G[b, c]    (with stacked seed weights)

Kernel note (csrc/setup.cu, `pp_fused_setup`):
  * Replaces the Pallas TPU kernels pulseportraiture_tpu/ops/ct_dft.py
    `pallas_direct_setup` (`_direct_kernel_factory`, the capped route)
    and `ct_setup` (`_ct_setup_kernel_factory`, the full band): with
    natural-order harmonics the capped set is a prefix, so one kernel
    serves both with nh = NQ*M' or nbin/2 + 1.
  * Bound on the H100: FP32 FMA throughput of the DFT (4 nbin nh flops
    per channel); the data are read once.
  * Design: a tiled FP32-FMA SGEMM against a host f64 -> f32 trig slab
    that stays L2-resident (2 MB capped, 17 MB full band at nbin 2048),
    with the cross-spectrum, Parseval data power and seed partial sums
    fused into the epilogue; the seed sums reduce over channel tiles in
    a second, fixed-order pass (no float atomics).

Host helpers band_cap_model_ft / suggest_mharm keep the JAX package's
cap rule (NH = NQ*M', M' a multiple of 8), so both packages keep the
same harmonics.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_LANES = 128
_BN = 64          # slab columns per kernel block (csrc/setup.cu BN)


def cap_supported(nbin: int) -> bool:
    """The band cap applies when nbin = NQ*128 with NQ even in [2, 32]
    (the JAX package's ct_supported: keeps the same cap set)."""
    NQ = nbin // _LANES
    return nbin % _LANES == 0 and 2 <= NQ <= 32 and NQ % 2 == 0


def cap_nharm(nbin: int, mharm: int) -> int:
    """Stored harmonics NH = NQ*M' of the cap M' (harmonics k < NH)."""
    return (nbin // _LANES) * int(mharm)


def suggest_mharm(mr, mi, nbin):
    """Smallest cap M' (a multiple of 8) with every harmonic k >= NQ*M'
    identically zero in f32 across all channels, or None when capping
    does not apply (port of ct_dft.suggest_mharm)."""
    if not cap_supported(nbin):
        return None
    NQ = nbin // _LANES
    M0 = nbin // 2 // NQ
    a = (np.abs(np.asarray(mr, np.float32)) +
         np.abs(np.asarray(mi, np.float32)))
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    nz = np.nonzero(a)[0]
    if len(nz) == 0:
        return None
    k_last = int(nz[-1])
    mh = -(-(k_last + 1) // NQ)
    mh += (-mh) % 8
    if mh >= M0:
        return None
    return mh


def band_cap_model_ft(mr, mi, nbin, rel_floor=1e-6, f0_fact=None):
    """Clean + cap a host natural-order split-real model spectrum:
    returns (mr2, mi2, mharm) as f32 numpy (port of
    ct_dft.band_cap_model_ft).  Harmonics whose amplitude across every
    channel is below rel_floor * max are zeroed; DC is zeroed unless
    f0_fact (default config.F0_FACT)."""
    if f0_fact is None:
        from pulseportraiture_tpu_torch.config import F0_FACT
        f0_fact = F0_FACT
    mr = np.asarray(mr, np.float32).copy()
    mi = np.asarray(mi, np.float32).copy()
    if not f0_fact:
        mr[..., 0] = 0.0
        mi[..., 0] = 0.0
    a = np.abs(mr) + np.abs(mi)
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    dead = a < rel_floor * a.max()
    mr[..., dead] = 0.0
    mi[..., dead] = 0.0
    return mr, mi, suggest_mharm(mr, mi, nbin)


def fused_setup_reference(x, mr, mi, f0_fact=False, w=None, scale=None):
    """Plain torch twin of the setup kernel, in mr's dtype (rfft based)."""
    dt = mr.dtype
    nh = mr.shape[-1]
    X = torch.fft.rfft(x.to(dt), dim=-1)
    if scale is not None:
        X = X * scale.to(dt)[..., None]
    Xr, Xi = X.real, X.imag
    pw = Xr * Xr + Xi * Xi
    sd = torch.sum(pw[..., 1:], dim=-1)
    if f0_fact:
        sd = sd + pw[..., 0]
    Xr, Xi = Xr[..., :nh], Xi[..., :nh]
    Gr = Xr * mr + Xi * mi
    Gi = Xi * mr - Xr * mi
    if not f0_fact:
        Gr[..., 0] = 0.0
        Gi[..., 0] = 0.0
    if w is None:
        return Gr, Gi, sd
    w = w.to(dt)
    gsr = torch.einsum("bcs,bck->bsk", w, Gr)
    gsi = torch.einsum("bcs,bck->bsk", w, Gi)
    return Gr, Gi, sd, gsr, gsi


def fused_setup(x, mr, mi, f0_fact=False, w=None, scale=None):
    """(Gr, Gi, sd[, gsr, gsi]) for data x (B, nchan, nbin) against the
    shared model spectrum mr/mi (nchan, nh).

    scale: (B, nchan) dequantization for int16 x (requires f0_fact
    falsy: per-channel offsets only feed the dropped DC harmonic).
    w: stacked seed weights (B, nchan, K); gsr/gsi are (B, K, nh).
    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise).
    """
    if scale is not None and f0_fact:
        raise ValueError("int16 ingest drops per-channel offsets into the "
                         "DC harmonic; it requires F0_FACT zeroing")
    if x.device.type == "cpu":
        return fused_setup_reference(x, mr, mi, f0_fact, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_setup: unsupported device {x.device}")
    return _launch(x, mr, mi, bool(f0_fact), w, scale)


fused_setup.launches = 0


@functools.lru_cache(maxsize=8)
def _trig_slab_np(nbin: int, nh: int):
    """(nbin, ncolp) f32 slab, columns 2k = cos(2 pi j k/nbin) and
    2k+1 = sin(...) for k < nh, zero-padded to a multiple of 64 columns.
    Built in f64 with j*k reduced mod nbin exactly, then cast."""
    ncolp = -(-2 * nh // _BN) * _BN
    j = np.arange(nbin, dtype=np.int64)[:, None]
    k = np.arange(nh, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((j * k) % nbin).astype(np.float64) / nbin
    E = np.zeros((nbin, ncolp), np.float64)
    E[:, 0:2 * nh:2] = np.cos(ang)
    E[:, 1:2 * nh:2] = np.sin(ang)
    return E.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _trig_slab(nbin: int, nh: int, device: str):
    return torch.from_numpy(_trig_slab_np(nbin, nh)).to(device)


def _launch(x, mr, mi, f0_fact, w, scale):
    from pulseportraiture_tpu_torch._build import load_kernels

    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"fused_setup: x must be (B, nchan, nbin), got "
                         f"{tuple(x.shape)}")
    B, nchan, nbin = x.shape
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"fused_setup kernel takes float32 or int16 data, "
                        f"got {x.dtype}")
    if (x.dtype == torch.int16) != (scale is not None):
        raise ValueError("fused_setup: int16 data need a scale, and only "
                         "int16 data take one")
    if mr.dim() != 2 or mr.shape[0] != nchan or mi.shape != mr.shape:
        raise ValueError(f"fused_setup: model spectrum must be (nchan, nh); "
                         f"got {tuple(mr.shape)}, {tuple(mi.shape)}")
    nh = mr.shape[-1]
    if not 0 < nh <= nbin // 2 + 1:
        raise ValueError(f"fused_setup: nh={nh} outside 1..nbin/2+1")
    args = [("mr", mr), ("mi", mi)]
    if scale is not None:
        if scale.shape != (B, nchan):
            raise ValueError(f"fused_setup: scale must be (B, nchan), got "
                             f"{tuple(scale.shape)}")
        args.append(("scale", scale))
    kseed = 0
    if w is not None:
        if w.dim() != 3 or w.shape[:2] != (B, nchan):
            raise ValueError(f"fused_setup: w must be (B, nchan, K), got "
                             f"{tuple(w.shape)}")
        kseed = w.shape[-1]
        args.append(("w", w))
    for name, t in args:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"fused_setup kernel: {name} must be float32 on "
                            f"{dev}, got {t.dtype} on {t.device}")
    for name, t in [("x", x)] + args:
        if not t.is_contiguous():
            raise ValueError(f"fused_setup kernel: {name} must be "
                             "contiguous")
    slab = _trig_slab(nbin, nh, str(dev))
    ncolp = slab.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    Gr = torch.empty((B, nchan, nh), **f32)
    Gi = torch.empty((B, nchan, nh), **f32)
    sd = torch.empty((B, nchan), **f32)
    part = gsr = gsi = None
    if kseed:
        ntile = -(-nchan // 64)
        part = torch.empty((B, ntile, kseed, ncolp), **f32)
        gsr = torch.empty((B, kseed, nh), **f32)
        gsi = torch.empty((B, kseed, nh), **f32)
    if B * nchan:
        lib = load_kernels()

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())

        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pp_fused_setup(
            ptr(x), ctypes.c_int(int(x.dtype == torch.int16)), ptr(slab),
            ctypes.c_int(ncolp), ptr(mr), ptr(mi), ptr(scale), ptr(w),
            ctypes.c_int(kseed), ptr(Gr), ptr(Gi), ptr(sd), ptr(part),
            ptr(gsr), ptr(gsi), ctypes.c_int(B), ctypes.c_int(nchan),
            ctypes.c_int(nbin), ctypes.c_int(nh), ctypes.c_int(int(f0_fact)),
            ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"pp_fused_setup launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        fused_setup.launches += 1
    if kseed:
        return Gr, Gi, sd, gsr, gsi
    return Gr, Gi, sd
