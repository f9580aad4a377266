"""Per-channel phase moments of the Newton loop: CUDA kernel + plain twin.

For each (item, channel) row of the cross-spectrum G = Gr + i Gi under
the phase ramp e^{2 pi i phi k}:

    C   =          sum_k Re(G_k e^{2 pi i phi k})
    Cp  = -2 pi    sum_k k   Im(G_k e^{2 pi i phi k})
    Cpp = -4 pi^2  sum_k k^2 Re(G_k e^{2 pi i phi k})

Kernel note (csrc/moments.cu, `pp_phase_moments`):
  * Replaces the Pallas TPU kernels of pulseportraiture_tpu/ops/
    pallas_moments.py: `_phase_moments_impl`/`_phase_kernel` (natural
    order), `_phase_moments_kvec_impl`/`_phase_kernel_kvec` and
    `_phase_moments_ct_impl`/`_make_phase_kernel_ct` (the permuted TPU
    layouts, which natural order makes unnecessary).
  * Bound on the H100: the bytes of Gr/Gi (8 per harmonic, read once per
    Newton iteration) plus one precise sincosf per harmonic.
  * Design: one warp per row strides over the harmonics (coalesced
    reads of Gr and Gi, each read exactly once), evaluates the
    double-single phasor of fitters.stats._phase_trig per element with
    rounded (non-contracted) f32 steps, accumulates the three sums in
    f32 and reduces across the warp.  The plain torch form materializes
    about six (B, nchan, nharm) temporaries per call; the kernel none.
"""

from __future__ import annotations

import ctypes

import torch

from pulseportraiture_tpu_torch.fitters.stats import TWO_PI, _phase_trig

# hi*k stays exact in f32 while |round(8192 p)| * k <= 2^24, i.e. k <= 4096
MAX_NHARM = 4097


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

    for name, t in (("phis", phis), ("Gr", Gr), ("Gi", Gi)):
        if t.device != Gr.device:
            raise ValueError(f"phase_moments: {name} is on {t.device}, "
                             f"Gr on {Gr.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"phase_moments kernel takes float32; {name} "
                            f"is {t.dtype}")
    if Gi.shape != Gr.shape or phis.shape != Gr.shape[:-1]:
        raise ValueError(f"phase_moments: shapes phis {tuple(phis.shape)}, "
                         f"Gr {tuple(Gr.shape)}, Gi {tuple(Gi.shape)}")
    nharm = Gr.shape[-1]
    if not 0 < nharm <= MAX_NHARM:
        raise ValueError(f"phase_moments kernel: nharm={nharm} outside "
                         f"1..{MAX_NHARM} (double-single exactness bound)")
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
