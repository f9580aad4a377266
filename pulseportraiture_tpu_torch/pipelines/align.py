"""Iterative multi-epoch alignment and averaging (the ppalign tool).

Port of pulseportraiture_tpu.pipelines.align (reference ppalign.py:21-243):
align_archives fits (phi, DM) of every subint against the current
template with the wideband fitter, rotates it, and accumulates a
weights/sigma^2-weighted average that becomes the next template.  The
PSRCHIVE psradd/psrsmooth shell-outs are average_archives and
psrsmooth_archive.

On the card: the rotations and the accumulation in float64, and the
fits in float32 (fit_phase_shift on csrc/moments_merged.cu,
fit_portrait_full on csrc/setup_fft.cu and csrc/moments.cu), each
(phi, DM) fit then polished to the float64 optimum (polish_phi_dm); on
the CPU everything in float64.  Loading and channel matching are host work.
"""

from __future__ import annotations

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import resolve_device
from pulseportraiture_tpu_torch.io.archive import load_data, unload_new_archive


def average_archives(metafile_or_list, outfile, tscrunch=True,
                     pscrunch=True, quiet=True):
    """Weight-average archives phase-aligned by their header ephemerides
    only, on the host (the psradd replacement that builds an initial
    template, ppalign.py:21-35)."""
    from pulseportraiture_tpu_torch.pipelines.toas import _resolve_datafiles
    acc = wacc = first = None
    for f in _resolve_datafiles(metafile_or_list):
        data = load_data(f, dededisperse=False, tscrunch=tscrunch,
                         pscrunch=pscrunch, rm_baseline=True, quiet=True)
        if first is None:
            first = data
        w = data.weights[:, :, None] * data.noise_stds[:, 0][:, :, None] \
            ** -2.0
        w = np.where(np.isfinite(w), w, 0.0)
        contrib = (data.subints[:, 0] * w).sum(0)
        if acc is None:
            acc, wacc = contrib, w.sum(0)
        else:
            acc = acc + contrib
            wacc = wacc + w.sum(0)
    avg = acc / np.where(wacc > 0, wacc, 1.0)
    arch = first.arch.copy()
    arch.tscrunch()
    arch.pscrunch()
    unload_new_archive(avg[None, None], arch, outfile, DM=first.DM, dmc=0,
                       weights=(wacc[:, 0] > 0).astype(float)[None],
                       quiet=quiet)
    return outfile


def psrsmooth_archive(archive, outfile=None, quiet=True, device="cuda"):
    """smart_smooth every profile of an archive on the device (float64)
    and write it to outfile (default <archive>.sm): the psrsmooth -W
    replacement (ppalign.py:38-52)."""
    from pulseportraiture_tpu_torch.io.psrfits import (read_psrfits,
                                                       write_psrfits)
    from pulseportraiture_tpu_torch.models.wavelet import smart_smooth
    dev = resolve_device(device)
    arch = read_psrfits(archive)
    nsub, npol = arch.data.shape[:2]
    sm = np.zeros_like(arch.data)
    for isub in range(nsub):
        for ipol in range(npol):
            sm[isub, ipol] = smart_smooth(arch.data[isub, ipol],
                                          device=dev).cpu().numpy()
    arch.data = sm
    out = outfile or (archive + ".sm")
    write_psrfits(out, arch, quiet=quiet)
    return out


def align_archives(metafile=None, datafiles=None, initial_guess=None,
                   tscrunch=False, pscrunch=True, outfile="aligned.port",
                   norm=None, fit_dm=True, niter=1, quiet=True,
                   SNR_cutoff=0.0, place=None, smooth=False, rot_phase=0.0,
                   device="cuda", return_fits=False):
    """Iteratively align archives to a template and average them into
    outfile (an archive, DM 0, 0/1 weights).  Reference:
    ppalign.py:54-243.

    initial_guess: the archive whose dedispersed, t/p-scrunched portrait
    seeds the template (default: the first).  Each subint is rotated at
    float64 by its header DM (the template is dedispersed), seeded by a
    phase fit of the channel-mean profiles and fitted for (phi[, DM]) at
    its SNR-weighted fit frequency; a one-channel subint takes the phase
    fit alone.  device: "cuda" (the default) or "cpu"; the rotations and
    the average are float64, the fits float32 on the card, where each
    (phi, DM) fit is then polished in float64 (polish_phi_dm).  norm,
    rot_phase, place and smooth post-process the average as ppalign's
    -N, -r, --place and -s do.  return_fits: also return the last
    iteration's fits, one dict a subint (datafile, isub, phi, phi_err,
    DM, DM_err, nu_fit; phi at nu_fit, DM the residual from the header
    DM, both the rotation that aligns the subint with the template).
    """
    from pulseportraiture_tpu_torch.fitters.phase_shift import \
        fit_phase_shift
    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full, polish_phi_dm)
    from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait
    from pulseportraiture_tpu_torch.ops.transform import guess_fit_freq
    from pulseportraiture_tpu_torch.pipelines.toas import _resolve_datafiles
    from pulseportraiture_tpu_torch.portrait import fit_dtype_for

    dev = resolve_device(device)
    dtype = torch.float64
    fdt = fit_dtype_for(dev, dtype)

    def on_dev(x, dt=dtype):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dt,
                               device=dev)

    if datafiles is None:
        datafiles = _resolve_datafiles(metafile)
    if initial_guess is None:
        initial_guess = datafiles[0]
    # the template is dedispersed (the reference loads the initial guess
    # with dedisperse=True, ppalign.py:103-106); the epochs stay as
    # stored and carry their header DM into the rotation
    tmpl_data = load_data(initial_guess, dedisperse=True, tscrunch=True,
                          pscrunch=True, rm_baseline=True, quiet=True)
    template = on_dev(tmpl_data.subints[0, 0])
    tmpl_freqs = tmpl_data.freqs[0]
    nchan_t, nbin = template.shape

    niter = max(1, int(niter))
    npol_out = 1 if pscrunch else 4
    load_cache = []
    for f in datafiles:
        try:
            load_cache.append(load_data(f, dededisperse=False,
                                        tscrunch=tscrunch,
                                        pscrunch=pscrunch,
                                        rm_baseline=True, quiet=True))
        except (OSError, ValueError, KeyError) as exc:
            print(f"Skipping {f}: {exc}")

    for _ in range(niter):
        fits = []
        aligned = torch.zeros((npol_out,) + tuple(template.shape),
                              dtype=dtype, device=dev)
        wsum = torch.zeros(nchan_t, dtype=dtype, device=dev)
        for data in load_cache:
            if data.subints.shape[1] < npol_out:
                print(f"{data.source}: npol < {npol_out}; skipping")
                continue
            for isub in data.ok_isubs:
                P = data.Ps[isub]
                freqs = data.freqs[isub]
                errs = np.where(data.weights[isub] > 0,
                                data.noise_stds[isub, 0], 0.0)
                okc = data.ok_ichans[isub]
                if not len(okc):
                    continue
                # template channels by nearest frequency (ppalign.py:161-172)
                if len(freqs) != nchan_t or \
                        not np.allclose(freqs, tmpl_freqs):
                    idx = torch.as_tensor(np.array(
                        [np.argmin(np.abs(tmpl_freqs - f)) for f in freqs]),
                        device=dev)
                    model = template[idx]
                else:
                    idx = None
                    model = template
                DM_guess = data.DM if not data.dmc else 0.0
                nu_fit = float(guess_fit_freq(freqs[okc],
                                              data.SNRs[isub, 0][okc],
                                              device="cpu"))
                # the header DM removed at float64: the fit solves a
                # small residual dDM
                bases = [rotate_portrait(on_dev(data.subints[isub, ipol]),
                                         0.0, DM_guess, P, freqs, nu_fit)
                         for ipol in range(npol_out)]
                okc_t = torch.as_tensor(okc, device=dev)
                pg = fit_phase_shift(bases[0][okc_t].mean(0).to(fdt),
                                     model[okc_t].mean(0).to(fdt), Ns=nbin)
                if len(okc) > 1:
                    res, _ = fit_portrait_full(
                        bases[0].to(fdt), model,
                        [float(pg.phase), 0.0, 0.0, 0.0, 0.0], P, freqs,
                        nu_fits=(nu_fit, nu_fit, nu_fit),
                        nu_outs=(nu_fit, nu_fit, nu_fit), errs=errs,
                        fit_flags=(1, int(fit_dm), 0, 0, 0),
                        log10_tau=False, quiet=True, scattering=False)
                    if float(res.snr) < SNR_cutoff:
                        continue
                    phi, dDM_fit = float(res.phi), float(res.DM)
                    scales = res.scales.to(dtype)
                    if fdt != dtype:
                        phi, dDM_fit, scales = polish_phi_dm(
                            bases[0], model, phi, dDM_fit, P, freqs, nu_fit,
                            errs, fit_dm=fit_dm)
                    phi_err, DM_err = float(res.phi_err), float(res.DM_err)
                else:  # one channel: the phase fit (ppalign.py:196-201)
                    phi, dDM_fit = float(pg.phase), 0.0
                    phi_err, DM_err = float(pg.phase_err), 0.0
                    scales = torch.full((len(freqs),), float(pg.scale),
                                        dtype=dtype, device=dev)
                fits.append(dict(datafile=data.filename, isub=int(isub),
                                 phi=phi, phi_err=phi_err, DM=dDM_fit,
                                 DM_err=DM_err, nu_fit=nu_fit))
                errs_t = on_dev(errs)
                w = torch.where(errs_t > 0, scales / torch.where(
                    errs_t > 0, errs_t, torch.ones_like(errs_t)) ** 2,
                    torch.zeros_like(errs_t))
                for ipol in range(npol_out):
                    rotated = rotate_portrait(bases[ipol], phi, dDM_fit, P,
                                              freqs, nu_fit) * w[:, None]
                    if idx is None:
                        aligned[ipol] += rotated
                    else:    # grids differ: duplicates accumulate
                        aligned[ipol].index_add_(0, idx, rotated)
                if idx is None:
                    wsum += w
                else:
                    wsum.index_add_(0, idx, w)
        aligned = aligned / torch.where(wsum > 0, wsum,
                                        torch.ones_like(wsum))[None, :, None]
        template = aligned[0]

    if norm is not None:
        # norms from total intensity, applied to every polarization
        from pulseportraiture_tpu_torch.ops.normalize import \
            normalize_portrait
        _, norms = normalize_portrait(
            aligned[0].to(fdt if norm == "prof" else dtype), method=norm,
            return_norms=True)
        norms = norms.to(dtype)
        aligned = aligned / torch.where(norms != 0.0, norms,
                                        torch.ones_like(norms))[None, :, None]
    if rot_phase:
        aligned = rotate_portrait(aligned, rot_phase)
    if place is not None:
        # the profile's peak to a chosen phase by a fit against a narrow
        # Gaussian there (ppalign.py:222-226)
        from pulseportraiture_tpu_torch.ops.gaussian import gaussian_profile
        pg = fit_phase_shift(aligned[0].mean(0).to(fdt),
                             on_dev(gaussian_profile(nbin, place, 0.01), fdt),
                             Ns=nbin)
        aligned = rotate_portrait(aligned, float(pg.phase))
    if smooth:
        from pulseportraiture_tpu_torch.models.wavelet import smart_smooth
        aligned = torch.stack([smart_smooth(p) for p in aligned])

    arch = tmpl_data.arch.copy()
    if npol_out == 4:
        arch.state = "Stokes"
    weights_out = (wsum > 0).to(torch.float64).cpu().numpy()[None]
    unload_new_archive(aligned.cpu().numpy()[None], arch, outfile, DM=0.0,
                       dmc=0, weights=weights_out, quiet=quiet)
    return (outfile, fits) if return_fits else outfile
