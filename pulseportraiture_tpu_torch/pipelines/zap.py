"""Channel zapping (the ppzap tool).

Port of pulseportraiture_tpu.pipelines.zap.  Model-free: iterative
median and sigma clipping of the per-channel noise levels.  Model-based:
the TOA fit, then GetTOAs.get_channels_to_zap (reduced chi2 and channel
S/N).  Instead of printing PSRCHIVE paz commands the mask is applied to
the archive and written.  Reference: ppzap.py:18-241.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.io.archive import (load_data,
                                                   unload_new_archive)


def get_zap_channels(noise_stds, nstd=3.0, maxiter=20):
    """Channels (sorted indices) whose noise is above median + nstd
    standard deviations of the live channels', clipped iteratively;
    noise_stds (nchan,), with 0 for channels already dead.  Reference:
    ppzap.py:18-48."""
    noise = np.asarray(noise_stds, dtype=float).copy()
    alive = noise > 0
    zap = []
    for _ in range(maxiter):
        vals = noise[alive]
        if len(vals) < 3:
            break
        med = np.median(vals)
        std = vals.std()
        bad = alive & (noise > med + nstd * std)
        if not bad.any():
            break
        zap.extend(np.where(bad)[0].tolist())
        alive &= ~bad
    return sorted(zap)


def zap_archive(datafile, outfile, nstd=3.0, per_subint=False,
                normalize=False, quiet=True, device=None):
    """Model-free zap: clip each subint's noisy channels and write the
    archive with their weights zeroed (the union over subints unless
    per_subint).  normalize divides each channel's noise by its mean
    first (ops.normalize, on `device`, the card by default).  Returns the
    per-subint lists.  Reference: ppzap.py:98-241."""
    data = load_data(datafile, rm_baseline=True, pscrunch=True, quiet=True)
    weights = data.weights.copy()
    all_zaps = []
    for isub in range(data.nsub):
        noise = data.noise_stds[isub, 0].copy()
        if normalize:
            from pulseportraiture_tpu_torch.ops.normalize import \
                normalize_portrait
            _, norms = normalize_portrait(data.subints[isub, 0],
                                          method="mean", return_norms=True,
                                          device=device)
            noise = noise / norms.cpu().numpy()
        noise = np.where(weights[isub] > 0, noise, 0.0)
        zap = get_zap_channels(noise, nstd=nstd)
        all_zaps.append(zap)
        weights[isub, zap] = 0.0
    if not per_subint:
        union = sorted({c for z in all_zaps for c in z})
        weights[:, union] = 0.0
    unload_new_archive(data.subints, data.arch, outfile, DM=data.DM,
                       dmc=int(data.dmc), weights=weights, quiet=quiet)
    return all_zaps


def zap_channels_from_fit(gt, SNR_threshold=8.0, rchi2_threshold=1.3):
    """Model-based zap lists from a GetTOAs that has run get_TOAs.
    Reference: ppzap.py model path, pptoas.py:1208-1285."""
    return gt.get_channels_to_zap(SNR_threshold=SNR_threshold,
                                  rchi2_threshold=rchi2_threshold)
