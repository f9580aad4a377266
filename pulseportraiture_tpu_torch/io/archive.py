"""Archives in and out: load_data, unload_new_archive, write_archive.

Port of pulseportraiture_tpu/io/archive.py (same DataBunch schema,
reference pplib.py:2650-2814, 3033-3181), on this package's own copies
of the PSRFITS codec, the ephemeris geometry and the noise estimators.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.io.psrfits import (Archive, read_psrfits,
                                                   write_psrfits)
from pulseportraiture_tpu_torch.io.telescopes import telescope_code
from pulseportraiture_tpu_torch.ops import load_stats
from pulseportraiture_tpu_torch.ops.noise import get_noise_PS, get_SNR
from pulseportraiture_tpu_torch.profiling import annotate
from pulseportraiture_tpu_torch.utils import DataBunch, get_bin_centers


def _ephemeris_geometry(arch, nsub):
    """Per-subint (doppler_factors, parallactic_angles).

    Mirrors reference pplib.py:2696-2707: PSRCHIVE's per-Integration
    get_doppler_factor()/get_parallactic_angle() are recomputed from the
    stored ephemeris (RAJ/DECJ) and the observatory coordinates.  A file
    DOPPLER column overrides the Doppler computation; unknown sites or
    missing coordinates fall back to df=1, pa=0.
    """
    dfs = arch.doppler_factors
    pas = np.zeros(nsub)
    ra_deg = dec_deg = None
    if arch.ephemeris_lines:
        from pulseportraiture_tpu_torch.io.par import parse_par
        from pulseportraiture_tpu_torch.io.parang import (dms_to_deg,
                                                          hms_to_deg)
        par = parse_par(arch.ephemeris_lines)
        if hasattr(par, "RAJ") and hasattr(par, "DECJ"):
            try:
                ra_deg = hms_to_deg(par.RAJ)
                dec_deg = dms_to_deg(par.DECJ)
            except ValueError:
                pass
    if ra_deg is None:
        return (dfs if dfs is not None else np.ones(nsub)), pas
    from pulseportraiture_tpu_torch.io.ephem import doppler_factor
    from pulseportraiture_tpu_torch.io.parang import (OBSERVATORY_COORDS,
                                                      parallactic_angle)
    coords = OBSERVATORY_COORDS.get(str(arch.telescope).upper())
    lat, lon = coords if coords is not None else (None, None)
    mjds = np.array([e.in_days() for e in arch.epochs])
    if dfs is None:
        dfs = np.asarray(doppler_factor(mjds, ra_deg, dec_deg, lat, lon))
    if coords is not None and hasattr(par, "RAJ"):
        pas = np.array([parallactic_angle(arch.telescope, par.RAJ,
                                          par.DECJ, m) for m in mjds])
    return dfs, pas


def load_data(filename, state=None, dedisperse=False, dededisperse=False,
              tscrunch=False, pscrunch=False, fscrunch=False,
              rm_baseline=True, flux_prof=False, return_arch=True,
              quiet=True, stats_device=None):
    """Load an archive file into the universal DataBunch record.

    raw_i2/raw_scl (int16 samples + per-channel DAT_SCL) are kept when
    the file is i2-quantized and no transform rewrote the samples; the
    per-channel offsets they drop only feed the DC harmonic.

    stats_device: where the baseline, noise and S/N of an int16 archive
    may be computed from its raw samples (ops/load_stats.archive_stats; a
    card: csrc/load_stats.cu) instead of by the host's numpy passes over
    the decoded cube.  Taken when the samples reach the result unchanged
    (raw_i2 kept, no tscrunch or fscrunch), with rm_baseline, without
    flux_prof, at a width load_stats takes; data.raw_stats says whether it
    was.  The cube (subints, arch.data) is then baseline-removed in place
    at the first read of data.subints.  None: the host route always.

    Traced as pp:load.read (read_psrfits: the file, its columns, the int16
    decode) and pp:load.prep (the rest: baseline, noise, S/N, geometry;
    pp:load.stats inside it on the raw-sample route).
    """
    with annotate("pp:load.read"):
        arch = read_psrfits(filename)
    with annotate("pp:load.prep"):
        return _prepare(arch, filename, state, dedisperse, dededisperse,
                        tscrunch, pscrunch, fscrunch, rm_baseline,
                        flux_prof, return_arch, quiet, stats_device)


def _prepare(arch, filename, state, dedisperse, dededisperse, tscrunch,
             pscrunch, fscrunch, rm_baseline, flux_prof, return_arch, quiet,
             stats_device):
    """load_data's DataBunch from the Archive read from filename."""
    raw_ok = arch.raw_i2 is not None and arch.npol == 1
    if state is not None and state != arch.state and state == "Intensity":
        arch.pscrunch()
    if dedisperse:
        raw_ok = raw_ok and (arch.dedispersed or arch.DM == 0.0)
        arch.dedisperse()
    if dededisperse:
        raw_ok = raw_ok and (not arch.dedispersed or arch.DM == 0.0)
        arch.dededisperse()
    DM = arch.DM
    dmc = arch.dedispersed
    if state is not None and state != arch.state:
        raw_ok = raw_ok and arch.npol == 1
        arch.convert_state(state)
    # the statistics from the raw samples where they reach the result: the
    # scrunches below would rewrite them (pscrunch leaves npol = 1 alone)
    raw_stats = (stats_device is not None and raw_ok and rm_baseline and
                 not (tscrunch or fscrunch or flux_prof) and
                 load_stats.takes(arch.nbin))
    if rm_baseline and not raw_stats:
        arch.remove_baseline()
    if tscrunch:
        raw_ok = False
        arch.tscrunch()
    if pscrunch:
        raw_ok = raw_ok and arch.npol == 1
        arch.pscrunch()
    if fscrunch:
        raw_ok = False
        arch.fscrunch()
    nsub, npol, nchan, nbin = arch.data.shape
    doppler_factors, parallactic_angles = _ephemeris_geometry(arch, nsub)
    freqs = np.asarray(arch.freqs, dtype=np.float64)
    if freqs.shape[0] != nsub:
        freqs = np.broadcast_to(freqs[:1], (nsub, nchan)).copy()
    weights = np.asarray(arch.weights, dtype=np.float64)
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)
    ok_isubs = np.compress(weights_norm.mean(axis=1), range(nsub))
    ok_ichans = [np.compress(weights_norm[isub], range(nchan))
                 for isub in range(nsub)]
    if raw_stats:
        base, noise_stds, SNRs = load_stats.archive_stats(
            arch.raw_i2[:, 0], arch.raw_scl[:, 0], stats_device)
        noise_stds, SNRs = noise_stds[:, None], SNRs[:, None]
        # the decoded cube's baseline: the window's mean of scl*raw + offs
        cube_base = (base + arch.raw_offs[:, 0])[:, None, :, None]
    else:
        # the noise estimate is an error bar: f32 FFTs, carried as f64
        subints_f32 = np.asarray(arch.data, dtype=np.float32)
        noise_stds = np.asarray(get_noise_PS(subints_f32, chans=True),
                                dtype=np.float64)
        nz = noise_stds[noise_stds > 0.0]
        SNRs = np.asarray(
            get_SNR(subints_f32,
                    noise=np.float32(np.sqrt(np.mean(nz ** 2)) if nz.size
                                     else 1.0)),
            dtype=np.float64)
    if flux_prof:
        fl = arch.copy()
        fl.pscrunch()
        fl.dedisperse()
        fl.tscrunch()
        flux_prof_arr = fl.data.mean(axis=3)[0][0]
    else:
        flux_prof_arr = np.array([])
    if not quiet:
        print(f"Read {filename}: {arch.source} P={arch.Ps[0] * 1000:.3f} ms "
              f"DM={DM:.6f} {nchan}x{nbin} nsub={nsub} state={arch.state}")
    data = DataBunch(
        arch=arch if return_arch else None, backend=arch.backend,
        backend_delay=arch.backend_delay, bw=arch.bw,
        doppler_factors=doppler_factors, DM=DM, dmc=dmc,
        epochs=list(arch.epochs), filename=filename,
        flux_prof=flux_prof_arr, freqs=freqs,
        frontend=arch.frontend,
        integration_length=float(arch.subtimes.sum()), nbin=nbin,
        nchan=nchan, noise_stds=noise_stds, npol=npol, nsub=nsub,
        nu0=arch.nu0, ok_ichans=ok_ichans, ok_isubs=ok_isubs,
        parallactic_angles=parallactic_angles,
        phases=get_bin_centers(nbin, lo=0.0, hi=1.0),
        Ps=np.asarray(arch.Ps, dtype=np.float64), raw_stats=raw_stats,
        SNRs=SNRs, source=arch.source, state=arch.state,
        subtimes=list(np.asarray(arch.subtimes, dtype=np.float64)),
        telescope=arch.telescope, telescope_code=telescope_code(
            arch.telescope), weights=weights)
    if raw_ok:
        data.raw_i2 = arch.raw_i2[:, 0]
        data.raw_scl = arch.raw_scl[:, 0].astype(np.float32)
    if raw_stats:
        def _baselined():
            d = arch.data
            if not d.flags.writeable:
                d = arch.data = d.copy()
            d -= cube_base.astype(d.dtype)
            return d

        data.add_lazy("subints", _baselined)
    else:
        data.subints = np.asarray(arch.data)

    # diagnostic fields the TOA pipeline never reads materialize on first
    # access
    def _masks():
        m = np.einsum("ij,k->ijk", weights_norm, np.ones(nbin))
        return np.einsum("j,ikl->ijkl", np.ones(npol), m)

    def _prof_arch():
        data.subints                    # arch.data baseline-removed
        pa = arch.copy()
        pa.pscrunch()
        pa.dedisperse()
        pa.tscrunch()
        pa.fscrunch()
        return pa.data[0, 0, 0]

    data.add_lazy("masks", _masks)
    data.add_lazy("prof", _prof_arch)
    data.add_lazy("prof_noise", lambda: float(get_noise_PS(data.prof)))
    data.add_lazy("prof_SNR", lambda: float(get_SNR(data.prof)))
    return data


def unload_new_archive(data, arch: Archive, outfile, DM=None, dmc=0,
                       weights=None, quiet=False):
    """Write new amplitudes (and weights) into a copy of arch, in its
    dispersed (dmc=0) or dedispersed state, and unload it.  Reference:
    pplib.py:3033-3069."""
    out = arch.copy()
    if dmc:
        out.dedisperse()
    else:
        out.dededisperse()
    if DM is not None:
        out.DM = float(DM)
    out.data = np.asarray(data, dtype=np.float64)
    if weights is not None:
        out.weights = np.asarray(weights, dtype=np.float64)
    write_psrfits(outfile, out, quiet=quiet)


def write_archive(data, ephemeris, freqs, nu0=None, bw=None,
                  outfile="pparchive.fits", tsub=1.0, start_MJD=None,
                  weights=None, dedispersed=False, state="Stokes",
                  telescope="GBT", quiet=False):
    """Write a dedispersed data cube (nsub, npol, nchan, nbin) and an
    ephemeris (a .par path or its lines) as a new PSRFITS archive, stored
    dispersed unless dedispersed; returns the Archive.  Reference:
    pplib.py:3071-3181 (PSRCHIVE's archive hack replaced by direct
    PSRFITS writing)."""
    from pulseportraiture_tpu_torch.io.mjd import MJD
    from pulseportraiture_tpu_torch.io.par import parse_par, period_at

    data = np.asarray(data, dtype=np.float64)
    nsub, npol, nchan, nbin = data.shape
    freqs = np.asarray(freqs, dtype=np.float64)
    if nu0 is None:
        nu0 = freqs.mean()
    if bw is None:
        bw = (freqs.max() - freqs.min()) + abs(freqs[1] - freqs[0])
    if isinstance(ephemeris, str):
        with open(ephemeris) as f:
            eph_lines = f.readlines()
    else:
        eph_lines = list(ephemeris)
    par = parse_par(eph_lines)
    if start_MJD is None:
        start_MJD = MJD(50000, 0, 0.0)
    epochs = [start_MJD.add_seconds(tsub / 2.0 + i * tsub)
              for i in range(nsub)]
    Ps = np.array([period_at(par, ep.in_days()) for ep in epochs])
    if weights is None:
        weights = np.ones((nsub, nchan))
    arch = Archive(
        data=data, freqs=np.broadcast_to(freqs, (nsub, nchan)).copy(),
        weights=np.asarray(weights, dtype=np.float64), Ps=Ps, epochs=epochs,
        subtimes=np.full(nsub, float(tsub)), DM=par.DM,
        dedispersed=True, nu0=float(nu0), bw=float(bw), source=par.PSR,
        telescope=telescope, frontend="fake_rx", backend="fake_be",
        state=state if npol == 4 else "Intensity",
        ephemeris_lines=[ln.rstrip("\n") for ln in eph_lines])
    if not dedispersed:
        arch.dededisperse()
    write_psrfits(outfile, arch, quiet=quiet)
    return arch
