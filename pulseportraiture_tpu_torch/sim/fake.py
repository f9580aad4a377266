"""Fake-pulsar archives: the verification backend.

Port of pulseportraiture_tpu.sim.fake.  make_fake_pulsar mirrors the
reference's PSRCHIVE-backed generator (pplib.py:3183-3378): evaluate a
.gmodel at the channel grid (the port's host evaluator), optionally
scatter (analytic FT), add DM(nu) structure and scintillation, scale and
add Gaussian noise, and write the port's PSRFITS subset in the requested
dispersion state.  It draws from the caller's numpy rng in the JAX
package's order, so one seed writes one archive in either package.
Everything runs on the host in float64: an archive is data made once.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.config import DCONST, SCATTERING_ALPHA
from pulseportraiture_tpu_torch.io.mjd import MJD
from pulseportraiture_tpu_torch.io.par import parse_par, period_at
from pulseportraiture_tpu_torch.io.psrfits import (Archive, read_psrfits,
                                                   write_psrfits)
from pulseportraiture_tpu_torch.utils import get_bin_centers


def add_scintillation(port, params=None, random=True, nsin=2, amax=1.0,
                      wmax=3.0, rng=None):
    """Scale the channels of port (nchan, nbin) by a sum of sin^2
    patterns: params (a, w, p) triplets, or nsin random ones from rng.
    Reference: pplib.py:1146-1174."""
    port = np.asarray(port)
    nchan = len(port)
    pattern = np.zeros(nchan)
    if params is None and random is False:
        return port
    if params is not None:
        triplets = [params[i * 3:i * 3 + 3] for i in range(len(params) // 3)]
    else:
        rng = rng or np.random.default_rng()
        triplets = [(rng.uniform(0, amax), rng.chisquare(wmax),
                     rng.uniform(0, 1)) for _ in range(nsin)]
    for a, w, p in triplets:
        pattern += a * np.sin(np.linspace(0, w * np.pi, nchan) +
                              p * np.pi) ** 2
    return port * pattern[:, None]


def mean_C2N(nu, D, bw_scint):
    """Mean C_N^2 [m^-20/3] (Foster, Fairhead & Backer 1991).
    Reference: pplib.py:1176-1187."""
    return 2e-14 * nu ** (11 / 3.0) * D ** (-11 / 6.0) * \
        bw_scint ** (-5 / 6.0)


def dDM(D, D_screen, nu, bw_scint):
    """Predicted frequency-dependent delta-DM [cm^-3 pc].
    Reference: pplib.py:1189-1202."""
    SM = mean_C2N(nu, D, bw_scint) * D
    return 10 ** 4.45 * SM * D_screen ** (5 / 6.0) * nu ** (-11 / 6.0)


def _host_ramp(phis, nharm):
    """exp(2j pi phis[:, None] k), float64, the angle reduced mod 1 turn."""
    theta = np.mod(phis[:, None] * np.arange(nharm), 1.0) * (2.0 * np.pi)
    return np.cos(theta) + 1j * np.sin(theta)


def make_fake_pulsar(modelfile, ephemeris, outfile="fake_pulsar.fits",
                     nsub=1, npol=1, nchan=512, nbin=2048, nu0=1500.0,
                     bw=800.0, tsub=300.0, phase=0.0, dDM=0.0,
                     start_MJD=None, weights=None, noise_stds=1.0,
                     scales=1.0, dedispersed=False, t_scat=0.0,
                     alpha=SCATTERING_ALPHA, scint=False, xs=None, Cs=None,
                     nu_DM=np.inf, state="Stokes", telescope="GBT",
                     quiet=True, rng=None, dtype="i2"):
    """Write a fake-pulsar archive; returns its Archive.  Reference:
    pplib.py:3183-3378.

    The archive's header DM is the ephemeris's, but the data carry an
    extra dDM (and with xs/Cs a power-law DM(nu)), so fits recover
    DeltaDM ~= dDM.  Dispersed output on the achromatic path folds the
    header DM into the model's one rotation and draws the noise in the
    dispersed frame (statistically the same noise as rotating signal +
    noise afterwards).  dtype: "i2" (int16 with per-channel scales, what
    PSRCHIVE writes) or "f4".
    """
    from pulseportraiture_tpu_torch.models.gmodel_io import read_model
    from pulseportraiture_tpu_torch.ops.rotate import add_DM_nu
    from pulseportraiture_tpu_torch.ops.scattering import (
        scattering_portrait_FT_np, scattering_times)
    from pulseportraiture_tpu_torch.ops.transform import phase_transform

    rng = rng or np.random.default_rng()
    chanwidth = bw / nchan
    lofreq = nu0 - bw / 2
    freqs = np.linspace(lofreq + chanwidth / 2.0,
                        lofreq + bw - chanwidth / 2.0, nchan)
    phases = get_bin_centers(nbin, lo=0.0, hi=1.0)
    noise_stds = np.broadcast_to(np.asarray(noise_stds, dtype=float),
                                 (nchan,))
    scales = np.broadcast_to(np.asarray(scales, dtype=float), (nchan,))
    par = parse_par(ephemeris)
    if start_MJD is None:
        start_MJD = MJD(float(par.PEPOCH))
    epochs = [start_MJD.add_seconds(tsub / 2.0 + isub * tsub)
              for isub in range(nsub)]
    Ps = np.array([period_at(par, ep.in_days()) for ep in epochs])
    if weights is None:
        weights = np.ones((nsub, nchan))
    params = read_model(modelfile, quiet=True)[4]
    fold_hdr_dm = (not dedispersed) and xs is None and par.DM != 0.0
    inv2 = np.where(np.isinf(freqs), 0.0, freqs) ** -2.0
    ref2 = 0.0 if np.isinf(nu0) else float(nu0) ** -2.0
    data = np.zeros((nsub, npol, nchan, nbin))
    model = None
    for isub in range(nsub):
        P = Ps[isub]
        if model is None or params[1] != 0:     # a scattered model needs P
            model = read_model(modelfile, phases, freqs, P, quiet=True)[2]
            mft = np.fft.rfft(model, axis=-1)
        if xs is None:
            # achromatic rotation + extra dispersion, one combined ramp
            Dtot = DCONST * (dDM + (par.DM if fold_hdr_dm else 0.0)) / P
            phis = -phase - Dtot * (inv2 - ref2)
            spec = mft * _host_ramp(phis, mft.shape[-1])
        else:
            ph = phase_transform(phase, dDM, nu0, nu_DM, P)
            rotmodel = add_DM_nu(
                model, -ph, -dDM, P, freqs, xs=xs,
                Cs=Cs if Cs is not None else [1.0] * len(xs), nu_ref=nu_DM,
                device="cpu").numpy()
            spec = None
        if t_scat and not params[1]:  # the model's own tau overrides t_scat
            taus = scattering_times(t_scat / P, alpha, freqs, nu0)
            if spec is None:
                spec = np.fft.rfft(rotmodel, axis=-1)
            spec = spec * scattering_portrait_FT_np(taus, nbin)
        if spec is not None:
            rotmodel = np.fft.irfft(spec, n=nbin, axis=-1)
        if scint is not False:
            if scint is True:
                rotmodel = add_scintillation(rotmodel, random=True, nsin=3,
                                             amax=1.0, wmax=5.0, rng=rng)
            else:
                rotmodel = add_scintillation(rotmodel, scint)
        for ipol in range(npol):
            noise = rng.normal(0.0, 1.0, (nchan, nbin)) * \
                noise_stds[:, None]
            data[isub, ipol] = scales[:, None] * rotmodel + noise

    with open(ephemeris) as f:
        eph_lines = [ln.rstrip("\n") for ln in f.readlines()]
    arch = Archive(
        data=data, freqs=np.broadcast_to(freqs, (nsub, nchan)).copy(),
        weights=np.asarray(weights, dtype=float), Ps=Ps, epochs=epochs,
        subtimes=np.full(nsub, float(tsub)), DM=par.DM, dedispersed=True,
        nu0=float(nu0), bw=float(bw), source=par.PSR, telescope=telescope,
        frontend="fake_rx", backend="fake_be",
        state=state if npol == 4 else "Intensity",
        ephemeris_lines=eph_lines)
    if fold_hdr_dm:
        arch.dedispersed = False    # generated in the dispersed frame
    elif not dedispersed:
        arch.dededisperse()
    write_psrfits(outfile, arch, dtype=dtype, quiet=quiet)
    return arch


def make_constant_portrait(archive, outfile, profile=None, DM=0.0,
                           dmc=False, weights=None, quiet=False):
    """Write a copy of an archive whose every channel and subint holds one
    profile (default: the archive's own t/p/f-scrunched profile).
    Reference: pplib.py:958-994."""
    arch = read_psrfits(archive)
    nsub, npol, nchan, nbin = arch.data.shape
    if profile is None:
        prof_arch = arch.copy()
        prof_arch.tscrunch()
        prof_arch.pscrunch()
        prof_arch.fscrunch()
        profile = prof_arch.data[0, 0, 0]
    profile = np.asarray(profile)
    if len(profile) != nbin:
        raise ValueError("len(profile) != number of bins in dummy archive")
    if weights is None:
        weights = np.ones((nsub, nchan))
    out = arch.copy()
    out.data = np.broadcast_to(profile, (nsub, npol, nchan, nbin)).copy()
    out.DM = DM
    out.weights = np.asarray(weights, dtype=float)
    out.dedispersed = bool(dmc)
    write_psrfits(outfile, out, quiet=quiet)
