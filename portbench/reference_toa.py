"""The plain reference of a wideband TOA line, in plain PyTorch.

It imports nothing of the program and reads no file the program reads:
from an archive's int16 samples and scales as the generator made them
(archives.Pool), it computes each subint's TOA line as pptoas defines it
(Pennucci, Demorest & Ransom 2014; PulsePortraiture's pptoas):

  decode      x = DAT_SCL raw (DAT_OFFS left out: it moves only the DC
              harmonic, which neither the noise nor the fit reads);
  baseline    the windowed-minimum rule: the mean of the wrapped window of
              0.15 nbin bins whose smoothed mean is least, taken off each
              channel (it enters only the S/N);
  noise       sigma_n = sqrt(mean over the top quarter of the harmonics,
              k >= int(0.75 (nbin/2 + 1)), of |X_k|^2 / nbin), a channel;
  S/N         (sum p) / (sigma sqrt(W_eq)), W_eq = sum p / max p, with
              sigma the rms of the archive's channel noises, and the
              fit's reference frequency nu_fit from the S/N nu^-2
              weights about the band's middle;
  template    the configuration's Gaussians at each channel
              (archives.template), dispersed by the header's DM0 about
              the band's mean nu_a, as a float32 fit takes it: rounded to
              float32, its spectrum rounded to float32 with DC and every
              harmonic below band_cap_rel_floor of the largest zeroed and
              cut at the band cap NQ M' (the fit cells' reference takes
              the same float32 spectrum);
  fit         reference.fit: the (phi, DM) fit of the int16 samples
              against that spectrum with the channel noises, from the
              injected parameters, its outputs at nu_DM;
  line        phi' = phi + (D DM0 / P)(nu_DM^-2 - nu_a^-2), wrapped to
              [-0.5, 0.5); TOA = epoch + phi' P + the backend delay;
              its error phi_err P; DM = (DM0 + dDM) times the subint's
              Doppler factor; the DM error dDM_err; gof the reduced chi2.

Departures from pptoas, all of them outside what a line compares: the
baseline's window is chosen on float64 sums (the program's float32 sums
may pick a neighbouring window on a near-tie, which moves only nu_fit);
the fit starts from the injection, not from a brute-force seed; every
subint has the same period, so the template's period is the subint's.
The Doppler factor is the generator's, where pptoas reads it from the
archive.

precision "float64" is the reference; "tf32" (the control) and
"float32" (the witness) take every step in float32, the fit's matrix
products in TF32 for the control, as reference.fit does.
"""

import math

import torch

from portbench import reference
from portbench.archives import template

# the baseline's window, a share of the bins; the noise's top share of
# the harmonics; the fit's parameters (phi, DM)
BASE_FRAC, NOISE_FRAC, FIT_FLAGS = 0.15, 4, (1, 1, 0, 0, 0)


def _dtype(precision):
    return torch.float64 if precision == "float64" else torch.float32


def _window_sums(d, wlen):
    """s_i = sum of d[(i + 1 + m) mod n], m < wlen, along the last axis."""
    n = d.shape[-1]
    c = torch.cumsum(torch.cat([d, d[..., :wlen]], -1), -1)
    return c[..., wlen:] - c[..., :n]


def baseline(x):
    """The windowed-minimum baseline of each profile of x (..., nbin)."""
    wlen = max(1, int(BASE_FRAC * x.shape[-1]))
    w = _window_sums(x, wlen) / wlen
    i = torch.argmin(_window_sums(w, wlen), -1, keepdim=True)
    return torch.take_along_dim(w, i, -1)[..., 0]


def noise(x):
    """Each profile's noise a sample from the top quarter of its power
    spectrum."""
    n = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    kc = int((1 - 1.0 / NOISE_FRAC) * X.shape[-1])
    t = X[..., kc:]
    return torch.sqrt(((t.real ** 2 + t.imag ** 2) / n).mean(-1))


def fit_frequencies(x, sig, nu):
    """nu_fit [MHz] of each subint of x (nsub, nchan, nbin): the band's
    middle moved by the channels' S/N nu^-2 weights, the S/N against the
    rms of the archive's channel noises sig (nsub, nchan)."""
    p = x - baseline(x)[..., None]
    s = torch.sqrt((sig[sig > 0] ** 2).mean())
    weq = p.sum(-1) / p.amax(-1)
    snr = torch.where(weq > 0, p.sum(-1) / (s * torch.sqrt(
        torch.where(weq > 0, weq, torch.ones_like(weq)))),
        torch.zeros_like(weq))
    nu0 = 0.5 * (nu.min() + nu.max())
    w = snr * nu ** -2.0
    return nu0 + ((nu - nu0) * w).sum(-1) / w.sum(-1)


def template_spectrum(config, nu, nu_a):
    """(mr, mi) (nchan, nh) float32: the template as a float32 fit takes
    it.  The template dispersed by the header's DM about nu_a, rounded
    to float32; its float64 spectrum rounded to float32, DC and the
    harmonics below the floor zeroed, cut at the band cap (nbin = 128
    NQ, NQ even in [2, 32]; the cap NQ M', M' the smallest multiple of 8
    past the last harmonic left, where below the band)."""
    nbin = config["nbin"]
    mf = torch.fft.rfft(template(config, nu, nbin), dim=-1)
    k = torch.arange(mf.shape[-1], dtype=torch.float64, device=nu.device)
    kdm = config["dispersion_constant"] / config["period_s"]
    shift = kdm * config["dm"] * (nu ** -2.0 - nu_a ** -2.0)
    ang = torch.remainder(shift[:, None] * k, 1.0) * (-2 * math.pi)
    rot = torch.fft.irfft(mf * torch.polar(torch.ones_like(ang), ang),
                          n=nbin, dim=-1)
    mf = torch.fft.rfft(rot.float().double(), dim=-1)
    mr, mi = mf.real.float().clone(), mf.imag.float().clone()
    mr[:, 0] = 0.0
    mi[:, 0] = 0.0
    a = (mr.abs() + mi.abs()).amax(0)
    dead = a < config["band_cap_rel_floor"] * a.max()
    mr[:, dead] = 0.0
    mi[:, dead] = 0.0
    nq = nbin // 128
    if nbin % 128 or not (2 <= nq <= 32) or nq % 2:
        return mr, mi
    k_last = int(torch.nonzero(~dead)[-1])
    mh = -(-(k_last + 1) // nq)
    mh += (-mh) % 8
    if mh >= nbin // 2 // nq:
        return mr, mi
    return mr[:, :mh * nq].contiguous(), mi[:, :mh * nq].contiguous()


def lines(pool, ia, precision="float64"):
    """The TOA lines of archive ia of pool (an archives.Pool), a dict of
    (nsub,) float64 tensors on the host: day (the TOA's MJD day), sec
    (its seconds in the day), toa_err_us, dm, dm_err, gof, freq (nu_DM,
    MHz)."""
    cfg = pool.config
    dt = _dtype(precision)
    P, dm0, dconst = cfg["period_s"], cfg["dm"], cfg["dispersion_constant"]
    nu = pool.nu
    raw, scl = pool.raw[ia], pool.scl[ia]
    x = raw.to(dt) * scl.to(dt)[..., None]
    sig = noise(x)
    nu_fit = fit_frequencies(x, sig, nu.to(dt)).double()
    mr, mi = template_spectrum(cfg, nu, pool.nu_a)
    kdm = dconst / P
    out = {n: [] for n in ("day", "sec", "toa_err_us", "dm", "dm_err",
                           "gof", "freq")}
    for isub in range(pool.nsub):
        phi, ddm = (float(v) for v in pool.truth[ia, isub])
        nf = float(nu_fit[isub])
        start = torch.zeros((1, 5), dtype=torch.float64, device=nu.device)
        start[0, 0] = phi + kdm * ddm * (nf ** -2.0 - pool.nu_a ** -2.0)
        start[0, 1] = ddm
        f = reference.fit(raw[isub][None], scl[isub][None], mr, mi, nu,
                          sig[isub], P, nf, start, FIT_FLAGS, dconst,
                          precision=precision)
        nu_dm = float(f.nu_DM[0])
        ph = float(f.params[0, 0]) + kdm * dm0 * (nu_dm ** -2.0 -
                                                   pool.nu_a ** -2.0)
        ph = (ph + 0.5) % 1.0 - 0.5
        day, sec = pool.epoch(ia, isub)
        out["day"].append(day)
        out["sec"].append(sec + ph * P + cfg["backend_delay_s"])
        out["toa_err_us"].append(float(f.errs[0, 0]) * P * 1e6)
        out["dm"].append((dm0 + float(f.params[0, 1])) *
                         float(pool.doppler[ia, isub]))
        out["dm_err"].append(float(f.errs[0, 1]))
        out["gof"].append(float(f.red_chi2[0]))
        out["freq"].append(nu_dm)
    return {n: torch.tensor(v, dtype=torch.float64) for n, v in out.items()}


def numbers(got, ref, doppler, config):
    """{name: (n,) float64} of lines got against the reference's lines ref
    of the same subints (dicts as lines() gives them; doppler (n,) the
    subints' Doppler factors): the TOA moved to the reference's frequency
    with its own DM, its gap (to the nearest turn) in the reference's TOA
    errors; the DM's gap in the reference's DM errors; the relative gaps
    of the two errors; the gap of gof."""
    P, dconst = config["period_s"], config["dispersion_constant"]
    t = (got["day"] - ref["day"]) * 86400.0 + (got["sec"] - ref["sec"])
    t = t + dconst * (got["dm"] / doppler) * (ref["freq"] ** -2.0 -
                                              got["freq"] ** -2.0)
    t = t - P * torch.round(t / P)
    return {"toa_sigma": t.abs() / (ref["toa_err_us"] * 1e-6),
            "dm_sigma": (got["dm"] - ref["dm"]).abs() / ref["dm_err"],
            "toa_err_rel": (got["toa_err_us"] - ref["toa_err_us"]).abs() /
            ref["toa_err_us"],
            "dm_err_rel": (got["dm_err"] - ref["dm_err"]).abs() /
            ref["dm_err"],
            "gof_abs": (got["gof"] - ref["gof"]).abs()}
