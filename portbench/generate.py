"""The general generator: a deployment's data portraits from the seed.

One function serves every fit traffic mix.  The configuration file fixes
the band, the channels, the bins, the period, the template and the noise;
the traffic file fixes the draws (phase, DM offset, amplitude and, where
it asks for them, scattering times).  Data are made on the card in a few
large calls and quantized to int16 with a scale a channel, as the int16
PSRFITS archives a telescope writes carry them.

bench_template and the data recipe follow chip_smoke.py's
(bench_template, shifted_data); the band cap follows the program's
ops.setup_dft.band_cap_model_ft.  These copies are the benchmark's own.
"""

import math

import torch

I16_MAX = 32767.0


def freqs(config, device):
    """Channel centre frequencies [MHz], float64: nchan equal channels
    across [freq_lo_mhz, freq_hi_mhz]."""
    lo, hi, n = config["freq_lo_mhz"], config["freq_hi_mhz"], config["nchan"]
    cw = (hi - lo) / n
    return lo + cw * (0.5 + torch.arange(n, dtype=torch.float64,
                                         device=device))


def template(config, nu):
    """The noiseless template (nchan, nbin), float64, on nu's device: a sum
    of Gaussian components [centre rot, width rot, amplitude, spectral
    index], each scaled by (nu / ref_mhz) ** index."""
    nbin = config["nbin"]
    x = (torch.arange(nbin, dtype=torch.float64, device=nu.device) + 0.5) \
        / nbin
    r = nu[:, None] / config["template"]["ref_mhz"]
    out = torch.zeros((len(nu), nbin), dtype=torch.float64, device=nu.device)
    for c, wid, amp, index in config["template"]["components"]:
        out += amp * torch.exp(-0.5 * ((x - c) / wid) ** 2)[None, :] * \
            r ** index
    return out


def capped_spectrum(model, rel_floor):
    """The template's spectrum as a float32 fit takes it: the float64
    rfft with DC zeroed, cast to float32, harmonics whose amplitude in
    every channel is below rel_floor times the largest zeroed, and the
    prefix kept up to the cap NQ * M' (NQ = nbin / 128; M' the smallest
    multiple of 8 past the last harmonic left), where nbin = 128 NQ with
    NQ even in [2, 32] and the cap is below the band; else the full
    band.  Returns (mr, mi), each (nchan, nh), float32."""
    nbin = model.shape[-1]
    mf = torch.fft.rfft(model, dim=-1)
    mr, mi = mf.real.float().clone(), mf.imag.float().clone()
    mr[:, 0] = 0.0
    mi[:, 0] = 0.0
    a = (mr.abs() + mi.abs()).amax(dim=0)
    dead = a < rel_floor * a.max()
    mr[:, dead] = 0.0
    mi[:, dead] = 0.0
    nq = nbin // 128
    if nbin % 128 or not (2 <= nq <= 32) or nq % 2:
        return mr, mi
    k_last = int(torch.nonzero(mr.abs().amax(0) + mi.abs().amax(0))[-1])
    mh = -(-(k_last + 1) // nq)
    mh += (-mh) % 8
    if mh >= nbin // 2 // nq:
        return mr, mi
    nh = nq * mh
    return mr[:, :nh].contiguous(), mi[:, :nh].contiguous()


def fit_frequency(nu, model):
    """The fit's reference frequency [MHz] as the pipeline picks it: the
    band centre moved by the channels' S/N nu^-2 weights (S/N taken as
    the template's rms a channel)."""
    snr = model.std(dim=-1)
    nu0 = 0.5 * (nu.min() + nu.max())
    w = snr * nu ** -2.0
    return float(nu0 + ((nu - nu0) * w).sum() / w.sum())


def _uniform(gen, n, lo, hi, device, log=False):
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    if log:
        return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return lo + u * (hi - lo)


class Pool:
    """pool distinct batches of B data portraits on the card.

    x (pool, B, nchan, nbin) int16 and scales (pool, B, nchan) float32:
    the data; truth (pool, B, 5) float64: the injected (phi [rot], DM
    offset, 0, log10 tau [rot], alpha) at the fit frequency nu_fit (tau
    and alpha 0 without scattering); mr, mi: the template spectrum as the
    fit takes it; nu (nchan,) float64; model (nchan, nbin) float64."""

    def __init__(self, config, traffic, seed, device):
        B, npool = traffic["batch"], traffic["pool"]
        C, N, P = config["nchan"], config["nbin"], config["period_s"]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.nu = nu = freqs(config, device)
        self.model = model = template(config, nu)
        self.mr, self.mi = capped_spectrum(model, config["band_cap_rel_floor"])
        self.nu_fit = nu_fit = fit_frequency(nu, model)
        n = npool * B
        phi = _uniform(gen, n, *traffic["phi_rot"], device)
        ddm = _uniform(gen, n, *traffic["ddm"], device)
        amp = _uniform(gen, n, *traffic["amp"], device, log=True)
        truth = torch.zeros((n, 5), dtype=torch.float64, device=device)
        truth[:, 0], truth[:, 1] = phi, ddm
        scat = traffic.get("scattering")
        if scat:
            tau_ref = _uniform(gen, n, *scat["tau_rot"], device, log=True)
            alpha = scat["alpha"]
            truth[:, 3] = torch.log10(tau_ref * (nu_fit / scat["ref_mhz"])
                                      ** alpha)
            truth[:, 4] = alpha
        self.truth = truth.view(npool, B, 5)
        kdm = config["dispersion_constant"] / P
        mft = torch.fft.rfft(model, dim=-1).to(torch.complex64)
        k = torch.arange(N // 2 + 1, dtype=torch.float64, device=device)
        self.x = torch.empty((npool, B, C, N), dtype=torch.int16,
                             device=device)
        self.scales = torch.empty((npool, B, C), dtype=torch.float32,
                                  device=device)
        xf, sf = self.x.view(n, C, N), self.scales.view(n, C)
        # items a pass: each holds a (step, nchan, nbin/2+1) spectrum
        step = 8 * max(1, 4096 // C)
        for i in range(0, n, step):
            j = slice(i, min(i + step, n))
            shift = phi[j, None] + kdm * ddm[j, None] * (nu ** -2.0 -
                                                         nu_fit ** -2.0)
            ang = torch.remainder(shift[..., None] * k, 1.0) * (-2 * math.pi)
            spec = mft * torch.polar(amp[j, None, None].expand_as(ang),
                                     ang).to(torch.complex64)
            if scat:
                taus = 10.0 ** truth[j, 3, None] * (nu / nu_fit) ** alpha
                spec = spec / torch.complex(
                    torch.ones_like(ang), 2 * math.pi * k * taus[..., None]
                ).to(torch.complex64)
            d = torch.fft.irfft(spec, n=N, dim=-1)
            d += config["noise"] * torch.randn(d.shape, generator=gen,
                                               dtype=torch.float32,
                                               device=device)
            s = d.abs().amax(dim=-1) / I16_MAX
            sf[j] = s
            xf[j] = torch.round(d / s[..., None]).to(torch.int16)
