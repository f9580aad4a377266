"""The benchmark's own int16 PSRFITS archives, made from the seed.

A deployment's folded archives as a telescope writes them: total
intensity (npol = 1), int16 samples with a float32 DAT_SCL and DAT_OFFS a
channel (value = DAT_SCL raw + DAT_OFFS), stored dispersed at the
header's DM, a PERIOD and a DOPPLER column, and the ephemeris as a
PSRPARAM table.  The portraits are made on the card in a few large calls
(the template is the sum of the configuration's Gaussian components, each
with its FWHM and a power-law amplitude, as a .gmodel describes it) and
written with a FITS writer of the benchmark's own, so a change to the
program's PSRFITS code cannot move the inputs.  gmodel_text gives the
template as the .gmodel file the program reads.
"""

import math
import os

import numpy as np
import torch

from portbench.generate import I16_MAX, freqs

BLOCK, CARD = 2880, 80
FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


def template(config, nu, nbin):
    """The noiseless template (nchan, nbin), float64, on nu's device: the
    configuration's components [centre rot, FWHM rot, amplitude at
    ref_mhz, spectral index] as Gaussians on the bin centres, each
    centred on its nearest turn."""
    x = (torch.arange(nbin, dtype=torch.float64, device=nu.device) + 0.5) \
        / nbin
    r = nu[:, None] / config["template"]["ref_mhz"]
    out = torch.zeros((len(nu), nbin), dtype=torch.float64, device=nu.device)
    for c, fwhm, amp, index in config["template"]["components"]:
        z = torch.remainder(x - c + 0.5, 1.0) - 0.5
        out += amp * torch.exp(-0.5 * (z / (fwhm / FWHM)) ** 2)[None, :] * \
            r ** index
    return out


def gmodel_text(config):
    """The template as a .gmodel file: code 000 (power laws), the
    components' (centre, 0, FWHM, 0, amplitude, index), no scattering."""
    t = config["template"]
    lines = ["MODEL   portbench", "CODE    000",
             "FREQ    %.5f" % t["ref_mhz"], "DC      0.00000000 0",
             "TAU     0.00000000 0", "ALPHA  -4.000      0"]
    for i, (c, fwhm, amp, index) in enumerate(t["components"]):
        lines.append("COMP%02d % .8f 0  % .8f 0  % .8f 0  % .8f 0  % .8f 0"
                     "  % .8f 0" % (i + 1, c, 0.0, fwhm, 0.0, amp, index))
    return "\n".join(lines) + "\n"


def _card(key, value):
    if isinstance(value, bool):
        v = "T" if value else "F"
    elif isinstance(value, (int, np.integer)):
        v = "%d" % value
    elif isinstance(value, (float, np.floating)):
        v = repr(float(value))
    else:
        s = "'%-8s'" % str(value).replace("'", "''")
        return ("%-8s= %s" % (key, s))[:CARD].ljust(CARD)
    return ("%-8s= %20s" % (key, v))[:CARD].ljust(CARD)


def _header(cards):
    buf = "".join(_card(k, v) for k, v in cards) + "END".ljust(CARD)
    return buf.encode("ascii") + b" " * ((-len(buf)) % BLOCK)


def _table(name, columns, extra):
    """A BINTABLE HDU's bytes: columns [(name, big-endian dtype, repeat,
    (nrow, repeat) array)]."""
    nrow = len(columns[0][3])
    dt = np.dtype([(n, t, (r,)) for n, t, r, _ in columns])
    rows = np.empty(nrow, dt)
    for n, _, r, a in columns:
        rows[n] = np.asarray(a).reshape(nrow, r)
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", dt.itemsize), ("NAXIS2", nrow), ("PCOUNT", 0),
             ("GCOUNT", 1), ("TFIELDS", len(columns))]
    code = {">f8": "D", ">f4": "E", ">i2": "I", "S1": "A"}
    for i, (n, t, r, _) in enumerate(columns):
        cards += [("TTYPE%d" % (i + 1), n),
                  ("TFORM%d" % (i + 1), "%d%s" % (r, code[t]))]
    cards += [("EXTNAME", name)] + extra
    data = rows.tobytes()
    return _header(cards) + data + b"\0" * ((-len(data)) % BLOCK)


def write_archive(path, a):
    """Writes one archive (a dict as Pool.archive gives it) as PSRFITS."""
    nsub, nchan, nbin = a["raw"].shape
    primary = _header([
        ("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True),
        ("FITSTYPE", "PSRFITS"), ("OBS_MODE", "PSR"),
        ("SRC_NAME", a["source"]), ("TELESCOP", a["telescope"]),
        ("FRONTEND", a["frontend"]), ("BACKEND", a["backend"]),
        ("BE_DELAY", float(a["backend_delay"])),
        ("OBSFREQ", float(a["obsfreq"])), ("OBSBW", float(a["obsbw"])),
        ("OBSNCHAN", nchan), ("STT_IMJD", int(a["imjd"])),
        ("STT_SMJD", int(a["smjd"])), ("STT_OFFS", float(a["soffs"]))])
    par = np.array([ln.ljust(60).encode("ascii") for ln in a["par"]])
    psrparam = _table("PSRPARAM", [("PARAM", "S1", 60,
                                    par.view("S1").reshape(len(par), 60))],
                      [])
    f4 = lambda v: np.broadcast_to(np.asarray(v, np.float32), (nsub, nchan))
    subint = _table("SUBINT", [
        ("TSUBINT", ">f8", 1, np.full(nsub, a["tsub"])),
        ("OFFS_SUB", ">f8", 1, a["offs_sub"]),
        ("PERIOD", ">f8", 1, np.full(nsub, a["period"])),
        ("DOPPLER", ">f8", 1, a["doppler"]),
        ("DAT_FREQ", ">f4", nchan, f4(a["freqs"])),
        ("DAT_WTS", ">f4", nchan, f4(1.0)),
        ("DAT_OFFS", ">f4", nchan, a["offs"]),
        ("DAT_SCL", ">f4", nchan, a["scl"]),
        ("DATA", ">i2", nchan * nbin, a["raw"].reshape(nsub, -1))],
        [("INT_TYPE", "TIME"), ("POL_TYPE", "AA+BB"), ("NPOL", 1),
         ("NBIN", nbin), ("NCHAN", nchan), ("NSBLK", 1),
         ("DM", float(a["dm"])), ("DEDISP", False),
         ("TBIN", float(a["period"]) / nbin), ("EPOCHS", "MIDTIME")])
    with open(path, "wb") as f:
        f.write(primary + psrparam + subint)
        # on disk before the window opens: no write-back of the pool
        # inside it
        f.flush()
        os.fsync(f.fileno())


def _uniform(gen, n, lo, hi, device, log=False):
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    if log:
        return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    return lo + u * (hi - lo)


class Pool:
    """The traffic's archives: narch = pool x archives_per_call, each of
    `subints` subints.

    raw (narch, nsub, nchan, nbin) int16, scl and offs (narch, nsub,
    nchan) float32: the samples as stored, on the device; truth (narch,
    nsub, 2) float64: the injected phase [rot] at the band mean nu_a and
    the DM's offset from the header's DM; doppler (narch, nsub) float64;
    nu (nchan,) float64.  The data are the template, dispersed at the
    header DM plus the offset about nu_a and turned by the phase, times
    an amplitude, plus white noise, then quantized channel by channel."""

    def __init__(self, config, mix, seed, device):
        narch = mix["pool"] * mix["archives_per_call"]
        nsub, C, N = mix["subints"], config["nchan"], config["nbin"]
        P, dm0 = config["period_s"], config["dm"]
        self.config, self.narch, self.nsub = config, narch, nsub
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.nu = nu = freqs(config, device)
        self.nu_a = float(nu.mean())
        n = narch * nsub
        phi = _uniform(gen, n, *mix["phi_rot"], device)
        ddm = _uniform(gen, n, *mix["ddm"], device)
        amp = _uniform(gen, n, *mix["amp"], device, log=True)
        self.doppler = (1.0 + _uniform(gen, n, *mix["doppler_offset"],
                                       device)).view(narch, nsub)
        self.truth = torch.stack([phi, ddm], -1).view(narch, nsub, 2)
        kdm = config["dispersion_constant"] / P
        mft = torch.fft.rfft(template(config, nu, N), dim=-1)
        k = torch.arange(N // 2 + 1, dtype=torch.float64, device=device)
        self.raw = torch.empty((narch, nsub, C, N), dtype=torch.int16,
                               device=device)
        self.scl = torch.empty((narch, nsub, C), dtype=torch.float32,
                               device=device)
        self.offs = torch.empty_like(self.scl)
        rf, sf, of = (t.view(n, *t.shape[2:])
                      for t in (self.raw, self.scl, self.offs))
        step = 8 * max(1, 4096 // C)
        for i in range(0, n, step):
            j = slice(i, min(i + step, n))
            shift = phi[j, None] + kdm * (dm0 + ddm[j, None]) * (
                nu ** -2.0 - self.nu_a ** -2.0)
            ang = torch.remainder(shift[..., None] * k, 1.0) * (-2 * math.pi)
            spec = mft * torch.polar(amp[j, None, None].expand_as(ang), ang)
            d = torch.fft.irfft(spec, n=N, dim=-1)
            d += config["noise"] * torch.randn(d.shape, generator=gen,
                                               dtype=torch.float64,
                                               device=device)
            hi, lo = d.amax(-1), d.amin(-1)
            s = ((hi - lo) / (2 * I16_MAX)).float()
            o = (0.5 * (hi + lo)).float()
            sf[j], of[j] = s, o
            q = torch.round((d - o.double()[..., None]) /
                            s.double()[..., None])
            rf[j] = q.clamp(-I16_MAX, I16_MAX).to(torch.int16)

    def archive(self, ia):
        """Archive ia as write_archive takes it (host arrays)."""
        cfg, nsub = self.config, self.nsub
        tsub = cfg["subint_s"]
        return dict(
            raw=self.raw[ia].cpu().numpy(), scl=self.scl[ia].cpu().numpy(),
            offs=self.offs[ia].cpu().numpy(),
            freqs=self.nu.cpu().numpy(), doppler=self.doppler[ia].cpu()
            .numpy(), offs_sub=(np.arange(nsub) + 0.5) * tsub, tsub=tsub,
            period=cfg["period_s"], dm=cfg["dm"], imjd=cfg["start_mjd"] + ia,
            smjd=0, soffs=0.0, backend_delay=cfg["backend_delay_s"],
            obsfreq=0.5 * (cfg["freq_lo_mhz"] + cfg["freq_hi_mhz"]),
            obsbw=cfg["freq_hi_mhz"] - cfg["freq_lo_mhz"],
            source=cfg["psr"], telescope=cfg["telescope"],
            frontend=cfg["frontend"], backend=cfg["backend"],
            par=cfg["par"])

    def epoch(self, ia, isub):
        """(MJD day, seconds of the day) of subint isub of archive ia."""
        return (self.config["start_mjd"] + ia,
                (isub + 0.5) * self.config["subint_s"])

    def write(self, directory, config):
        """Writes every archive and the template's .gmodel under
        directory; returns ([archive paths], gmodel path)."""
        os.makedirs(directory, exist_ok=True)
        paths = []
        for ia in range(self.narch):
            p = os.path.join(directory, "a%02d.fits" % ia)
            write_archive(p, self.archive(ia))
            paths.append(p)
        gm = os.path.join(directory, "template.gmodel")
        with open(gm, "w") as f:
            f.write(gmodel_text(config))
        return paths, gm
