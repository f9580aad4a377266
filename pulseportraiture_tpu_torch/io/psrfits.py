"""PSRFITS-subset archive container and file format.

The Archive dataclass is the in-memory representation (the role PSRCHIVE's
Archive plays at the reference's native boundary, pplib.py:2650-2814).
On disk it is a real FITS file: a PSRFITS-style primary header, a PSRPARAM
text table holding the ephemeris, and a SUBINT binary table with
TSUBINT/OFFS_SUB/PERIOD/DAT_FREQ/DAT_WTS/DAT_OFFS/DAT_SCL/DATA columns.

Deviations from full PSRFITS, chosen deliberately (documented for parity
review):
  * folding periods are stored in a PERIOD column (a linear F0/F1 spin
    model fills it at write time) instead of a POLYCO table;
  * DATA defaults to float32 ('E'); 16-bit quantized storage with
    per-channel DAT_SCL/DAT_OFFS is supported via dtype='i2' and matches
    standard PSRFITS semantics (value = DAT_SCL*raw + DAT_OFFS).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from pulseportraiture_tpu_torch.io import fits
from pulseportraiture_tpu_torch.io.mjd import MJD

_tls = threading.local()


def _scratch(shape, dtype, tag):
    """Thread-local reusable work buffer (see remove_baseline).

    Buffers are transient within one call — nothing returned to a caller
    may alias them.  Keyed per tag so concurrent uses inside a call stay
    distinct; replaced when the requested shape grows.
    """
    buf = getattr(_tls, tag, None)
    n = int(np.prod(shape))
    if buf is None or buf.dtype != np.dtype(dtype) or buf.size < n:
        buf = np.empty(n, dtype)
        setattr(_tls, tag, buf)
    return buf[:n].reshape(shape)


def baseline_window(nbin, frac=0.15):
    """The samples of Archive.remove_baseline's window: frac of nbin, at
    least one."""
    return max(1, int(frac * nbin))


@dataclasses.dataclass
class Archive:
    """In-memory folded archive: (nsub, npol, nchan, nbin) amplitudes."""

    data: np.ndarray              # float (nsub, npol, nchan, nbin)
    freqs: np.ndarray             # (nsub, nchan) channel centers [MHz]
    weights: np.ndarray           # (nsub, nchan)
    Ps: np.ndarray                # (nsub,) folding periods [sec]
    epochs: List[MJD]             # (nsub,) mid-subint epochs
    subtimes: np.ndarray          # (nsub,) subint durations [sec]
    DM: float = 0.0
    dedispersed: bool = False     # dmc flag: True = stored dedispersed
    nu0: float = 0.0              # center frequency [MHz]
    bw: float = 0.0               # bandwidth [MHz]
    source: str = ""
    telescope: str = ""
    frontend: str = ""
    backend: str = ""
    backend_delay: float = 0.0
    state: str = "Intensity"      # 'Intensity', 'Stokes', 'Coherence'
    ephemeris_lines: Optional[List[str]] = None
    doppler_factors: Optional[np.ndarray] = None   # (nsub,)
    # int16-native ingest (files quantized as i2): the raw samples,
    # per-channel DAT_SCL and DAT_OFFS, as stored.  value = scl*raw + offs;
    # the fit takes raw and scl only — offsets feed the DC harmonic, which
    # it discards under F0_FACT zeroing; load_data's statistics from the
    # raw samples add them back to the baseline.  These reflect the FILE
    # contents:
    # any transform that rewrites self.data (rotation, scrunching,
    # state conversion) makes them stale — load_data only forwards
    # them when no such transform ran (io/archive.py).
    raw_i2: Optional[np.ndarray] = None    # (nsub, npol, nchan, nbin) i2
    raw_scl: Optional[np.ndarray] = None   # (nsub, npol, nchan) f4
    raw_offs: Optional[np.ndarray] = None  # (nsub, npol, nchan) f4

    @property
    def nsub(self):
        return self.data.shape[0]

    @property
    def npol(self):
        return self.data.shape[1]

    @property
    def nchan(self):
        return self.data.shape[2]

    @property
    def nbin(self):
        return self.data.shape[3]

    def copy(self):
        return dataclasses.replace(
            self, data=self.data.copy(), freqs=self.freqs.copy(),
            weights=self.weights.copy(), Ps=self.Ps.copy(),
            epochs=list(self.epochs), subtimes=self.subtimes.copy(),
            doppler_factors=None if self.doppler_factors is None
            else self.doppler_factors.copy())

    # -- dedispersion state management (PSRCHIVE dedisperse/dededisperse) --

    def _rotate_dm(self, sign):
        # host float64 rotation (mirrors ops.rotate.rotate_data): archive
        # loading must not bounce off the accelerator — on remote-TPU
        # backends every device call costs a ~30-50 ms round trip, and
        # f64 keeps the many-turn dispersion phases exact
        from pulseportraiture_tpu_torch.config import DCONST
        d = np.asarray(self.data, dtype=np.float64)
        nsub, npol, nchan, nbin = d.shape
        F = np.fft.rfft(d, axis=-1)
        k = np.arange(F.shape[-1])
        freqs = np.asarray(self.freqs, dtype=np.float64)
        if freqs.ndim == 1:
            freqs = np.broadcast_to(freqs, (nsub, nchan))
        D = DCONST * (sign * self.DM) / np.asarray(self.Ps,
                                                   dtype=np.float64)
        inv2 = np.where(np.isinf(freqs), 0.0, freqs) ** -2.0
        inv2 = np.where(np.isinf(freqs), 0.0, inv2)
        ref2 = 0.0 if np.isinf(self.nu0) else float(self.nu0) ** -2.0
        phis = D[:, None] * (inv2 - ref2)           # (nsub, nchan)
        # Many-turn dispersion phases (phi*k up to ~1e5 turns at DM~35)
        # hit glibc trig's slow large-argument reduction (~20x); reduce
        # mod 1 turn in f64 first (error <= k*eps ~ 1e-11 turns at
        # k=1024, far inside the 1e-9 phase budget), then cos/sin the
        # small angle directly into the complex ramp's views.
        theta = np.mod(phis[:, None, :, None] * k, 1.0)
        theta *= 2.0 * np.pi
        ramp = np.empty(np.broadcast_shapes(theta.shape, F.shape),
                        np.complex128)
        np.cos(theta, out=ramp.real)
        np.sin(theta, out=ramp.imag)
        F *= ramp
        self.data = np.fft.irfft(F, n=nbin, axis=-1)

    def dedisperse(self):
        if not self.dedispersed and self.DM != 0.0:
            self._rotate_dm(+1.0)
        self.dedispersed = True

    def dededisperse(self):
        if self.dedispersed and self.DM != 0.0:
            self._rotate_dm(-1.0)
        self.dedispersed = False

    # -- scrunching --

    def tscrunch(self):
        w = self.weights[:, None, :, None]
        wsum = self.weights.sum(0)
        num = (self.data * w).sum(0, keepdims=True)
        den = np.where(wsum > 0, wsum, 1.0)[None, None, :, None]
        self.data = num / den
        self.freqs = self.freqs.mean(0, keepdims=True)
        mid = self.epochs[0].add_seconds(0.5 * (self.epochs[-1] -
                                                self.epochs[0]))
        self.epochs = [mid]
        self.Ps = np.array([self.Ps.mean()])
        self.subtimes = np.array([self.subtimes.sum()])
        self.weights = self.weights.sum(0, keepdims=True)
        if self.doppler_factors is not None:
            self.doppler_factors = np.array([self.doppler_factors.mean()])

    def convert_state(self, state):
        """Convert between 'Coherence' (AA,BB,CR,CI) and 'Stokes'
        (I,Q,U,V) polarization bases (PSRCHIVE convert_state; the
        reference calls it at load, pplib.py:2681-2684)."""
        if state == self.state or self.npol != 4:
            self.state = state if self.npol == 1 else self.state
            return
        d = self.data
        if self.state == "Coherence" and state == "Stokes":
            aa, bb, cr, ci = d[:, 0], d[:, 1], d[:, 2], d[:, 3]
            self.data = np.stack([aa + bb, aa - bb, 2.0 * cr, 2.0 * ci],
                                 axis=1)
        elif self.state == "Stokes" and state == "Coherence":
            i, q, u, v = d[:, 0], d[:, 1], d[:, 2], d[:, 3]
            self.data = np.stack([0.5 * (i + q), 0.5 * (i - q),
                                  0.5 * u, 0.5 * v], axis=1)
        else:
            raise ValueError(
                f"cannot convert {self.state!r} -> {state!r}")
        self.state = state

    def pscrunch(self):
        if self.npol > 1:
            if self.state == "Coherence":
                # total intensity = AA + BB
                self.data = (self.data[:, 0] + self.data[:, 1])[:, None]
            else:  # Stokes: I is the first pol
                self.data = self.data[:, :1]
        self.state = "Intensity"

    def fscrunch(self):
        w = self.weights[:, None, :, None]
        wsum = np.where(self.weights.sum(1) > 0, self.weights.sum(1), 1.0)
        self.data = (self.data * w).sum(2, keepdims=True) / \
            wsum[:, None, None, None]
        self.freqs = self.freqs.mean(1, keepdims=True)
        self.weights = self.weights.sum(1, keepdims=True)

    def remove_baseline(self, frac=0.15):
        """Subtract the off-pulse baseline per profile, in place.

        PSRCHIVE-style windowed minimum: the baseline is the mean over the
        duty-cycle window (width frac*nbin) with the lowest smoothed mean
        (cf. reference reliance on arch.remove_baseline(), pplib.py:2690).
        The window search runs in float32 (the estimate's accuracy is set
        by noise/sqrt(wlen), far above f32 rounding) through thread-local
        scratch buffers: campaign loads call this once per archive, and
        fresh multi-10-MB allocations per call dominated the host cost
        via soft page faults.  Window selection argmins the *unscaled*
        smoothed window sums (dividing by wlen cannot change the argmin
        but, in f32, used to merge sub-ulp near-ties; selection may
        differ from pre-round-3 builds by one window among candidates
        equal to <=1 ulp — far below the estimator's own noise).
        """
        nbin = self.nbin
        wlen = baseline_window(nbin, frac)
        d = self.data
        d2 = np.asarray(d, dtype=np.float32).reshape(-1, nbin)
        nprof = d2.shape[0]
        ext = nbin + wlen
        A = _scratch((nprof, ext), np.float32, "blA")
        W = _scratch((nprof, nbin), np.float32, "blW")
        # wrapped window sums via one padded in-place cumsum
        A[:, :nbin] = d2
        A[:, nbin:] = d2[:, :wlen]
        np.cumsum(A, axis=-1, out=A)
        np.subtract(A[:, wlen:], A[:, :-wlen], out=W)
        np.divide(W, np.float32(wlen), out=W)
        # select the window on a further-smoothed curve (PSRCHIVE smooths
        # before taking the minimum): choosing the raw minimum of noisy
        # window means biases the baseline low by ~sqrt(2 ln n)/sqrt(wlen)
        # sigma; double smoothing cuts that ~4x while the subtracted value
        # stays the unsmoothed window mean.
        A[:, :nbin] = W
        A[:, nbin:] = W[:, :wlen]
        np.cumsum(A, axis=-1, out=A)
        sel = _scratch((nprof, nbin), np.float32, "blS")
        np.subtract(A[:, wlen:], A[:, :-wlen], out=sel)
        imin = np.argmin(sel, axis=-1)
        base = W[np.arange(nprof), imin]
        if not d.flags.writeable:
            d = self.data = d.copy()
        d -= base.astype(d.dtype).reshape(d.shape[:-1] + (1,))


def write_psrfits(path, arch: Archive, dtype="f4", quiet=True):
    """Write an Archive to a PSRFITS-subset file."""
    nsub, npol, nchan, nbin = arch.data.shape
    ep0 = arch.epochs[0]
    start = ep0.add_seconds(-0.5 * float(arch.subtimes[0]))
    primary = fits.HDU(header={
        "FITSTYPE": "PSRFITS", "OBS_MODE": "PSR",
        "SRC_NAME": arch.source, "TELESCOP": arch.telescope,
        "FRONTEND": arch.frontend, "BACKEND": arch.backend,
        "BE_DELAY": float(arch.backend_delay),
        "OBSFREQ": float(arch.nu0), "OBSBW": float(arch.bw),
        "OBSNCHAN": nchan,
        "STT_IMJD": start.intday(), "STT_SMJD": start.secs,
        "STT_OFFS": start.frac,
    }, name="PRIMARY")

    hdus = [primary]
    if arch.ephemeris_lines:
        lines = [ln.rstrip("\n") for ln in arch.ephemeris_lines]
        width = max(60, max(len(ln) for ln in lines) if lines else 60)
        param = fits.HDU(columns={
            "PARAM": np.asarray(lines, dtype=f"S{width}")},
            name="PSRPARAM")
        hdus.append(param)

    offs_sub = np.array([arch.epochs[i] - start for i in range(nsub)])
    dat_freq = np.asarray(arch.freqs, dtype="f4")
    dat_wts = np.asarray(arch.weights, dtype="f4")
    flat = arch.data.reshape(nsub, npol * nchan, nbin)
    if dtype == "i2":
        from pulseportraiture_tpu_torch.io import native
        raw, scl, offs = native.quantize_i2(flat)
        data_col = raw.reshape(nsub, -1)
    else:
        offs = np.zeros((nsub, npol * nchan))
        scl = np.ones((nsub, npol * nchan))
        data_col = flat.reshape(nsub, -1).astype("f4")
    subint = fits.HDU(columns={
        "TSUBINT": np.asarray(arch.subtimes, dtype="f8"),
        "OFFS_SUB": offs_sub.astype("f8"),
        "PERIOD": np.asarray(arch.Ps, dtype="f8"),
        "DOPPLER": np.asarray(arch.doppler_factors
                              if arch.doppler_factors is not None
                              else np.ones(nsub), dtype="f8"),
        "DAT_FREQ": dat_freq,
        "DAT_WTS": dat_wts,
        "DAT_OFFS": offs.astype("f4"),
        "DAT_SCL": scl.astype("f4"),
        "DATA": data_col,
    }, header={
        "INT_TYPE": "TIME", "POL_TYPE": _pol_type(arch.state, npol),
        "NPOL": npol, "NBIN": nbin, "NCHAN": nchan, "NSBLK": 1,
        "DM": float(arch.DM), "DEDISP": bool(arch.dedispersed),
        "TBIN": float(arch.Ps[0]) / nbin, "EPOCHS": "MIDTIME",
    }, name="SUBINT")
    hdus.append(subint)
    fits.write_fits(path, hdus)
    if not quiet:
        print(f"\nUnloaded {path}.\n")


def _pol_type(state, npol):
    if npol == 1:
        return "AA+BB"
    return "IQUV" if state == "Stokes" else "AABBCRCI"


def read_psrfits(path) -> Archive:
    """Read a PSRFITS-subset file into an Archive."""
    hdus = fits.read_fits(path)
    primary = hdus[0]
    by_name = {h.name: h for h in hdus}
    sub = by_name["SUBINT"]
    h = sub.header
    nsub = len(sub.columns["TSUBINT"])
    npol, nchan, nbin = h["NPOL"], h["NCHAN"], h["NBIN"]
    raw = sub.columns["DATA"].reshape(nsub, npol * nchan, nbin)
    scl = np.asarray(sub.columns["DAT_SCL"], dtype="f8").reshape(
        nsub, npol * nchan)
    offs = np.asarray(sub.columns["DAT_OFFS"], dtype="f8").reshape(
        nsub, npol * nchan)
    raw_i2 = raw_scl = raw_offs = None
    # data stays at its native storage width: i2/f4 columns carry f32
    # information, so the in-memory cube is f32 (halves every host pass
    # on campaign loads; consumers that need f64 math upcast at the
    # point of use).  A genuine f8 DATA column keeps f8.
    if raw.dtype == np.int16:
        from pulseportraiture_tpu_torch.io import native
        raw_i2 = raw.reshape(nsub, npol, nchan, nbin)
        raw_scl = scl.astype("f4").reshape(nsub, npol, nchan)
        raw_offs = offs.astype("f4").reshape(nsub, npol, nchan)
        data = native.dequantize_i2(
            raw, scl.astype("f4"), offs.astype("f4")).reshape(
            nsub, npol, nchan, nbin)
    else:
        out_dt = "f8" if raw.dtype == np.float64 else "f4"
        data = (raw.astype(out_dt) * scl.astype(out_dt)[..., None] +
                offs.astype(out_dt)[..., None]).reshape(
            nsub, npol, nchan, nbin)
    start = MJD(primary.header["STT_IMJD"], primary.header["STT_SMJD"],
                primary.header["STT_OFFS"])
    epochs = [start.add_seconds(float(o)) for o in sub.columns["OFFS_SUB"]]
    eph = None
    if "PSRPARAM" in by_name:
        eph = [p.decode("ascii").rstrip() for p in
               by_name["PSRPARAM"].columns["PARAM"]]
    freqs = np.atleast_2d(np.asarray(sub.columns["DAT_FREQ"], dtype="f8"))
    weights = np.atleast_2d(np.asarray(sub.columns["DAT_WTS"], dtype="f8"))
    if freqs.shape[0] == 1 and nsub > 1:
        freqs = np.broadcast_to(freqs, (nsub, nchan)).copy()
    if weights.shape[0] == 1 and nsub > 1:
        weights = np.broadcast_to(weights, (nsub, nchan)).copy()
    dop = sub.columns.get("DOPPLER")
    # PERIOD is this framework's column; real PSRCHIVE archives store
    # the phase model in a POLYCO or T2PREDICT table (reference
    # pplib.py:3165, periods read via the predictor at pplib.py:2732).
    # Fall back to F0/F1 from PSRPARAM evaluated at each subint epoch.
    mjds = [e.in_days() for e in epochs]
    if "PERIOD" in sub.columns:
        Ps = np.asarray(sub.columns["PERIOD"], dtype="f8")
    elif "POLYCO" in by_name:
        from pulseportraiture_tpu_torch.io.predictor import polyco_periods
        Ps = polyco_periods(by_name["POLYCO"].columns, mjds)
    elif "T2PREDICT" in by_name:
        from pulseportraiture_tpu_torch.io.predictor import t2predict_periods
        lines = [p.decode("ascii").rstrip() for p in
                 by_name["T2PREDICT"].columns["PREDICT"]]
        Ps = t2predict_periods(
            lines, mjds, float(primary.header.get("OBSFREQ", 0.0)))
    elif eph is not None:
        from pulseportraiture_tpu_torch.io.par import parse_par, period_at
        par = parse_par(eph)
        Ps = np.array([period_at(par, m) for m in mjds])
    else:
        raise ValueError(f"{path}: no PERIOD column, no POLYCO/T2PREDICT "
                         "table, and no PSRPARAM ephemeris to derive "
                         "folding periods from")
    state = {"AA+BB": "Intensity", "INTEN": "Intensity",
             "IQUV": "Stokes"}.get(str(h.get("POL_TYPE", "AA+BB")).strip(),
                                   "Coherence")
    if npol == 1:
        state = "Intensity"
    # DM / dedispersion state: this framework and PSRFITS v3+ keep DM in
    # the SUBINT header; older PSRCHIVE files record processing state in
    # the HISTORY table's last row (DEDISP flag, CHAN_DM-style DM).
    DM = h.get("DM")
    dedispersed = h.get("DEDISP")
    if "HISTORY" in by_name:
        hist = by_name["HISTORY"].columns
        if dedispersed is None and "DEDISP" in hist:
            dedispersed = bool(np.asarray(hist["DEDISP"])[-1])
        if DM is None and "CHAN_DM" in hist:
            DM = float(np.asarray(hist["CHAN_DM"])[-1])
    if DM is None and eph is not None:
        from pulseportraiture_tpu_torch.io.par import parse_par
        DM = parse_par(eph).DM
    return Archive(
        data=data, freqs=freqs, weights=weights,
        Ps=Ps,
        epochs=epochs,
        subtimes=np.asarray(sub.columns["TSUBINT"], dtype="f8"),
        DM=float(DM if DM is not None else 0.0),
        dedispersed=bool(dedispersed if dedispersed is not None else False),
        nu0=float(primary.header.get("OBSFREQ", 0.0)),
        bw=float(primary.header.get("OBSBW", 0.0)),
        source=str(primary.header.get("SRC_NAME", "")),
        telescope=str(primary.header.get("TELESCOP", "")),
        frontend=str(primary.header.get("FRONTEND", "")),
        backend=str(primary.header.get("BACKEND", "")),
        backend_delay=float(primary.header.get("BE_DELAY", 0.0)),
        state=state, ephemeris_lines=eph,
        doppler_factors=None if dop is None else np.asarray(dop, dtype="f8"),
        raw_i2=raw_i2, raw_scl=raw_scl, raw_offs=raw_offs)
