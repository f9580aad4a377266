"""The pipeline's template, from its file to the fits' device copies.

ModelSource reads a FITS archive, a spline model (.spl) or a Gaussian
model (.gmodel) and evaluates it at a subint's grid.  Templates prepares
it for one get_TOAs call: the evaluation, given the instrumental response
when asked for, dispersed by the archive's DM0 about the band's mean on
the host in float64 (the fit solves a small residual dDM around DM0),
cast to the fit dtype, its spectrum split and band-capped for float32
fits.  A Template holds that, its device copies and the frame's inverse.
Reference: pptoas.py:320-375.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pulseportraiture_tpu_torch.config import DCONST
from pulseportraiture_tpu_torch.fitters.portrait import template_spectrum
from pulseportraiture_tpu_torch.ops.gaussian import \
    instrumental_response_port_FT
from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait_np
from pulseportraiture_tpu_torch.ops.setup_dft import (band_cap_model_ft,
                                                      cap_nharm)
from pulseportraiture_tpu_torch.profiling import annotate

_MAX_EVALS = 64        # evaluations kept at once
_MAX_PREPARED = 8      # prepared templates kept at once, with device copies


def _cached(cache, limit, key, make):
    """cache[key], made at a miss.  Past limit entries the cache restarts:
    campaigns share one grid, and differing periods or grids would
    otherwise grow it without bound (holders keep what they took)."""
    if key not in cache:
        if len(cache) > limit:
            cache.clear()
        cache[key] = make()
    return cache[key]


def fit_spectrum(model_rot, nbin, f32):
    """The template's split spectrum for a fit, (mr, mi, mharm): the host
    float64 rfft, and for float32 fits the model-band harmonic cap (a
    cleaning floor below the float32 noise, not below float64's, so
    float64 fits keep the band).  mharm is None where no cap applies."""
    mr, mi = template_spectrum(model_rot)
    mharm = None
    if f32:
        mr_c, mi_c, mharm = band_cap_model_ft(mr, mi, nbin)
        if mharm is not None:
            nh = cap_nharm(nbin, mharm)
            mr, mi = mr_c[:, :nh], mi_c[:, :nh]
    return mr, mi, mharm


class ModelSource:
    """Evaluate the template portrait at a subint's (freqs, P, nbin)."""

    def __init__(self, modelfile):
        self.modelfile = modelfile
        self._cache = {}
        with open(modelfile, "rb") as f:
            magic = f.read(6)
        if magic == b"SIMPLE":
            from pulseportraiture_tpu_torch.io.psrfits import read_psrfits
            self.kind, self.payload = "fits", read_psrfits(modelfile)
        elif magic[:2] in (b"\x80\x02", b"\x80\x03", b"\x80\x04", b"(l") \
                or str(modelfile).endswith((".spl", ".npz")):
            from pulseportraiture_tpu_torch.models.spline_io import \
                read_spline_model
            self.kind, self.payload = "spline", read_spline_model(
                modelfile, quiet=True)
        else:
            from pulseportraiture_tpu_torch.models.gmodel_io import \
                read_model
            self.kind, self.payload = "gauss", read_model(modelfile,
                                                          quiet=True)

    def eval(self, phases, freqs, P, unscat=False):
        """Template portrait (nchan, nbin) at the given grid.

        unscat=True evaluates a Gaussian model with its own scattering
        zeroed: required when the fit measures tau itself, or the kernel
        would be applied twice (pptoas.py:365-375).  Evaluations are
        cached: subints usually share the frequency grid, and only a
        scattered Gaussian model depends on P at all.
        """
        nbin = len(phases)
        p_sensitive = (self.kind == "gauss" and self.payload[4][1] != 0
                       and not unscat)
        key = (np.asarray(freqs).tobytes(), nbin, bool(unscat),
               round(float(P), 12) if p_sensitive else None)
        return _cached(self._cache, _MAX_EVALS, key,
                       lambda: self._eval(phases, freqs, P, unscat))

    def _eval(self, phases, freqs, P, unscat):
        nbin = len(phases)
        if self.kind == "gauss":
            from pulseportraiture_tpu_torch.models.gaussian import \
                gen_gaussian_portrait
            (_, model_code, nu_ref, _, params, _, alpha, _) = self.payload
            p = np.array(params)
            if unscat:
                p[1] = 0.0
            elif p[1] != 0:
                p[1] *= nbin / P           # seconds -> bins
            return gen_gaussian_portrait(model_code, p, alpha, phases, freqs,
                                         nu_ref).numpy()
        if self.kind == "spline":
            from pulseportraiture_tpu_torch.models.spline import \
                gen_spline_portrait
            mean_prof, eigvec, tck = self.payload[3:]
            return gen_spline_portrait(
                mean_prof, freqs, eigvec, tck,
                nbin if nbin != len(mean_prof) else None,
                device="cpu").numpy()
        # FITS archive template: t/p-scrunched, baseline removed,
        # nearest-frequency channel matching (pptoas.py:320-339)
        arch = self.payload.copy()
        arch.tscrunch()
        arch.pscrunch()
        arch.remove_baseline()
        tmpl = arch.data[0, 0]
        if tmpl.shape[-1] != nbin:
            raise ValueError("Model template nbin mismatch")
        return tmpl[np.abs(np.asarray(freqs)[:, None] -
                           arch.freqs[0]).argmin(-1)]


@dataclass(frozen=True, eq=False)
class Template:
    """A template prepared for one subint grid, hashed by identity (the
    batch buffers key on it).  The scattering kernel's DC term is 1, so
    chan_means, model.mean(-1), are also the channel means of the
    template scattered by any fitted tau."""

    model: np.ndarray        # (nchan, nbin), DM0-rotated, the fit dtype
    mr: np.ndarray           # the split spectrum (nchan, nh), capped
    mi: np.ndarray
    mharm: int | None        # the band cap; None where none applies
    nu_anchor: float         # the rotation's reference frequency [MHz]
    P_model: float           # the period it was rotated at [s]
    DM0: float
    dtype: torch.dtype
    chan_means: np.ndarray
    _dev: dict = field(default_factory=dict, repr=False)

    def mean_profile(self, okc):
        return self.model[okc].mean(0)

    def on(self, devices):
        """The spectrum {device: (mr, mi)} on each of devices, uploaded
        once a device."""
        for d in devices:
            if d not in self._dev:
                self._dev[d] = tuple(
                    torch.as_tensor(np.asarray(a), dtype=self.dtype, device=d)
                    for a in (self.mr, self.mi))
        return {d: self._dev[d] for d in devices}

    def restore(self, phi, DM, nu_DM, P):
        """A fit's (phi, DM) at nu_DM and the subint's P taken out of this
        template's frame (host float64): the TOA phase in [-0.5, 0.5) and
        the DM with its base restored."""
        base_shift = DCONST * self.DM0 / self.P_model * (
            float(nu_DM) ** -2.0 - self.nu_anchor ** -2.0)
        return ((float(phi) + base_shift + 0.5) % 1.0 - 0.5,
                self.DM0 * (P / self.P_model) + float(DM))


class Templates:
    """The prepared templates of one get_TOAs call, keyed by (grid, P to 6
    significant digits, DM0): spin-down drift does not fork a campaign's
    shared template, and restore undoes the P mismatch exactly.  unscat
    as ModelSource.eval's; ird: GetTOAs.ird to convolve with, or None."""

    def __init__(self, source, dtype, unscat=False, ird=None):
        self.source, self.dtype, self.unscat, self.ird = \
            source, dtype, unscat, ird
        self._cache = {}

    @property
    def mharms(self):
        return sorted({t.mharm or 0 for t in self._cache.values()})

    def get(self, data, isub, DM0):
        """The Template for data's subint isub, at the archive's DM0."""
        P, freqs = float(data.Ps[isub]), data.freqs[isub]
        key = (freqs.tobytes(),
               float(np.format_float_scientific(P, precision=5)), float(DM0))
        return _cached(self._cache, _MAX_PREPARED, key,
                       lambda: self._prepare(data, freqs, P, DM0))

    def _prepare(self, data, freqs, P, DM0):
        with annotate("pp:load.template"):
            model = self.source.eval(data.phases, freqs, P,
                                     unscat=self.unscat)
            ird = self.ird
            if ird is not None and (ird["DM"] or len(ird["wids"])):
                irf = instrumental_response_port_FT(
                    data.nbin, freqs, ird["DM"], P, ird["wids"],
                    ird["irf_types"])
                model = np.fft.irfft(
                    irf * np.fft.rfft(model, axis=-1), n=data.nbin, axis=-1)
            f32 = self.dtype == torch.float32
            nu_anchor = float(freqs.mean())
            model_rot = np.asarray(rotate_portrait_np(
                model, 0.0, -DM0, P, freqs, nu_anchor),
                np.float32 if f32 else np.float64)
            mr, mi, mharm = fit_spectrum(model_rot, data.nbin, f32)
            return Template(model_rot, mr, mi, mharm, nu_anchor, P, DM0,
                            self.dtype, model_rot.mean(-1))
