"""DataPortrait: a phase-frequency portrait and its model builders.

Port of pulseportraiture_tpu.portrait: the reference's pplib.DataPortrait
(pplib.py:138-649) with the ppgauss (ppgauss.py:19-372) and ppspline
(ppspline.py:24-232) model builders.  Single archives and metafiles of
several archives with per-receiver join (phase, DM) parameters.

The portrait, its metadata and the models are host numpy arrays, as in
the JAX package; each builder step moves what it needs to the card and
brings its result back.  The builders compute in `dtype` (float64 by
default: the SWT, PCA, Gaussian generator and LM loop); the phase and
portrait fits inside them (the metafile join seeds, normalize('prof'),
check_convergence) run in float32 on the card, through the CUDA kernels
that take float32 only, and in `dtype` on the CPU.  Each builder records
its walls in self.timing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import resolve_device
from pulseportraiture_tpu_torch.config import (DEFAULT_MODEL_CODE,
                                               SCATTERING_ALPHA)
from pulseportraiture_tpu_torch.io.archive import load_data, unload_new_archive

def _is_metafile(path):
    with open(path, "rb") as f:
        magic = f.read(6)
    return magic != b"SIMPLE"


def fit_dtype_for(device, dtype):
    """The float type of the fits inside the builders: float32 on the card
    (what its kernels take), `dtype` on the CPU."""
    return torch.float32 if device.type == "cuda" else dtype


class DataPortrait:
    """Data to which a portrait model is fit.

    device: "cuda" (the default; requires a card) or "cpu".  dtype: the
    builders' float type, float64 by default.
    """

    def __init__(self, datafile=None, joinfile=None, quiet=False,
                 device="cuda", dtype=torch.float64, **load_data_kwargs):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fit_dtype = fit_dtype_for(self.device, dtype)
        self.timing = {}
        self.init_params = []
        self.joinfile = joinfile
        if _is_metafile(datafile):
            self._init_from_metafile(datafile, quiet, **load_data_kwargs)
        else:
            self._init_single(datafile, quiet, **load_data_kwargs)

    def _t(self, x, fit=False):
        """Host data as a tensor on the device, in the builders' dtype or
        (fit=True) the fits'."""
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=self.fit_dtype if fit else self.dtype,
                               device=self.device)

    # ------------------------------------------------------------- loading

    def _init_single(self, datafile, quiet, **kwargs):
        self.njoin = 0
        self.join_params = np.array([])
        self.join_fit_flags = np.array([])
        self.join_ichans = []
        self.join_ichanxs = []
        self.all_join_params = []
        self.datafile = datafile
        self.datafiles = [datafile]
        data = load_data(datafile, dedisperse=True, dededisperse=False,
                         tscrunch=True, pscrunch=True, fscrunch=False,
                         flux_prof=True, quiet=quiet, **kwargs)
        self.data = data
        for key, value in data.items():
            if key != "_lazy":
                setattr(self, key, value)
        # the record's lazily computed fields this class uses
        self.masks = data.masks
        self.prof = data.prof
        self.prof_noise = data.prof_noise
        self.prof_SNR = data.prof_SNR
        if self.source is None:
            self.source = "noname"
        self.port = (self.masks * self.subints)[0, 0]
        self.portx = self.port[self.ok_ichans[0]]
        self.flux_profx = self.flux_prof[self.ok_ichans[0]] \
            if len(self.flux_prof) else np.array([])
        self.freqsxs = [self.freqs[0, self.ok_ichans[0]]]
        self.noise_stdsxs = self.noise_stds[0, 0, self.ok_ichans[0]]
        self.SNRsxs = self.SNRs[0, 0, self.ok_ichans[0]]
        self.weightsxs = np.array([self.weights[0, self.ok_ichans[0]]])

    def _init_from_metafile(self, metafile, quiet, **kwargs):
        """Multi-archive load with the join machinery: each archive after
        the first gets a join phase seeded by a phase fit of its profile
        against the first's (pplib.py:163-305)."""
        from pulseportraiture_tpu_torch.fitters.phase_shift import \
            fit_phase_shift
        self.metafile = self.datafile = metafile
        with open(metafile) as f:
            self.datafiles = [line.strip() for line in f if line.strip()]
        self.njoin = len(self.datafiles)
        join_params, join_fit_flags = [], []
        join_nchans, join_nchanxs = [0], [0]
        freqs, freqsxs = [], []
        port, portx = [], []
        flux_prof, flux_profx = [], []
        noise_stds, noise_stdsxs = [], []
        SNRs, SNRsxs = [], []
        weights, weightsxs = [], []
        masks = []
        Ps = 0.0
        lofreq, hifreq = np.inf, 0.0
        refprof = None
        for ifile, datafile in enumerate(self.datafiles):
            data = load_data(datafile, dedisperse=True, tscrunch=True,
                             pscrunch=True, fscrunch=False, flux_prof=True,
                             quiet=quiet, **kwargs)
            join_nchans.append(join_nchans[-1] + data.nchan)
            join_nchanxs.append(join_nchanxs[-1] + len(data.ok_ichans[0]))
            if ifile == 0:
                join_params.extend([0.0, 0.0])
                join_fit_flags.extend([0, 1])
                self.nbin = data.nbin
                self.phases = data.phases
                refprof = data.prof
                self.source = data.source
            else:
                res = fit_phase_shift(self._t(data.prof, fit=True),
                                      self._t(refprof, fit=True),
                                      Ns=self.nbin)
                join_params.extend([-float(res.phase), 0.0])
                join_fit_flags.extend([1, 1])
            Ps += data.Ps.mean()
            lofreq = min(lofreq,
                         data.freqs.min() - abs(data.bw) / (2 * data.nchan))
            hifreq = max(hifreq,
                         data.freqs.max() + abs(data.bw) / (2 * data.nchan))
            okc = data.ok_ichans[0]
            freqs.extend(data.freqs[0])
            freqsxs.extend(data.freqs[0, okc])
            masks.extend(data.masks[0, 0])
            port.extend(data.subints[0, 0] * data.masks[0, 0])
            portx.extend(data.subints[0, 0, okc])
            flux_prof.extend(data.flux_prof)
            flux_profx.extend(np.asarray(data.flux_prof)[okc]
                              if len(data.flux_prof) else [])
            noise_stds.extend(data.noise_stds[0, 0])
            noise_stdsxs.extend(data.noise_stds[0, 0][okc])
            SNRs.extend(data.SNRs[0, 0])
            SNRsxs.extend(data.SNRs[0, 0][okc])
            weights.extend(data.weights[0])
            weightsxs.extend(data.weights[0, okc])
        self.data = data
        self.Ps = np.array([Ps / len(self.datafiles)])
        self.bw = hifreq - lofreq
        self.lofreq, self.hifreq = lofreq, hifreq
        freqs = np.array(freqs)
        freqsxs = np.array(freqsxs)
        self.nu0 = freqs.mean()
        self.nchan = len(freqs)
        self.nchanx = len(freqsxs)
        isort = np.argsort(freqs)
        isortx = np.argsort(freqsxs)
        self.isort, self.isortx = isort, isortx
        self.join_ichans = []
        self.join_ichanxs = []
        for ijoin in range(self.njoin):
            self.join_ichans.append(np.where(
                (isort >= join_nchans[ijoin]) &
                (isort < join_nchans[ijoin + 1]))[0])
            self.join_ichanxs.append(np.where(
                (isortx >= join_nchanxs[ijoin]) &
                (isortx < join_nchanxs[ijoin + 1]))[0])
        self.masks = np.array([[np.array(masks)[isort]]])
        self.port = np.array(port)[isort]
        self.portx = np.array(portx)[isortx]
        self.flux_prof = np.array(flux_prof)[isort] if flux_prof else \
            np.array([])
        self.flux_profx = np.array(flux_profx)[isortx] if flux_profx else \
            np.array([])
        self.noise_stds = np.array([[np.array(noise_stds)[isort]]])
        self.noise_stdsxs = np.array(noise_stdsxs)[isortx]
        self.SNRs = np.array([[np.array(SNRs)[isort]]])
        self.SNRsxs = np.array(SNRsxs)[isortx]
        self.weights = np.array([np.array(weights)[isort]])
        self.weightsxs = np.array([np.array(weightsxs)[isortx]])
        self.freqs = np.array([np.sort(freqs)])
        self.freqsxs = [np.sort(freqsxs)]
        self.ok_ichans = [np.where(self.weights[0] > 0)[0]]
        self.join_params = np.array(join_params)
        self.join_fit_flags = np.array(join_fit_flags)
        if self.joinfile:
            self._read_joinfile()
        self.all_join_params = [self.join_ichanxs, self.join_params,
                                self.join_fit_flags]

    def _read_joinfile(self):
        """Restore join parameters from a joinfile (pplib.py:282-298)."""
        with open(self.joinfile) as f:
            lines = [ln.split() for ln in
                     f.readlines()[-len(self.datafiles):]]
        try:
            for toks in lines:
                ijoin = self.datafiles.index(toks[0])
                self.join_params[ijoin * 2] = float(toks[1])
                self.join_params[ijoin * 2 + 1] = \
                    float(toks[3]) if len(toks) > 3 else float(toks[2])
        except (ValueError, IndexError):
            print("Bad join file.")

    def write_join_parameters(self, outfile=None, errs=None, quiet=False):
        """Append the join parameters to a .join file
        (pplib.py:486-521)."""
        outfile = outfile or (self.datafile + ".join")
        errs = errs if errs is not None else np.zeros(self.njoin * 2)
        with open(outfile, "a") as f:
            for ii, df in enumerate(self.datafiles):
                f.write("%s % .10f % .10f % .8f % .8f\n" % (
                    df, self.join_params[ii * 2], errs[ii * 2],
                    self.join_params[ii * 2 + 1], errs[ii * 2 + 1]))
        if not quiet:
            print(f"Wrote {outfile}.")

    def _rotate(self, port, phase, DM, freqs, nu_ref):
        """rotate_data of a host (nchan, nbin) portrait on the device."""
        from pulseportraiture_tpu_torch.ops.rotate import rotate_data
        return rotate_data(self._t(port), phase, DM, self.Ps[0], freqs,
                           nu_ref).cpu().numpy()

    def apply_joinfile(self, nu_ref, undo=False):
        """Rotate each archive's channels by its join (phi, DM)
        (pplib.py:329-355)."""
        sign = -1.0 if undo else 1.0
        for ii in range(self.njoin):
            phi = -self.join_params[0::2][ii] * sign
            DM = -self.join_params[1::2][ii] * sign
            jic = self.join_ichans[ii]
            self.port[jic] = self._rotate(self.port[jic], phi, DM,
                                          self.freqs[0, jic], nu_ref)
            jicx = self.join_ichanxs[ii]
            self.portx[jicx] = self._rotate(self.portx[jicx], phi, DM,
                                            self.freqsxs[0][jicx], nu_ref)

    # -------------------------------------------------------- manipulation

    def _normalized(self, port, method, weights):
        """port / its per-channel norms (ops.normalize); the 'prof' norms
        come from phase fits, in the fits' float type."""
        from pulseportraiture_tpu_torch.ops.normalize import \
            normalize_portrait
        _, norms = normalize_portrait(self._t(port, fit=method == "prof"),
                                      method, weights=weights,
                                      return_norms=True)
        norms = norms.cpu().numpy().astype(np.float64)
        return np.asarray(port, dtype=np.float64) / norms[:, None], norms

    def normalize_portrait(self, method="rms"):
        """Normalize each channel's profile (pplib.py:357-382)."""
        from pulseportraiture_tpu_torch.ops.noise import get_noise_PS
        if method == "prof":
            weights = self.weights[0]
            weightsx = self.weights[self.weights > 0]
        else:
            weights = weightsx = None
        self.unnorm_noise_stds = np.copy(self.noise_stds)
        self.port, self.norm_values = self._normalized(self.port, method,
                                                       weights)
        self.noise_stds[0, 0] = get_noise_PS(self.port, chans=True)
        self.flux_prof = self.port.mean(axis=1)
        self.unnorm_noise_stdsxs = np.copy(self.noise_stdsxs)
        self.portx = self._normalized(self.portx, method, weightsx)[0]
        self.noise_stdsxs = get_noise_PS(self.portx, chans=True)
        self.flux_profx = self.portx.mean(axis=1)

    def unnormalize_portrait(self):
        """Undo normalize_portrait (pplib.py:384-398)."""
        if hasattr(self, "unnorm_noise_stds"):
            self.port = self.norm_values[:, None] * self.port
            self.noise_stds = np.copy(self.unnorm_noise_stds)
            del self.unnorm_noise_stds
            self.flux_prof = self.port.mean(axis=1)
            self.portx = self.norm_values[self.ok_ichans[0]][:, None] * \
                self.portx
            self.noise_stdsxs = np.copy(self.unnorm_noise_stdsxs)
            del self.unnorm_noise_stdsxs
            self.flux_profx = self.portx.mean(axis=1)
            self.norm_values = np.ones(len(self.port))

    def smooth_portrait(self, smart=False, **kwargs):
        """Wavelet-smooth the portrait on the device (pplib.py:400-424)."""
        from pulseportraiture_tpu_torch.models.wavelet import (smart_smooth,
                                                              wavelet_smooth)
        from pulseportraiture_tpu_torch.ops.noise import get_noise_PS
        if smart:
            nlev = min(8, int(np.log2(self.nbin)))

            def smooth(p):
                return smart_smooth(self._t(p), try_nlevels=nlev, **kwargs)
        else:
            def smooth(p):
                return wavelet_smooth(self._t(p), **kwargs)
        self.port = smooth(self.port).cpu().numpy()
        self.portx = smooth(self.portx).cpu().numpy()
        self.noise_stds[0, 0] = get_noise_PS(self.port, chans=True)
        self.noise_stdsxs = get_noise_PS(self.portx, chans=True)
        self.flux_prof = self.port.mean(axis=1)
        self.flux_profx = self.portx.mean(axis=1)

    def fit_flux_profile(self, channel_errs=None, nu_ref=None, guessA=1.0,
                         guessalpha=0.0, quiet=False):
        """Power-law fit to the phase-averaged flux spectrum
        (pplib.py:426-484)."""
        from pulseportraiture_tpu_torch.fitters.powlaw import fit_powlaw
        if nu_ref is None:
            nu_ref = self.nu0
        if channel_errs is None:
            channel_errs = self.noise_stdsxs / np.sqrt(self.nbin)
        results = fit_powlaw(self._t(self.flux_profx), [guessA, guessalpha],
                             channel_errs, self.freqsxs[0], nu_ref)
        self.spect_index = results.alpha
        self.spect_index_err = results.alpha_err
        self.flux_at_nu_ref = results.amp
        self.flux_at_nu_ref_err = results.amp_err
        if not quiet:
            print(f"Flux = {results.amp:.3f} +/- {results.amp_err:.3f} at "
                  f"{nu_ref:.1f} MHz; index = {results.alpha:.3f} +/- "
                  f"{results.alpha_err:.3f}")
        return results

    def rotate_stuff(self, phase=0.0, DM=0.0, nu_ref=None):
        """Rotate port and portx by (phase, DM) at nu_ref
        (pplib.py:523-570)."""
        if nu_ref is None:
            nu_ref = self.nu0
        self.port = self._rotate(self.port, phase, DM, self.freqs[0],
                                 nu_ref)
        self.portx = self._rotate(self.portx, phase, DM, self.freqsxs[0],
                                  nu_ref)

    def unload_archive(self, outfile, DM=None, dmc=False, quiet=False):
        """Write the current port out as an archive (pplib.py:572-594)."""
        unload_new_archive(self.port[None, None], self.data.arch, outfile,
                           DM=DM if DM is not None else self.DM,
                           dmc=int(dmc), weights=self.weights, quiet=quiet)

    def write_model_archive(self, outfile, quiet=False):
        """Write the model portrait as an archive (pplib.py:597-615)."""
        unload_new_archive(self.model[None, None], self.data.arch, outfile,
                           DM=0.0, dmc=0, weights=self.weights, quiet=quiet)

    # ------------------------------------------------------- spline models

    def make_spline_model(self, max_ncomp=10, smooth=True, snr_cutoff=150.0,
                          rchi2_tol=0.1, k=3, sfac=1.0, max_nbreak=None,
                          model_name=None, quiet=False, **kwargs):
        """PCA + B-spline interpolation model (ppspline.py:34-204).

        On the device: the weighted PCA, one smart_smooth of the mean
        profile and the first 10 eigenvectors, the projections and the
        model portraits; on the host: the significance decisions and the
        spline fit.  kwargs go to smart_smooth.
        """
        from pulseportraiture_tpu_torch.models.spline import (
            find_significant_eigvec, fit_parametric_spline,
            gen_spline_portrait, pca, reconstruct_portrait)
        from pulseportraiture_tpu_torch.models.wavelet import smart_smooth

        t0 = time.perf_counter()
        port = self.portx
        pca_weights = self.SNRsxs / np.sum(self.SNRsxs)
        mean_prof = (port * pca_weights[:, None]).sum(0) / pca_weights.sum()
        freqs = self.freqsxs[0]
        if port.shape[1] % 2 != 0:
            smooth = False
        return_max = 10 if max_ncomp is None else min(max_ncomp, 10)
        port_t = self._t(port)
        eigval, eigvec_t = pca(port_t, self._t(mean_prof),
                               self._t(pca_weights), quiet=quiet)
        eigval = eigval.cpu().numpy()
        eigvec = eigvec_t.cpu().numpy()
        t1 = time.perf_counter()
        if smooth:
            # one smart_smooth of [mean_prof; eigvecs]
            nvec = max(10, return_max)
            stack = torch.cat([self._t(mean_prof)[None],
                               eigvec_t.T[:nvec]]).contiguous()
            sm_all = smart_smooth(stack, rchi2_tol=rchi2_tol,
                                  **kwargs).cpu().numpy()
            ieig, smooth_eigvec = find_significant_eigvec(
                eigvec_t, check_max=10, return_max=return_max,
                snr_cutoff=snr_cutoff, return_smooth=True,
                rchi2_tol=rchi2_tol, evs_all=sm_all[1:], **kwargs)
            self.smooth_eigvec = smooth_eigvec
            self.smooth_mean_prof = smooth_mean_prof = sm_all[0]
            use_mean, use_eigvec = smooth_mean_prof, smooth_eigvec
        else:
            ieig = find_significant_eigvec(
                eigvec_t, check_max=10, return_max=return_max,
                snr_cutoff=snr_cutoff, return_smooth=False,
                rchi2_tol=rchi2_tol, **kwargs)
            use_mean, use_eigvec = mean_prof, eigvec
        t2 = time.perf_counter()
        ncomp = len(ieig)
        if ncomp == 0:
            proj_port = port[:, :0]
            tck = (np.array([]), np.zeros((0, 0)), 0)
            fp = None
            model = np.tile(use_mean, (len(self.freqs[0]), 1))
            modelx = np.tile(use_mean, (len(freqs), 1))
            reconst_port = modelx.copy()
        else:
            ev = self._t(use_eigvec[:, ieig])
            reconst_port = reconstruct_portrait(port_t, mean_prof,
                                                ev).cpu().numpy()
            proj_port = ((port_t - self._t(mean_prof)) @ ev).cpu().numpy()
            # FITPACK-style smoothing target (ppspline.py:139-146)
            s = sfac * len(proj_port) * \
                np.sum((self.SNRsxs * self.noise_stdsxs) ** 2) / \
                np.sum(self.SNRsxs) ** 2
            flip = -1 if self.bw < 0 else 1
            tck, fp = fit_parametric_spline(
                freqs[::flip], proj_port[::flip].T,
                weights=pca_weights[::flip], k=k, s=s,
                max_nbreak=max_nbreak)
            mean_t = self._t(use_mean)
            modelx = gen_spline_portrait(mean_t, freqs, ev, tck).cpu().numpy()
            model = gen_spline_portrait(mean_t, self.freqs[0], ev,
                                        tck).cpu().numpy()
        self.timing.update(pca_s=t1 - t0, smooth_s=t2 - t1,
                           spline_fit_s=time.perf_counter() - t2)
        self.ieig = ieig
        self.ncomp = ncomp
        self.eigvec = eigvec
        self.eigval = eigval
        self.mean_prof = mean_prof
        self.proj_port = proj_port
        self.reconst_port = reconst_port
        self.tck, self.fp = tck, fp
        self.model_name = model_name or (self.datafile + ".spl")
        self.model = model
        self.modelx = modelx
        self.model_masked = self.model * self.masks[0, 0]
        if not quiet:
            print(f"B-spline model {self.model_name}: {ncomp} components, "
                  f"{len(np.unique(np.asarray(self.tck[0])))} breakpoints")

    def write_model(self, outfile, quiet=False, fmt="pickle"):
        """Write the spline model (ppspline.py:206-232)."""
        from pulseportraiture_tpu_torch.models.spline_io import \
            write_spline_model
        if hasattr(self, "smooth_eigvec"):
            eigvec = self.smooth_eigvec[:, self.ieig]
            mean = self.smooth_mean_prof
        else:
            eigvec = self.eigvec[:, self.ieig]
            mean = self.mean_prof
        write_spline_model(outfile, self.model_name, self.source,
                           self.datafile, mean, eigvec, self.tck, fmt=fmt,
                           quiet=quiet)

    # ----------------------------------------------------- Gaussian models

    def fit_profile(self, profile, errs, ngauss=1, fit_scattering=False,
                    quiet=True):
        """Automatic multi-component 1-D bootstrap fit: components are
        added one at a time at the residual's peak, up to ngauss
        (replaces the reference's interactive GaussianSelector,
        ppgauss.py:28-53, 374-655)."""
        from pulseportraiture_tpu_torch.models.gaussian import (
            fit_gaussian_profile, gen_gaussian_profile)
        nbin = len(profile)
        phases = (np.arange(nbin) + 0.5) / nbin
        prof_t = self._t(profile)
        resid = np.asarray(profile, dtype=float).copy()
        params = [float(np.median(profile)), 0.0]
        fit = None
        for ig in range(ngauss):
            ipeak = int(np.argmax(resid))
            amp0 = float(resid[ipeak] - np.median(resid))
            if amp0 <= 0:
                break
            # rough width: the half-max crossing around the peak
            half = np.where(resid > 0.5 * resid[ipeak])[0]
            wid0 = max(len(half) / nbin / max(ig + 1, 1), 2.0 / nbin)
            params += [phases[ipeak], wid0, amp0]
            fit = fit_gaussian_profile(prof_t, params, errs,
                                       fit_scattering=fit_scattering,
                                       quiet=quiet)
            params = list(fit.fitted_params)
            resid = np.asarray(profile) - gen_gaussian_profile(
                self._t(params), nbin).cpu().numpy()
        return fit

    def make_gaussian_model(self, modelfile=None, ref_prof=(None, None),
                            fixloc=False, fixwid=False, fixamp=False,
                            fixscat=True, fixalpha=True,
                            fiducial_gaussian=False, ngauss=1, niter=0,
                            writemodel=True, writeerrfile=False,
                            outfile=None, model_name=None, nu_ref=None,
                            model_code=DEFAULT_MODEL_CODE,
                            scattering_index=SCATTERING_ALPHA, tau=0.0,
                            quiet=False):
        """Iterative evolving-Gaussian model fit (ppgauss.py:55-238): a
        bootstrap from a reference-band profile (or a .gmodel to resume),
        then the portrait fit alternating with rotate_stuff until
        check_convergence passes or niter refits are done."""
        from pulseportraiture_tpu_torch.models.gaussian import (
            fit_gaussian_portrait, gen_gaussian_portrait)
        from pulseportraiture_tpu_torch.models.gmodel_io import read_model

        self.model_name = model_name or (self.source + ".gmodel")
        outfile = outfile or (self.datafile + ".gmodel")
        if nu_ref is None:
            nu_ref = self.nu0
        t0 = time.perf_counter()
        if modelfile is not None:
            # resume from an existing .gmodel (ppgauss.py:99-110)
            (name, model_code, nu_ref, ngauss_m, params, fit_flags_m,
             alpha, fit_alpha) = read_model(modelfile, quiet=quiet)
            init_params = np.array(params)
            if init_params[1] != 0:
                init_params[1] *= self.nbin / self.Ps[0]
            scattering_index = alpha
            ngauss = ngauss_m
        else:
            # bootstrap from a reference-band profile (ppgauss.py:124-149)
            ref_nu, ref_bw = ref_prof
            if ref_nu is None:
                ref_nu = self.nu0
            if ref_bw is None:
                ref_bw = abs(self.bw) / 4.0
            sel = np.where(np.abs(self.freqsxs[0] - ref_nu) <=
                           ref_bw / 2.0)[0]
            if not len(sel):
                sel = np.arange(len(self.freqsxs[0]))
            prof = self.portx[sel].mean(0)
            err = float(np.mean(self.noise_stdsxs[sel]) /
                        np.sqrt(max(len(sel), 1)))
            p1 = self.fit_profile(prof, err, ngauss=ngauss,
                                  fit_scattering=not fixscat,
                                  quiet=True).fitted_params
            ngauss = (len(p1) - 2) // 3
            init_params = np.zeros(2 + 6 * ngauss)
            init_params[0] = p1[0]
            init_params[1] = tau if tau else p1[1]
            for ig in range(ngauss):
                loc, wid, amp = p1[2 + 3 * ig: 5 + 3 * ig]
                init_params[2 + 6 * ig: 8 + 6 * ig] = \
                    [loc, 0.0, wid, 0.0, amp, 0.0]
        # fit-flag assembly (ppgauss.py:150-159)
        fit_flags = np.ones(len(init_params))
        fit_flags[1] = 0.0 if fixscat else 1.0
        for ig in range(ngauss):
            base = 2 + 6 * ig
            if fixloc:
                fit_flags[base + 1] = 0.0
            if fixwid:
                fit_flags[base + 3] = 0.0
            if fixamp:
                fit_flags[base + 5] = 0.0
        if fiducial_gaussian:
            fit_flags[3] = 0.0  # freeze the first component's loc evolution
            init_params[3] = 0.0
        join_params = self.all_join_params if self.njoin else ()
        timing = dict(bootstrap_s=time.perf_counter() - t0, lm_s=0.0,
                      lm_iters=0, lm_jacobians=0, lm_rejected=0,
                      check_convergence_s=0.0)
        start = time.time()
        itern = 0
        while True:
            itern += 1
            t0 = time.perf_counter()
            results = fit_gaussian_portrait(
                model_code, self._t(self.portx), init_params,
                scattering_index, self.noise_stdsxs, fit_flags,
                not fixalpha, self.phases, self.freqsxs[0], nu_ref,
                join_params=join_params, P=self.Ps[0], quiet=True)
            timing["lm_s"] += time.perf_counter() - t0
            timing["lm_iters"] += results.niter
            timing["lm_jacobians"] += results.njac
            timing["lm_rejected"] += results.nrejected
            init_params = results.fitted_params[:len(init_params)]
            scattering_index = results.scattering_index
            if self.njoin:
                self.join_params = np.array(
                    results.fitted_params[len(init_params):
                                          len(init_params) +
                                          self.njoin * 2])
            self.model = gen_gaussian_portrait(
                model_code, self._t(init_params), scattering_index,
                self.phases, self.freqs[0], nu_ref).cpu().numpy()
            self.modelx = self.model[self.ok_ichans[0]]
            self.model_masked = self.model * self.masks[0, 0]
            if writemodel:
                self._write_gmodel(outfile, model_code, nu_ref, init_params,
                                   fit_flags, scattering_index,
                                   not fixalpha, quiet=True)
            if itern > niter:
                break
            t0 = time.perf_counter()
            converged, dphi, dDM = self.check_convergence(nu_ref)
            timing["check_convergence_s"] += time.perf_counter() - t0
            if converged:
                if not quiet:
                    print(f"Converged after {itern} iterations.")
                break
            self.rotate_stuff(dphi, dDM, nu_ref)
        self.timing.update(timing)
        self.model_code = model_code
        self.model_params = init_params
        self.fit_flags = fit_flags
        self.scattering_index = scattering_index
        self.nu_ref_gauss = nu_ref
        self.gauss_fit_results = results
        if writeerrfile:
            # parameter uncertainties in .gmodel layout (ppgauss.py:356-372)
            self._write_gmodel(outfile + ".errs", model_code, nu_ref,
                               np.asarray(results.fit_errs), fit_flags,
                               results.scattering_index_err, not fixalpha,
                               quiet=True, mod_locs=False)
        if not quiet:
            print(f"Gaussian model fit took {time.time() - start:.1f} s; "
                  f"red_chi2 = {results.red_chi2:.3f}")
        return results

    def check_convergence(self, nu_ref, efac=1.0):
        """The residual (phi, DM) of the data against the model and
        whether both are within efac of their errors (ppgauss.py:278-334):
        a phase fit of the mean profiles seeds a (phi, DM) portrait fit,
        in the fits' float type on the device."""
        from pulseportraiture_tpu_torch.fitters.phase_shift import \
            fit_phase_shift
        from pulseportraiture_tpu_torch.fitters.portrait import fit_portrait
        pg = fit_phase_shift(self._t(self.portx.mean(0), fit=True),
                             self._t(self.modelx.mean(0), fit=True),
                             Ns=self.nbin)
        res = fit_portrait(self._t(self.portx, fit=True), self.modelx,
                           [float(pg.phase), 0.0], self.Ps[0],
                           self.freqsxs[0], nu_fit=nu_ref, nu_out=nu_ref,
                           errs=self.noise_stdsxs)
        dphi, dDM = float(res.phase), float(res.DM)
        converged = (abs(dphi) < float(res.phase_err) * efac and
                     abs(dDM) < float(res.DM_err) * efac)
        return converged, dphi, dDM

    def _write_gmodel(self, outfile, model_code, nu_ref, params, fit_flags,
                      alpha, fit_alpha, quiet=True, mod_locs=True):
        """tau bins -> seconds, then write (ppgauss.py:336-354)."""
        from pulseportraiture_tpu_torch.models.gmodel_io import write_model
        p = np.array(params, dtype=float)
        p[1] *= self.Ps[0] / self.nbin  # bins -> seconds
        if mod_locs:
            p[2::6] %= 1.0              # locs mod 1 (not for error files)
        write_model(outfile, self.model_name, model_code, nu_ref, p,
                    [int(f) for f in fit_flags], alpha, int(fit_alpha),
                    quiet=quiet)

    def show_data_portrait(self, **kwargs):
        """The portrait image (viz.show_portrait; needs matplotlib)."""
        from pulseportraiture_tpu_torch.viz import show_portrait
        show_portrait(self.port, phases=self.phases,
                      freqs=self.freqs[0], **kwargs)

    def show_model_fit(self, **kwargs):
        """Data, model and residual panels (viz.show_residual_plot)."""
        from pulseportraiture_tpu_torch.viz import show_residual_plot
        show_residual_plot(self.port, self.model_masked,
                           phases=self.phases, freqs=self.freqs[0],
                           **kwargs)

    def show_eigenprofiles(self, **kwargs):
        """Mean profile + significant eigenprofiles (ppspline.py:234-249)."""
        from pulseportraiture_tpu_torch.viz import show_eigenprofiles
        eigvec = getattr(self, "smooth_eigvec", None)
        if eigvec is None:
            eigvec = self.eigvec
        cols = self.ieig if len(getattr(self, "ieig", [])) else []
        show_eigenprofiles(np.asarray(eigvec)[:, cols],
                           mean_prof=getattr(self, "smooth_mean_prof",
                                             self.mean_prof), **kwargs)

    def show_spline_curve_projections(self, **kwargs):
        """Spline-curve projections vs frequency (ppspline.py:251-276)."""
        from pulseportraiture_tpu_torch.viz import \
            show_spline_curve_projections
        show_spline_curve_projections(self.proj_port, self.freqsxs[0],
                                      tck=self.tck, **kwargs)
