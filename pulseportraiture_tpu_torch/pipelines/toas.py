"""TOA measurement (the pptoas pipelines) on the port.

Port of pulseportraiture_tpu.pipelines.toas.GetTOAs:

  get_TOAs             the wideband fit, (phi, DM[, GM]) or with fit_scat
                       (phi, DM[, GM], tau[, alpha]).  Per archive: load
                       (a float32 fit on a card takes an int16 archive's
                       baseline, noise and S/N from the card:
                       ops/load_stats), take each subint's template from
                       pipelines/template, fit the subints in chunked
                       batches (fitters.portrait) on the chosen device, and
                       assemble TOAs with Doppler-corrected DMs,
                       scattering times and .tim flags.
  get_narrowband_TOAs  per-channel TOAs by batched FFTFIT
                       (fitters.phase_shift), optionally with a
                       per-channel scattering time.
  get_psrchive_TOAs    per-channel TOAs by the six pat-style estimators
                       (fitters.arrival_time).
  get_channels_to_zap  channels to zap from the stored fits (show_fit
                       rebuilds one fitted subint and draws it).

get_TOAs(mesh=...) fits the batched chunks over several devices
(parallel.mesh); the plots (show_fit, show_plot, get_channels_to_zap's
show) need matplotlib, which is imported only when one is drawn.
Reference: pptoas.py:150-1206.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from pulseportraiture_tpu_torch.config import F0_FACT
from pulseportraiture_tpu_torch.io.tim import TOA
from pulseportraiture_tpu_torch.utils import weighted_mean
from pulseportraiture_tpu_torch._device import resolve_device
from pulseportraiture_tpu_torch.fitters.arrival_time import (
    ALGORITHMS, arrival_time_shifts)
from pulseportraiture_tpu_torch.fitters.phase_shift import \
    fit_phase_shift_batch
from pulseportraiture_tpu_torch.fitters.portrait import (
    fit_portrait_full_batch, fit_portrait_full_batch_packed, unpack_result)
from pulseportraiture_tpu_torch.io.archive import load_data
from pulseportraiture_tpu_torch.ops import load_stats
from pulseportraiture_tpu_torch.ops.noise import get_noise_PS
from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait_full
from pulseportraiture_tpu_torch.ops.scattering import (
    scattering_portrait_FT_np, scattering_times)
from pulseportraiture_tpu_torch.parallel.mesh import \
    fit_portrait_full_sharded
from pulseportraiture_tpu_torch.pipelines.template import (
    ModelSource, Templates, fit_spectrum)
from pulseportraiture_tpu_torch.profiling import annotate

_MAX_CHUNK = 64
# scattering guess defaults: tau [sec], at nu [MHz], index (pptoas.py:~437)
_DEFAULT_SCAT_GUESS = (1e-5, 1500.0, -4.0)


def _auto_fit_chunk(nchan, nbin, nh, x_itemsize, f_itemsize, grid,
                    n_batch=1):
    """Subints per batched fit: what fits 60% of each card's free memory
    (torch.cuda.mem_get_info), at most 64 a batch shard.  grid: the
    devices a chunk is spread over, one entry a share (a mesh's cells; a
    device listed twice holds two shares).  Per item the cards hold the
    data portrait, the persistent Gr/Gi and the setup's transients."""
    per_share = (nchan * nbin * x_itemsize + 6 * f_itemsize * nchan * nh) \
        / len(grid)
    chunk = _MAX_CHUNK * n_batch
    for dev, shares in collections.Counter(grid).items():
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            chunk = min(chunk, int(0.6 * free / (per_share * shares)))
    return max(1, chunk)


def _resolve_datafiles(datafiles):
    """A single archive path, a list of paths, or a metafile of paths."""
    if isinstance(datafiles, (list, tuple)):
        return list(datafiles)
    with open(datafiles, "rb") as f:
        magic = f.read(6)
    if magic == b"SIMPLE":
        return [datafiles]
    with open(datafiles) as f:
        return [line.strip() for line in f if line.strip()]


def _parallactic_angle_for(data, epoch):
    """Parallactic angle [deg] from the archive's ephemeris + telescope
    (NaN when unknown; reference pptoas.py:1081-1082)."""
    try:
        from pulseportraiture_tpu_torch.io.par import parse_par
        from pulseportraiture_tpu_torch.io.parang import parallactic_angle
        eph = getattr(data.arch, "ephemeris_lines", None)
        if not eph:
            return float("nan")
        par = parse_par(eph)
        return round(parallactic_angle(data.telescope, par.RAJ, par.DECJ,
                                       epoch.in_days()), 4)
    except (AttributeError, ValueError):
        return float("nan")


class GetTOAs:
    """Measure wideband or narrowband TOAs for archives against a template.

    device: "cuda" (the default; requires a card) or "cpu".
    dtype: the fit's float type, float32 (the card's working type) or
    float64 (CPU parity runs).  Reference: pptoas.py:81-743.
    """

    _PER_ARCHIVE = ("ok_isubs", "epochs", "MJDs", "Ps", "phis", "phi_errs",
                    "TOAs", "TOA_errs", "DMs", "DM_errs", "GMs", "GM_errs",
                    "taus", "tau_errs", "alphas", "alpha_errs", "scales",
                    "scale_errs", "snrs", "channel_snrs",
                    "fit_channel_red_chi2s", "fluxes", "flux_errs",
                    "red_chi2s", "covariances", "nfevals", "rcs", "nu_fits",
                    "nu_refs")

    def __init__(self, datafiles, modelfile, device="cuda",
                 dtype=torch.float32, quiet=False):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        self.dtype = dtype
        self.datafiles = _resolve_datafiles(datafiles)
        self.model_source = ModelSource(modelfile)
        self.modelfile = modelfile
        self.quiet = quiet
        self.obs, self.nu0s, self.ok_idatafiles, self.order = [], [], [], []
        self.DM0s, self.DeltaDM_means, self.DeltaDM_errs = [], [], []
        self.fit_durations, self.TOA_list = [], []
        for name in self._PER_ARCHIVE:
            setattr(self, name, [])
        self.mharms, self.fit_timing, self.psrchive_toas = [], {}, []
        # DM smearing within channels plus extra response widths/types,
        # applied to the template by get_TOAs(add_instrumental_response)
        self.instrumental_response_dict = self.ird = \
            {"DM": 0.0, "wids": [], "irf_types": []}

    def get_TOAs(self, datafile=None, tscrunch=False, nu_refs=None,
                 DM0=None, bary=True, fit_DM=True, fit_GM=False,
                 fit_scat=False, log10_tau=True, scat_guess=None,
                 fix_alpha=True, print_phase=False, print_flux=False,
                 print_parangle=False, add_instrumental_response=False,
                 addtnl_toa_flags=None, method="trust-ncg", bounds=None,
                 nu_fits=None, show_plot=False, quiet=None, mesh=None):
        """Fit every subint of every archive; fills TOA_list and the
        per-archive lists.

        fit_scat: also fit the scattering time tau (in log10 unless
        log10_tau is False) and, unless fix_alpha, the index alpha,
        starting from scat_guess = (tau [sec], at nu [MHz], alpha); a
        Gaussian template is then evaluated with its own scattering
        zeroed, spline and FITS templates are taken as they are.
        nu_refs: optional (nu_DM, nu_GM, nu_tau) output references [MHz],
        each None for the zero-covariance frequency; the tau reference is
        barycentric and is divided by the Doppler factor when bary.  With
        nu_refs every subint takes the per-subint route: a brute FFTFIT
        phase start (no DM seed) and the references pinned.
        add_instrumental_response: convolve the template with self.ird's
        response (the channels' dispersive smearing at ird["DM"], and
        ird["wids"] of ird["irf_types"]).  method and bounds are accepted
        for the reference's signature and change nothing, as in the JAX
        package.  show_plot: show each fitted subint's residual plot
        (show_fit) once its archive is assembled; needs matplotlib.
        mesh: a parallel.mesh.Mesh; the batched chunks are then fitted by
        parallel.mesh.fit_portrait_full_sharded, subints sharded over its
        rows and channels over each row's devices, each chunk packed once
        per batch shard (the template is kept on every device of the
        mesh); the per-subint route stays on this GetTOAs' device.
        Reference: pptoas.py:150-743.
        """
        batchable_ok = nu_refs is None
        quiet = self.quiet if quiet is None else quiet
        datafiles = [datafile] if datafile is not None else self.datafiles
        addtnl_toa_flags = addtnl_toa_flags or {}
        # fit-flag assembly (pptoas.py:216-227)
        fit_flags = (1, int(fit_DM), int(fit_GM), int(bool(fit_scat)),
                     int(bool(fit_scat) and not fix_alpha))
        self.bary = bary
        self.log10_tau = log10_tau = bool(log10_tau and fit_scat)
        sg = _DEFAULT_SCAT_GUESS if scat_guess is None else scat_guess
        f32 = self.dtype == torch.float32
        np_dtype = np.float32 if f32 else np.float64
        # fit_subints: subints fitted; i2_subints: those of them that
        # reached the fit as int16 samples and scales; card_prep_subints:
        # those whose archive's baseline, noise and S/N came from the card
        timing = {"load_s": 0.0, "fit_s": 0.0, "assemble_s": 0.0,
                  "wall_s": 0.0, "batched_chunks": 0, "fit_subints": 0,
                  "i2_subints": 0, "card_prep_subints": 0}
        self.fit_timing = timing
        start_all = time.time()
        templates = Templates(
            self.model_source, self.dtype, unscat=fit_scat,
            ird=self.ird if add_instrumental_response else None)
        jobs, results, buffers = [], {}, {}
        next_assemble = 0

        stats_device = load_stats.stats_device(self.device, self.dtype)

        def prep_archive(idf, df):
            t0 = time.time()
            data = self._load_dispersed(df, tscrunch, quiet, stats_device)
            if data is None:
                return None
            DM0_arch = data.DM if DM0 is None else DM0
            i2_ok = f32 and not F0_FACT and \
                getattr(data, "raw_i2", None) is not None
            preps = []
            for isub in data.ok_isubs:
                P, freqs = data.Ps[isub], data.freqs[isub]
                weights, okc = data.weights[isub], data.ok_ichans[isub]
                errs = np.where(weights > 0, data.noise_stds[isub, 0], 0.0)
                freqsx = freqs[okc]
                if nu_fits is not None:
                    nu_fit = float(np.atleast_1d(nu_fits)[0])
                else:
                    SNRsx = data.SNRs[isub, 0][okc]
                    nu0 = (freqsx.min() + freqsx.max()) * 0.5
                    wgt = SNRsx * freqsx ** -2.0
                    nu_fit = float(nu0 + ((freqsx - nu0) * wgt).sum() /
                                   wgt.sum())
                # tau and alpha start values (pptoas.py:~437); phi and DM
                # are seeded in the batch fit
                tau_guess_rot = (sg[0] / P) * (nu_fit / sg[1]) ** sg[2]
                if log10_tau:
                    tau_guess = float(np.log10(max(tau_guess_rot, 1e-12)))
                else:
                    tau_guess = tau_guess_rot if fit_scat else 0.0
                init = np.array([0.0, 0.0, 0.0, tau_guess, sg[2]])
                # one live channel carries no DM or scattering law, two
                # no GM beside a DM (pptoas.py:475-483)
                sub_flags = fit_flags
                if len(okc) == 1:
                    sub_flags = (1, 0, 0, 0, 0)
                elif len(okc) == 2 and fit_flags[2]:
                    sub_flags = (1, fit_flags[1], 0, fit_flags[3],
                                 fit_flags[4])
                batchable = batchable_ok and sub_flags == fit_flags
                if batchable and i2_ok:
                    port, scale = data.raw_i2[isub], data.raw_scl[isub]
                else:
                    port = np.asarray(data.subints[isub, 0], np_dtype)
                    scale = None
                prep = dict(isub=isub, P=P, freqs=freqs, port=port,
                            scale=scale, errs=errs, okc=okc, init=init,
                            tmpl=templates.get(data, isub, DM0_arch),
                            nu_fit=nu_fit, sub_flags=sub_flags,
                            batchable=batchable, raw_stats=data.raw_stats,
                            doppler=data.doppler_factors[isub])
                if not batchable:
                    # fitted per archive from a brute FFTFIT phase start
                    prep["mean_prof"] = (port[okc] *
                                         weights[okc][:, None]).mean(0)
                preps.append(prep)
            # the preps hold what the fits need: free the archive's sample
            # arrays (the int16 ports are views, kept until fitted)
            data["subints"] = None
            data.pop("raw_i2", None)
            data.pop("raw_scl", None)
            if data.arch is not None:
                data.arch.data = None
                data.arch.raw_i2 = None
            timing["load_s"] += time.time() - t0
            return dict(idf=idf, df=df, data=data, DM0_arch=DM0_arch,
                        preps=preps)

        dev = self._dev

        def fill_phase_guesses(plist):
            """init[0] of per-subint-fitted preps: one batched FFTFIT of
            the channel-mean profiles per nbin (pptoas.py:~430)."""
            groups = {}
            for p in plist:
                groups.setdefault(len(p["mean_prof"]), []).append(p)
            for group in groups.values():
                mp = np.stack([p.pop("mean_prof") for p in group])
                mm = np.stack([p["tmpl"].mean_profile(p["okc"])
                               for p in group])
                pg = fit_phase_shift_batch(
                    dev(mp), dev(mm), noise=dev(get_noise_PS(mp, chans=True)),
                    Ns=100)
                for p, ph in zip(group, pg.phase.cpu().numpy()):
                    p["init"][0] = float(ph)

        def fit_fallback(iarch, job):
            """The subints the batches leave out, when their archive is
            next to be assembled."""
            plist = [p for p in job["preps"] if not p["batchable"]]
            if not plist:
                return
            fill_phase_guesses(plist)
            groups = {}
            for p in plist:
                groups.setdefault((p["port"].shape, p["sub_flags"],
                                   p["tmpl"]), []).append((iarch, p))
            for (shape, sub_flags, tmpl), items in groups.items():
                chunk = _auto_fit_chunk(shape[0], shape[1], tmpl.mr.shape[1],
                                        np.dtype(np_dtype).itemsize,
                                        4 if f32 else 8, [self.device])
                for i in range(0, len(items), chunk):
                    fit_chunk(items[i:i + chunk], sub_flags, batch=False)

        def fit_chunk(items, flags=fit_flags, batch=True):
            """One batched fit.  batch=False is the per-subint route: the
            caller's phase start, the user's output references, and an
            unfitted tau kept in the model when fit_scat."""
            with annotate("pp:toas.fit"):
                t0 = time.time()
                tmpl = items[0][1]["tmpl"]
                sharded = mesh is not None and batch
                with annotate("pp:toas.to_card"):
                    x = torch.from_numpy(
                        np.stack([p.pop("port") for _, p in items]))
                    scales = None
                    if items[0][1]["scale"] is not None:
                        scales = torch.from_numpy(np.stack(
                            [p.pop("scale") for _, p in items]).astype(
                                np.float32))
                    ops = (np.stack([p["init"] for _, p in items]),
                           np.array([p["P"] for _, p in items]),
                           np.stack([p["freqs"] for _, p in items]),
                           np.stack([p["errs"] for _, p in items]))
                    nu_fits_b = np.array([[p["nu_fit"]] * 3
                                          for _, p in items])
                    if not sharded:
                        # a mesh takes the host operands: each shard's
                        # slabs go to their own devices
                        xd = x.to(self.device)
                        mft = tmpl.on([self.device])[self.device]
                        ops = tuple(map(dev, ops))
                        nu_fits_b = dev(nu_fits_b)
                        if scales is not None:
                            scales = scales.to(self.device)
                if sharded:
                    packed = fit_portrait_full_sharded(
                        mesh, x, tmpl.on(mesh.device_list),
                        *ops, nu_fits=nu_fits_b, fit_flags=flags,
                        log10_tau=log10_tau, scales=scales, dtype=self.dtype,
                        seed_phase=True, packed=True)
                else:
                    packed = fit_portrait_full_batch_packed(
                        xd, mft, *ops, nu_fits=nu_fits_b, fit_flags=flags,
                        log10_tau=log10_tau, scales=scales,
                        dtype=self.dtype, seed_phase=batch,
                        nu_outs=None if batch else nu_outs_of(items),
                        scattering=None if batch else bool(fit_scat))
                # one transfer per chunk (per batch shard on a mesh): the
                # result packed on the device
                host = unpack_result(packed, x.shape[1])
                dur = (time.time() - t0) / len(items)
                timing["fit_s"] += time.time() - t0
            timing["batched_chunks"] += int(batch)
            timing["fit_subints"] += len(items)
            timing["i2_subints"] += len(items) if scales is not None else 0
            timing["card_prep_subints"] += sum(p["raw_stats"]
                                               for _, p in items)
            for i, (iarch, p) in enumerate(items):
                results[(iarch, p["isub"])] = (
                    type(host)(*[v[i] for v in host]), dur)

        def nu_outs_of(items):
            """The user's output references per item; the tau reference is
            barycentric, the fit topocentric (pptoas.py:414)."""
            if nu_refs is None:
                return None
            outs = [None if nu is None else np.full(len(items), float(nu))
                    for nu in nu_refs]
            if bary and outs[2] is not None:
                outs[2] = outs[2] / np.array([p["doppler"]
                                              for _, p in items])
            return tuple(outs)

        def flush(key, final=False):
            items = buffers[key]
            if not items:
                return
            shape, x_itemsize = key[0], np.dtype(key[1]).itemsize
            chunk = _auto_fit_chunk(
                shape[0], shape[1], key[2].mr.shape[1], x_itemsize,
                4 if f32 else 8,
                [self.device] if mesh is None else
                [d for row in mesh.devices for d in row],
                1 if mesh is None else mesh.shape["batch"])
            while len(items) >= chunk or (final and items):
                fit_chunk(items[:chunk])
                del items[:chunk]

        def drain_assembly():
            nonlocal next_assemble
            while next_assemble < len(jobs):
                job = jobs[next_assemble]
                if any(p["batchable"] and
                       (next_assemble, p["isub"]) not in results
                       for p in job["preps"]):
                    return
                fit_fallback(next_assemble, job)
                with annotate("pp:toas.assemble"):
                    self._assemble_archive(
                        job, results, next_assemble, bary, fit_DM, fit_GM,
                        fit_scat, fix_alpha, print_phase, print_flux,
                        print_parangle, addtnl_toa_flags, timing,
                        nu_refs is not None)
                if show_plot:
                    for isub in self.ok_isubs[-1]:
                        self.show_fit(datafile=job["df"], isub=isub,
                                      show=True)
                for p in job["preps"]:
                    del results[(next_assemble, p["isub"])]
                jobs[next_assemble] = None      # assembled: release it
                next_assemble += 1

        for idf, df in enumerate(datafiles):
            with annotate("pp:toas.load"):
                job = prep_archive(idf, df)
            if job is None:
                continue
            self.ok_idatafiles.append(idf)
            iarch = len(jobs)
            jobs.append(job)
            for p in job["preps"]:
                if p["batchable"]:
                    key = (p["port"].shape, p["port"].dtype.str, p["tmpl"])
                    buffers.setdefault(key, []).append((iarch, p))
            for key in list(buffers):
                flush(key)
            drain_assembly()
        for key in list(buffers):
            flush(key, final=True)
        drain_assembly()
        timing["wall_s"] = time.time() - start_all
        self.mharms = templates.mharms
        if not quiet and self.TOA_list:
            med_err = np.median([t.TOA_error for t in self.TOA_list])
            print(f"\nFit {len(self.TOA_list)} TOAs in "
                  f"{timing['wall_s']:.2f} s; Med. TOA error is "
                  f"{med_err:.3f} us")

    def _assemble_archive(self, job, results, iarch, bary, fit_DM, fit_GM,
                          fit_scat, fix_alpha, print_phase, print_flux,
                          print_parangle, addtnl_toa_flags, timing,
                          user_refs=False):
        """TOAs and per-archive records from the fitted subints.  A
        subint whose fitted phase, DM or their errors are not finite is
        left out with a message, as a subint that cannot be fitted is."""
        t0 = time.time()
        df, data, DM0_arch = job["df"], job["data"], job["DM0_arch"]
        rec = {name: [] for name in self._PER_ARCHIVE}
        arch_duration = 0.0
        for prep in job["preps"]:
            isub, P, okc = prep["isub"], prep["P"], prep["okc"]
            freqsx = prep["freqs"][okc]
            res, duration = results[(iarch, isub)]
            arch_duration += duration
            fitted = (res.phi, res.DM, res.phi_err, res.DM_err)
            if not np.all(np.isfinite(np.asarray(fitted, np.float64))):
                print(f"Skipping {df} subint {isub}: the fit is not finite "
                      f"(phi {float(res.phi)}, DM {float(res.DM)}, errors "
                      f"{float(res.phi_err)}, {float(res.DM_err)}; return "
                      f"code {int(res.return_code)})")
                continue
            phi, DM_fit = prep["tmpl"].restore(res.phi, res.DM, res.nu_DM, P)
            phi_err = float(res.phi_err)
            GM_fit = float(res.GM)
            epoch = data.epochs[isub]
            toa_mjd = epoch.add_seconds((phi * P) + data.backend_delay)
            toa_err_us = phi_err * P * 1e6
            df_dop = data.doppler_factors[isub]
            if bary:
                DM_bary, GM_bary = DM_fit * df_dop, GM_fit * df_dop ** 3
            else:
                DM_bary, GM_bary = DM_fit, GM_fit
            scales_np = np.asarray(res.scales)
            scale_errs_np = np.asarray(res.scale_errs)
            # flux from the (scattered) model means x scales
            # (pptoas.py:554-576)
            model_means = prep["tmpl"].chan_means[okc]
            flux_vals = scales_np[okc] * model_means
            flux_errs_chan = np.abs(model_means) * scale_errs_np[okc]
            good = flux_errs_chan > 0
            if good.any():
                flux, flux_err = weighted_mean(flux_vals[good],
                                               flux_errs_chan[good])
                flux_freq, _ = weighted_mean(freqsx[good],
                                             flux_errs_chan[good])
            else:
                flux, flux_err, flux_freq = 0.0, 0.0, 0.0
            flags = dict(
                be=data.backend, fe=data.frontend,
                f=f"{data.frontend}_{data.backend}",
                nbin=data.nbin, nch=data.nchan, nchx=len(okc),
                bw=float(freqsx.max() - freqsx.min()),
                chbw=float(abs(data.bw) / data.nchan),
                subint=int(isub), tobs=float(data.subtimes[isub]),
                fratio=float(freqsx.max() / freqsx.min()),
                tmplt=self.modelfile, snr=float(res.snr))
            # raw phi-DM covariance only for user-pinned references with
            # both parameters fitted (pptoas.py:643-645)
            if user_refs and fit_DM:
                flags["phi_DM_cov"] = float(
                    np.asarray(res.covariance_matrix)[0, 1])
            flags["gof"] = float(res.red_chi2)
            if fit_GM:
                flags.update(gm=GM_bary, gm_err=float(res.GM_err))
            if fit_scat:
                # topocentric -> barycentric via the Doppler factor
                # (pptoas.py:615-627)
                tau_fit = (10.0 ** float(res.tau) if self.log10_tau
                           else float(res.tau))
                flags["scat_time"] = float(tau_fit * P / df_dop * 1e6)  # us
                if self.log10_tau:
                    flags["log10_scat_time"] = float(
                        float(res.tau) + np.log10(P / df_dop))
                    flags["log10_scat_time_err"] = float(res.tau_err)
                else:
                    flags["scat_time_err"] = float(
                        float(res.tau_err) * P / df_dop * 1e6)
                flags["scat_ref_freq"] = float(res.nu_tau) * df_dop
                flags["scat_ind"] = float(res.alpha)
                if not fix_alpha:
                    flags["scat_ind_err"] = float(res.alpha_err)
            if print_phase:
                flags.update(phs=phi, phs_err=phi_err)
            if print_flux:
                flags.update(flux=float(flux), flux_err=float(flux_err),
                             flux_ref_freq=float(flux_freq))
            if print_parangle:
                pa = _parallactic_angle_for(data, epoch)
                if pa == pa:  # not NaN
                    flags["par_angle"] = pa
            flags.update(addtnl_toa_flags)
            # no DM flags when DM was not fitted (pptoas.py:608-610)
            self.TOA_list.append(TOA(
                df, float(res.nu_DM), toa_mjd, toa_err_us, data.telescope,
                data.telescope_code, DM=DM_bary if fit_DM else None,
                DM_error=float(res.DM_err) if fit_DM else None,
                flags=flags))
            row = dict(
                ok_isubs=isub, epochs=epoch, MJDs=epoch.in_days(), Ps=P,
                phis=phi, phi_errs=phi_err, TOAs=toa_mjd, TOA_errs=toa_err_us,
                DMs=DM_bary, DM_errs=float(res.DM_err), GMs=GM_bary,
                GM_errs=float(res.GM_err), taus=float(res.tau),
                tau_errs=float(res.tau_err), alphas=float(res.alpha),
                alpha_errs=float(res.alpha_err), scales=scales_np,
                scale_errs=scale_errs_np, snrs=float(res.snr),
                channel_snrs=np.asarray(res.channel_snrs),
                fit_channel_red_chi2s=np.asarray(res.channel_red_chi2),
                fluxes=flux, flux_errs=flux_err,
                red_chi2s=float(res.red_chi2),
                covariances=np.asarray(res.covariance_matrix),
                nfevals=int(res.nfeval), rcs=int(res.return_code),
                nu_fits=np.array([prep["nu_fit"]] * 3),
                nu_refs=(float(res.nu_DM), float(res.nu_GM),
                         float(res.nu_tau)))
            for name, val in row.items():
                rec[name].append(val)
        # per-archive weighted-mean DeltaDM (pptoas.py:665-682)
        DMs_arr = np.asarray(rec["DMs"])
        DM_errs_arr = np.asarray(rec["DM_errs"])
        if len(DMs_arr) and DM_errs_arr.max() > 0:
            dm_mean, dm_err = weighted_mean(DMs_arr - DM0_arch, DM_errs_arr)
            resid = (DMs_arr - DM0_arch) - dm_mean
            if len(DMs_arr) > 1:
                dm_rchi2 = np.sum((resid / DM_errs_arr) ** 2) / \
                    (len(DMs_arr) - 1)
                dm_err *= max(1.0, dm_rchi2 ** 0.5)
        else:
            dm_mean, dm_err = 0.0, 0.0
        self.order.append(df)
        self.obs.append(data.telescope)
        self.nu0s.append(data.nu0)
        self.DM0s.append(DM0_arch)
        self.DeltaDM_means.append(dm_mean)
        self.DeltaDM_errs.append(dm_err)
        self.fit_durations.append(arch_duration)
        as_array = {"MJDs", "Ps", "phis", "phi_errs", "TOA_errs", "DMs",
                    "DM_errs", "GMs", "GM_errs", "taus", "tau_errs",
                    "alphas", "alpha_errs", "snrs", "fluxes",
                    "flux_errs", "red_chi2s", "nfevals", "rcs"}
        for name in self._PER_ARCHIVE:
            v = rec[name]
            getattr(self, name).append(np.asarray(v) if name in as_array
                                       else v)
        timing["assemble_s"] += time.time() - t0

    def show_fit(self, datafile=None, isub=0, rotate=True, savefig=False,
                 show=True, return_fit=False, quiet=None):
        """Residual diagnostic for one fitted subint: reloads the archive,
        rebuilds the scattered and scaled model at the subint's
        frequencies, rotates the data by the fitted (phi, DM, GM) on this
        GetTOAs' device, and draws data, model and residual panels
        (viz.show_residual_plot; show and savefig need matplotlib).
        return_fit: return (port, scaled_model, phases, freqs, errs), host
        numpy.  Reference: pptoas.py:1287-1419."""
        datafile = datafile or self.order[0]
        iarch = self.order.index(datafile)
        ii = list(self.ok_isubs[iarch]).index(isub)
        data = load_data(datafile, dedisperse=False, dededisperse=True,
                         pscrunch=True, rm_baseline=True, quiet=True)
        P, freqs = data.Ps[isub], data.freqs[isub]
        port = np.array(data.subints[isub, 0], dtype=np.float64)
        model = self.model_source.eval(data.phases, freqs, P)
        # stored DMs are barycentric when get_TOAs ran with bary
        df_dop = data.doppler_factors[isub] if getattr(self, "bary",
                                                       True) else 1.0
        DM = self.DMs[iarch][ii] / df_dop
        GM = self.GMs[iarch][ii] / df_dop ** 3
        nu_DM, nu_GM, nu_tau = self.nu_refs[iarch][ii]
        tau = self.taus[iarch][ii]
        tau_lin = 10.0 ** tau if getattr(self, "log10_tau", False) else tau
        taus = scattering_times(tau_lin, self.alphas[iarch][ii], freqs,
                                nu_tau)
        scat_model = np.fft.irfft(
            scattering_portrait_FT_np(taus, data.nbin) *
            np.fft.rfft(model, axis=-1), n=data.nbin, axis=-1)
        scaled_model = scat_model * np.asarray(self.scales[iarch][ii])[:, None]
        if rotate:
            port = rotate_portrait_full(
                port, self.phis[iarch][ii], DM, GM, freqs, nu_DM, nu_GM,
                P=P, device=self.device).cpu().numpy()
        errs = np.where(data.weights[isub] > 0, data.noise_stds[isub, 0],
                        0.0)
        if show or savefig:
            from pulseportraiture_tpu_torch.viz import show_residual_plot
            show_residual_plot(port, scaled_model, phases=data.phases,
                               freqs=freqs, errs=errs,
                               title=f"{datafile} subint {isub}",
                               savefig=savefig, show=show)
        if return_fit:
            return port, scaled_model, data.phases, freqs, errs
        return None

    show_subint = show_fit

    def get_channels_to_zap(self, SNR_threshold=8.0, rchi2_threshold=1.3,
                            iterate=True, show=False):
        """Channels to zap per archive and subint, from the stored fits: a
        reduced chi2 above rchi2_threshold (or NaN), or an S/N below
        (SNR_threshold^2 / nchan_live)^1/2, iterated as channels drop.
        The fast path reads the per-channel reduced chi2 that the fit
        computed on the device (each chunk's result left the card in one
        transfer); a subint without it goes through show_fit and the
        time domain.  Fills and returns self.zap_channels.
        show: draw each subint with channels to zap, rotated by its fit,
        titled with them (viz.show_portrait; needs matplotlib).  Reference:
        pptoas.py:1208-1285."""
        self.zap_channels = []
        self.channel_red_chi2s = []
        for iarch, df in enumerate(self.order):
            arch_zaps, arch_rchi2s = [], []
            stored = self.fit_channel_red_chi2s[iarch] \
                if iarch < len(self.fit_channel_red_chi2s) else []
            for ii, isub in enumerate(self.ok_isubs[iarch]):
                rc_all = stored[ii] if ii < len(stored) else None
                if rc_all is not None:
                    rc_all = np.asarray(rc_all, dtype=np.float64)
                    okc = np.where(rc_all > 0.0)[0]
                else:
                    port, scaled_model, _, _, errs = self.show_fit(
                        datafile=df, isub=isub, rotate=True, show=False,
                        return_fit=True, quiet=True)
                    okc = np.where(errs > 0)[0]
                    rc_all = np.zeros(len(errs))
                    rc_all[okc] = np.sum(
                        ((port[okc] - scaled_model[okc]) /
                         errs[okc, None]) ** 2, axis=-1) / \
                        (port.shape[1] - 2)
                snr = np.asarray(self.channel_snrs[iarch][ii])[okc]
                rc = rc_all[okc]
                low = np.zeros(len(okc), bool)
                if SNR_threshold:
                    low = snr < (SNR_threshold ** 2 / max(len(okc), 1)) ** 0.5
                bad = (rc > rchi2_threshold) | np.isnan(rc) | low
                if iterate and SNR_threshold and bad.any():
                    # the threshold rises as channels drop
                    # (pptoas.py:1260-1276)
                    while len(okc) > bad.sum():
                        thresh = (SNR_threshold ** 2 /
                                  (len(okc) - bad.sum())) ** 0.5
                        new = ~bad & (snr < thresh)
                        if not new.any():
                            break
                        bad |= new
                rchi2s = rc.tolist()
                bad = [int(c) for c in okc[bad]]
                arch_rchi2s.append(rchi2s)
                arch_zaps.append(bad)
                if show and bad:
                    from pulseportraiture_tpu_torch.viz import show_portrait
                    port = self.show_fit(datafile=df, isub=isub, rotate=True,
                                         show=False, return_fit=True,
                                         quiet=True)[0]
                    show_portrait(port, title=f"{df} subint {isub} "
                                  f"bad chans: {bad}")
            self.zap_channels.append(arch_zaps)
            self.channel_red_chi2s.append(arch_rchi2s)
        return self.zap_channels

    def _load_dispersed(self, df, tscrunch, quiet, stats_device=None):
        """An archive in its dispersed state, as the TOA fits take it
        (pptoas.py:812-826); None, with a message, when it cannot load."""
        try:
            return load_data(df, dedisperse=False, dededisperse=True,
                             tscrunch=tscrunch, pscrunch=True,
                             rm_baseline=True, quiet=quiet,
                             stats_device=stats_device)
        except (OSError, ValueError, KeyError, EOFError) as exc:
            print(f"Skipping {df}: could not load ({exc})")
            return None

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def get_narrowband_TOAs(self, datafile=None, tscrunch=False,
                            fit_scat=False, log10_tau=True, scat_guess=None,
                            print_phase=False, print_flux=False,
                            print_parangle=False, addtnl_toa_flags=None,
                            quiet=None):
        """Per-channel (narrowband) TOAs by batched FFTFIT.

        Every live channel of a subint goes through one
        fit_phase_shift_batch call on the device (the reference loops
        fit_phase_shift over channels, pptoas.py:745-1131).  fit_scat also
        fits a scattering time per channel: a batch of single-channel
        (phi, tau) portrait fits started from the FFTFIT phases, each
        referenced at its own channel's frequency.  TOAs carry no DM;
        flags follow pptoas.py:1060-1087 (chan instead of nch/nchx;
        scat_time and scat_time_err when fit_scat).
        """
        quiet = self.quiet if quiet is None else quiet
        datafiles = [datafile] if datafile is not None else self.datafiles
        addtnl_toa_flags = addtnl_toa_flags or {}
        sg = scat_guess or _DEFAULT_SCAT_GUESS
        f32 = self.dtype == torch.float32
        timing = {"load_s": 0.0, "fit_s": 0.0, "assemble_s": 0.0,
                  "wall_s": 0.0}
        self.fit_timing = timing
        start_all = time.time()
        ntoa = 0
        for df in datafiles:
            t0 = time.time()
            data = self._load_dispersed(df, tscrunch, quiet)
            timing["load_s"] += time.time() - t0
            if data is None:
                continue
            nbin = data.nbin
            for isub in data.ok_isubs:
                P, freqs = data.Ps[isub], data.freqs[isub]
                okc = data.ok_ichans[isub]
                if not len(okc):
                    continue
                t0 = time.time()
                model = self.model_source.eval(data.phases, freqs, P)[okc]
                timing["load_s"] += time.time() - t0
                t0 = time.time()
                nchx = len(okc)
                x = self._dev(data.subints[isub, 0][okc])
                noise = self._dev(data.noise_stds[isub, 0][okc])
                res = fit_phase_shift_batch(x, self._dev(model), noise=noise)
                taus_np = tau_errs_np = None
                if fit_scat:
                    tau0 = (sg[0] / P) * (freqs[okc] / sg[1]) ** sg[2]
                    init = np.zeros((nchx, 5))
                    init[:, 3] = np.log10(np.maximum(tau0, 1e-12)) \
                        if log10_tau else tau0
                    init[:, 4] = sg[2]
                    init = self._dev(init)
                    init[:, 0] = res.phase
                    mr, mi, _ = fit_spectrum(model, nbin, f32)
                    nu = self._dev(freqs[okc])
                    bres = fit_portrait_full_batch(
                        x[:, None, :],
                        (self._dev(mr)[:, None, :], self._dev(mi)[:, None, :]),
                        init, torch.full_like(nu, P), nu[:, None],
                        noise[:, None], nu_fits=nu[:, None].expand(nchx, 3),
                        fit_flags=(1, 0, 0, 1, 0), log10_tau=log10_tau,
                        dtype=self.dtype, seed_phase=False)
                    host = [v.cpu().numpy() for v in (
                        bres.phi, bres.phi_err, bres.scales[:, 0],
                        bres.scale_errs[:, 0], bres.snr, bres.red_chi2,
                        bres.tau, bres.tau_err)]
                    taus_np, tau_errs_np = host[6:]
                else:
                    host = [v.cpu().numpy() for v in res]
                phases, phase_errs, scales, scale_errs, snrs, gofs = host[:6]
                timing["fit_s"] += time.time() - t0
                t0 = time.time()
                model_means = model.mean(-1)
                epoch = data.epochs[isub]
                for ix, ichan in enumerate(okc):
                    toa_mjd = epoch.add_seconds(
                        phases[ix] * P + data.backend_delay)
                    flags = dict(
                        be=data.backend, fe=data.frontend,
                        f=f"{data.frontend}_{data.backend}", nbin=nbin,
                        bw=float(abs(data.bw) / data.nchan),
                        subint=int(isub), chan=int(ichan),
                        tobs=float(data.subtimes[isub]),
                        tmplt=self.modelfile, snr=float(snrs[ix]),
                        gof=float(gofs[ix]))
                    if taus_np is not None:
                        # per-channel scattering flags (pptoas.py:997-1010)
                        t_lin = 10.0 ** taus_np[ix] if log10_tau \
                            else taus_np[ix]
                        t_err = (np.log(10.0) * t_lin * tau_errs_np[ix]
                                 if log10_tau else tau_errs_np[ix])
                        flags["scat_time"] = float(t_lin * P * 1e6)
                        flags["scat_time_err"] = float(t_err * P * 1e6)
                    if print_phase:
                        flags["phs"] = float(phases[ix])
                        flags["phs_err"] = float(phase_errs[ix])
                    if print_flux:
                        flags["flux"] = float(scales[ix] * model_means[ix])
                        flags["flux_err"] = float(
                            abs(scale_errs[ix]) * model_means[ix])
                    if print_parangle:
                        pa = _parallactic_angle_for(data, epoch)
                        if pa == pa:
                            flags["par_angle"] = pa
                    flags.update(addtnl_toa_flags)
                    self.TOA_list.append(TOA(
                        df, float(freqs[ichan]), toa_mjd,
                        float(phase_errs[ix] * P * 1e6), data.telescope,
                        data.telescope_code, flags=flags))
                    ntoa += 1
                timing["assemble_s"] += time.time() - t0
        timing["wall_s"] = time.time() - start_all
        if not quiet and ntoa:
            print(f"\nFit {ntoa} narrowband TOAs in {timing['wall_s']:.2f} s "
                  f"(~{timing['fit_s'] / ntoa:.4f} sec/TOA fit)")

    def get_psrchive_TOAs(self, datafile=None, tscrunch=False,
                          algorithm="PGS", toa_format="Tempo2",
                          flags="IPTA", attributes=("chan", "subint"),
                          quiet=None):
        """Narrowband TOAs in the style of PSRCHIVE's ArrivalTime.

        The reference shells into PSRCHIVE's `pat -A <algorithm>`
        (pptoas.py:1133-1206); here the estimators are native and batched
        (fitters/arrival_time.py): PGS, FDM, SIS, PIS, GIS and COF.  The
        pat-style tempo2 lines of each archive are appended to
        self.psrchive_toas; the TOA objects are returned.
        """
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} not supported; one of "
                             f"{ALGORITHMS}")
        if toa_format.lower() not in ("tempo2",):
            raise ValueError("only tempo2 format is supported")
        quiet = self.quiet if quiet is None else quiet
        datafiles = [datafile] if datafile is not None else self.datafiles
        toa_objs = []
        for df in datafiles:
            data = self._load_dispersed(df, tscrunch, quiet)
            if data is None:
                continue
            lines = []
            for isub in data.ok_isubs:
                P, freqs = data.Ps[isub], data.freqs[isub]
                okc = data.ok_ichans[isub]
                if not len(okc):
                    continue
                model = self.model_source.eval(data.phases, freqs, P)
                res = arrival_time_shifts(
                    self._dev(data.subints[isub, 0][okc]),
                    self._dev(model[okc]),
                    noise=self._dev(data.noise_stds[isub, 0][okc]),
                    algorithm=algorithm)
                shifts, shift_errs, _, snrs = (v.cpu().numpy() for v in res)
                epoch = data.epochs[isub]
                for ix, ichan in enumerate(okc):
                    toa_mjd = epoch.add_seconds(
                        shifts[ix] * P + data.backend_delay)
                    toa_err_us = shift_errs[ix] * P * 1e6
                    fl = {}
                    if flags == "IPTA":
                        fl = dict(fe=data.frontend, be=data.backend,
                                  f=f"{data.frontend}_{data.backend}",
                                  tmplt=self.modelfile, gof=1.0,
                                  nbin=data.nbin, snr=float(snrs[ix]))
                    if "chan" in attributes:
                        fl["chan"] = int(ichan)
                    if "subint" in attributes:
                        fl["subint"] = int(isub)
                    toa_objs.append(TOA(
                        df, float(freqs[ichan]), toa_mjd, float(toa_err_us),
                        data.telescope, data.telescope_code, flags=fl))
                    flag_s = " ".join(f"-{k} {v}" for k, v in fl.items())
                    lines.append(
                        f"{df} {float(freqs[ichan]):.6f} "
                        f"{toa_mjd.day_fracstr(15)} {toa_err_us:.3f} "
                        f"{data.telescope_code} {flag_s}".rstrip())
            self.psrchive_toas.append(lines)
        return toa_objs
