"""Port parity: the host helpers that zap, align, DataPortrait and sim are
built on, each against its JAX function in float64 on the CPU, on inputs
made with numpy from a seed.

ops/transform (phasor, guess_fit_freq, GM_from_DMc, DMc_from_GM,
calculate_TOA), ops/noise (get_noise_fit, _find_kc, get_noise,
get_red_chi2), ops/normalize, ops/rotate (six functions), ops/scattering
(scattering_kernel, add_scattering), utils (count_crossings, get_WRMS),
io/archive (unload_new_archive, write_archive) and fitters/portrait
(fit_portrait_full, fit_portrait, pack_result, unpack_result,
fit_portrait_full_batch_packed).  Values within 1e-10 relative (1e-12
where the arithmetic is the same), fitted parameters within 1e-7 of
their errors.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import pulseportraiture_tpu.fitters.portrait as jpo  # noqa: E402
import pulseportraiture_tpu.io.archive as jar  # noqa: E402
import pulseportraiture_tpu.ops.noise as jno  # noqa: E402
import pulseportraiture_tpu.ops.normalize as jnm  # noqa: E402
import pulseportraiture_tpu.ops.rotate as jro  # noqa: E402
import pulseportraiture_tpu.ops.scattering as jsc  # noqa: E402
import pulseportraiture_tpu.ops.transform as jtr  # noqa: E402
import pulseportraiture_tpu.utils as jut  # noqa: E402
import pulseportraiture_tpu_torch.fitters.portrait as po  # noqa: E402
import pulseportraiture_tpu_torch.io.archive as ar  # noqa: E402
import pulseportraiture_tpu_torch.ops.noise as no  # noqa: E402
import pulseportraiture_tpu_torch.ops.normalize as nm  # noqa: E402
import pulseportraiture_tpu_torch.ops.rotate as ro  # noqa: E402
import pulseportraiture_tpu_torch.ops.scattering as sc  # noqa: E402
import pulseportraiture_tpu_torch.ops.transform as tr  # noqa: E402
import pulseportraiture_tpu_torch.utils as ut  # noqa: E402
from pulseportraiture_tpu.io.mjd import MJD as JMJD  # noqa: E402
from pulseportraiture_tpu_torch.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu_torch.io.psrfits import read_psrfits  # noqa: E402

from torch_parity_utils import (injected_batch, mjd_diff_s,  # noqa: E402
                                rel_err)

torch.set_num_threads(2)
CPU = "cpu"
NCHAN, NBIN = 16, 128


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _port(seed=0):
    d = injected_batch(B=1, nchan=NCHAN, nbin=NBIN, seed=seed)
    return d["data"][0], d["model"], d["freqs"], d["P"]


def case_phasor(rng):
    phis = rng.uniform(-2.0, 2.0, (3, 5))
    return [(tr.phasor(phis, 17, device=CPU), jtr.phasor(phis, 17), 1e-12)]


def case_guess_fit_freq(rng):
    freqs = np.sort(rng.uniform(1100.0, 1900.0, 24))
    snrs = rng.uniform(1.0, 30.0, 24)
    return [(tr.guess_fit_freq(freqs, device=CPU),
             jtr.guess_fit_freq(freqs), 1e-12),
            (tr.guess_fit_freq(freqs, snrs, device=CPU),
             jtr.guess_fit_freq(freqs, snrs), 1e-12)]


def case_GM_from_DMc_and_inverse(rng):
    DMc, D, a = rng.uniform(1e-4, 1e-2), rng.uniform(0.1, 2.0), \
        rng.uniform(0.1, 10.0)
    gm = tr.GM_from_DMc(DMc, D, a)
    return [(gm, jtr.GM_from_DMc(DMc, D, a), 1e-12),
            (tr.DMc_from_GM(gm, D, a), jtr.DMc_from_GM(gm, D, a), 1e-12),
            (tr.DMc_from_GM(gm, D, a), DMc, 1e-12)]


def case_calculate_TOA(rng):
    P, phi, DM = 0.0031, rng.uniform(-0.5, 0.5), 30.0
    got = tr.calculate_TOA(MJD(57000, 1234, 0.25), P, phi, DM, 1400.0,
                           1500.0)
    want = jtr.calculate_TOA(JMJD(57000, 1234, 0.25), P, phi, DM, 1400.0,
                             1500.0)
    return [(mjd_diff_s(got, want), 0.0, 1e-12)]


def case_get_noise_fit_and_find_kc(rng):
    data, _, _, _ = _port()
    pows = np.abs(np.fft.rfft(data[3])) ** 2 / NBIN
    return [(no._find_kc(pows), jno._find_kc(pows), 0.0),
            (no.get_noise_fit(data, chans=True),
             jno.get_noise_fit(data, chans=True), 1e-12),
            (no.get_noise_fit(data), jno.get_noise_fit(data), 1e-12)]


def case_get_noise(rng):
    data, _, _, _ = _port()
    return [(no.get_noise(data, method=m, chans=True),
             jno.get_noise(data, method=m, chans=True), 1e-12)
            for m in ("PS", "fit")]


def case_get_red_chi2(rng):
    data, model, _, _ = _port()
    errs = rng.uniform(0.05, 0.2, NCHAN)
    return [(no.get_red_chi2(data, model, device=CPU),
             jno.get_red_chi2(data, model), 1e-10),
            (no.get_red_chi2(data, model, errs=errs, dof=NBIN - 2,
                             device=CPU),
             jno.get_red_chi2(data, model, errs=errs, dof=NBIN - 2), 1e-12),
            (no.get_red_chi2(data[2], model[2], errs=0.1, device=CPU),
             jno.get_red_chi2(data[2], model[2], errs=0.1), 1e-12)]


def case_normalize_portrait(rng):
    data, _, _, _ = _port()
    data[4] = 0.0                                   # a dead channel
    w = rng.uniform(0.5, 1.0, NCHAN)
    out = []
    for method in ("mean", "max", "rms", "abs", "prof"):
        got = nm.normalize_portrait(data, method=method, weights=w,
                                    return_norms=True, device=CPU)
        want = jnm.normalize_portrait(jnp.asarray(data), method=method,
                                      weights=jnp.asarray(w),
                                      return_norms=True)
        tol = 1e-7 if method == "prof" else 1e-12
        out += [(got[0], want[0], tol), (got[1], want[1], tol)]
    return out


def case_rotate(rng):
    data, _, freqs, P = _port()
    cube = rng.normal(size=(2, 1, NCHAN, NBIN))
    Ps = np.array([P, 1.0001 * P])
    ph, DM, GM = rng.uniform(-0.3, 0.3), 0.05, 2e-4
    return [
        (ro.rotate_profile(data[0], ph, device=CPU),
         jro.rotate_profile(jnp.asarray(data[0]), ph), 1e-12),
        (ro.rotate_portrait(data, ph, device=CPU),
         jro.rotate_portrait(jnp.asarray(data), ph), 1e-12),
        (ro.rotate_portrait(data, ph, DM, P, freqs, 1500.0, device=CPU),
         jro.rotate_portrait(jnp.asarray(data), ph, DM, P,
                             jnp.asarray(freqs), 1500.0), 1e-10),
        (ro.rotate_portrait_full(data, ph, DM, GM, freqs, 1400.0, 1450.0,
                                 P, device=CPU),
         jro.rotate_portrait_full(jnp.asarray(data), ph, DM, GM,
                                  jnp.asarray(freqs), 1400.0, 1450.0, P),
         1e-10),
        (ro.rotate_data(data[0], ph, device=CPU),
         jro.rotate_data(jnp.asarray(data[0]), ph), 1e-12),
        (ro.rotate_data(data, ph, DM, P, freqs, device=CPU),
         jro.rotate_data(jnp.asarray(data), ph, DM, P, jnp.asarray(freqs)),
         1e-10),
        (ro.rotate_data(cube, ph, DM, Ps, freqs, 1500.0, device=CPU),
         jro.rotate_data(jnp.asarray(cube), ph, DM, Ps, jnp.asarray(freqs),
                         1500.0), 1e-10),
        (ro.fft_rotate(data[1], 3.3, device=CPU),
         jro.fft_rotate(jnp.asarray(data[1]), 3.3), 1e-12),
        (ro.add_DM_nu(data, ph, DM, P, freqs, xs=(-2.0, -2.2),
                      Cs=(1.0, 0.3), nu_ref=1500.0, device=CPU),
         jro.add_DM_nu(jnp.asarray(data), ph, DM, P, jnp.asarray(freqs),
                       xs=(-2.0, -2.2), Cs=(1.0, 0.3), nu_ref=1500.0),
         1e-10)]


def case_scattering_kernel_and_add_scattering(rng):
    data, _, freqs, P = _port()
    phases = (np.arange(NBIN) + 0.5) / NBIN
    got_k = sc.scattering_kernel(2e-4, 1500.0, freqs, phases, P,
                                 device=CPU)
    want_k = jsc.scattering_kernel(2e-4, 1500.0, jnp.asarray(freqs),
                                   jnp.asarray(phases), P)
    return [(got_k, want_k, 1e-12),
            (sc.scattering_kernel(0.0, 1500.0, freqs, phases, P,
                                  device=CPU),
             jsc.scattering_kernel(0.0, 1500.0, jnp.asarray(freqs),
                                   jnp.asarray(phases), P), 0.0),
            (sc.add_scattering(data, _np(got_k), device=CPU),
             jsc.add_scattering(jnp.asarray(data), want_k), 1e-10)]


def case_count_crossings_and_get_WRMS(rng):
    x = rng.normal(size=200)
    x[17] = 0.25
    errs = rng.uniform(0.5, 2.0, 200)
    errs[5] = 0.0
    return [(ut.count_crossings(x, 0.25), jut.count_crossings(x, 0.25), 0.0),
            (ut.get_WRMS(x, errs), jut.get_WRMS(x, errs), 1e-12),
            (ut.get_WRMS(x), jut.get_WRMS(x), 1e-12)]


def case_archive_writers(rng, tmp_path):
    par = tmp_path / "h.par"
    par.write_text("PSR J0000+0001\nRAJ 01:02:03.4\nDECJ -04:05:06.7\n"
                   "F0 345.6789\nPEPOCH 50000\nDM 20.5\n")
    data = rng.normal(size=(2, 1, NCHAN, 64))
    freqs = np.linspace(1200.0, 1800.0, NCHAN)
    w = np.ones((2, NCHAN))
    w[1, 3] = 0.0
    out = []
    for dd in (False, True):
        a, b = str(tmp_path / f"p{dd}.fits"), str(tmp_path / f"j{dd}.fits")
        ar.write_archive(data, str(par), freqs, outfile=a, weights=w,
                         dedispersed=dd, start_MJD=MJD(57000), quiet=True)
        jar.write_archive(data, str(par), freqs, outfile=b, weights=w,
                          dedispersed=dd, start_MJD=JMJD(57000), quiet=True)
        ga, gb = read_psrfits(a), read_psrfits(b)
        out += [(ga.data, gb.data, 1e-12), (ga.weights, gb.weights, 0.0),
                (ga.Ps, gb.Ps, 1e-15), (ga.DM, gb.DM, 0.0)]
        # new amplitudes and weights into a copy (the zap tool's writer)
        la = ar.load_data(a, quiet=True)
        lb = jar.load_data(b, quiet=True)
        w2 = w.copy()
        w2[0, 7] = 0.0
        a2, b2 = a + ".new", b + ".new"
        ar.unload_new_archive(2.0 * la.subints, la.arch, a2, DM=la.DM,
                              dmc=int(la.dmc), weights=w2, quiet=True)
        jar.unload_new_archive(2.0 * lb.subints, lb.arch, b2, DM=lb.DM,
                               dmc=int(lb.dmc), weights=w2, quiet=True)
        ga, gb = read_psrfits(a2), read_psrfits(b2)
        out += [(ga.data, gb.data, 1e-12), (ga.weights, gb.weights, 0.0)]
    return out


def case_fit_portrait_full(rng):
    d = injected_batch(B=1, nchan=NCHAN, nbin=NBIN, seed=4, tau=3e-3)
    init = np.array([d["phis"][0] + 2e-4, 0.0, 0.0, np.log10(2e-3), -4.0])
    out = []
    for ff, is_toa in (((1, 1, 0, 1, 0), True), ((1, 1, 1, 0, 0), True),
                       ((1, 0, 1, 0, 0), False)):
        got, dur = po.fit_portrait_full(
            d["data"][0], d["model"], init, d["P"], d["freqs"],
            errs=d["errs"][0], fit_flags=ff, is_toa=is_toa, device=CPU)
        want, _ = jpo.fit_portrait_full(
            jnp.asarray(d["data"][0]), jnp.asarray(d["model"]),
            jnp.asarray(init), d["P"], jnp.asarray(d["freqs"]),
            errs=jnp.asarray(d["errs"][0]), fit_flags=ff, is_toa=is_toa)
        assert dur >= 0.0
        errs = np.asarray(want.param_errs)
        idx = np.flatnonzero(ff)
        out += [(_np(got.params)[idx] / errs[idx],
                 np.asarray(want.params)[idx] / errs[idx], 1e-7)]
        out += [(getattr(got, n), getattr(want, n), 1e-7) for n in (
            "param_errs", "nu_DM", "nu_GM", "nu_tau", "scales", "red_chi2")]
    return out


def case_fit_portrait(rng):
    d = injected_batch(B=1, nchan=NCHAN, nbin=NBIN, seed=6)
    init = [d["phis"][0] + 1e-3, 0.0]
    got = po.fit_portrait(d["data"][0], d["model"], init, d["P"],
                          d["freqs"], errs=d["errs"][0], device=CPU)
    want = jpo.fit_portrait(jnp.asarray(d["data"][0]),
                            jnp.asarray(d["model"]), init, d["P"],
                            jnp.asarray(d["freqs"]),
                            errs=jnp.asarray(d["errs"][0]))
    pe, de = float(want.phase_err), float(want.DM_err)
    out = [(float(got.phase) / pe, float(want.phase) / pe, 1e-7),
           (float(got.DM) / de, float(want.DM) / de, 1e-7)]
    out += [(got[n], want[n], 1e-7) for n in (
        "phase_err", "DM_err", "scales", "scale_errs", "nu_ref", "chi2",
        "red_chi2", "snr")]
    # the phase-DM covariance vanishes at nu_ref: its correlation, absolute
    out += [(float(got.covariance) / (pe * de) -
             float(want.covariance) / (pe * de), 0.0, 1e-9)]
    return out


def case_pack_and_unpack_result(rng):
    d = injected_batch(B=2, nchan=NCHAN, nbin=NBIN, seed=2)
    args = (torch.from_numpy(d["data"]), po.template_spectrum(d["model"]),
            torch.zeros(2, 5, dtype=torch.float64),
            torch.full((2,), d["P"], dtype=torch.float64),
            torch.from_numpy(d["freqs"]), torch.from_numpy(d["errs"]))
    res = po.fit_portrait_full_batch(*args)
    packed = po.fit_portrait_full_batch_packed(*args)
    back = po.unpack_result(packed, NCHAN)
    # the JAX package's unpacking reads the port's packing
    jback = jpo.unpack_result(_np(po.pack_result(res)), NCHAN)
    out = [(packed, po.pack_result(res), 0.0)]
    for name in res._fields:
        out.append((getattr(back, name), getattr(res, name), 0.0))
        out.append((getattr(jback, name), getattr(res, name), 0.0))
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_helper_matches_jax(name, tmp_path):
    fn = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    pairs = fn(rng, tmp_path) if "tmp_path" in \
        fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn(rng)
    for i, (got, want, tol) in enumerate(pairs):
        g, w = _np(got), _np(want)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert rel_err(g, w) <= tol, (i, rel_err(g, w), tol)
