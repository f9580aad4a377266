"""Port parity: the spline builder (models.spline pca,
reconstruct_portrait, find_significant_eigvec, fit_parametric_spline,
gen_spline_portrait, _fourier_resample; models.spline_io write and
coords) against the JAX package's, float64 on the CPU, on a seeded
32 x 256 portrait whose profile evolves with frequency.

Tolerances: PCA eigenvalues 1e-10 relative and |eigvec . eigvec_ref|
within 1e-10 of 1 (eigenvector signs are the solver's); the same
significant eigenvectors; spline knots 1e-12, coefficients and fp 1e-9
relative; portraits 1e-12 of their largest value.
"""

import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.models import spline as js  # noqa: E402
from pulseportraiture_tpu.models import spline_io as jio  # noqa: E402
from pulseportraiture_tpu_torch.models import spline as ts  # noqa: E402
from pulseportraiture_tpu_torch.models import spline_io as tio  # noqa: E402

torch.set_num_threads(2)
NCHAN, NBIN = 32, 256


@pytest.fixture(scope="module")
def port():
    """An evolving two-component portrait + noise, its frequencies and
    the PCA weights."""
    rng = np.random.default_rng(5)
    freqs = np.linspace(1100.0, 1900.0, NCHAN)
    x = (np.arange(NBIN) + 0.5) / NBIN
    r = (freqs / 1500.0)[:, None]
    prof = np.exp(-0.5 * ((x - 0.4) / (0.02 * r ** -0.5)) ** 2) + \
        0.5 * r ** 1.5 * np.exp(-0.5 * ((x - 0.47 - 0.01 * (r - 1)) /
                                         0.01) ** 2)
    data = prof + rng.normal(0.0, 0.02, (NCHAN, NBIN))
    w = rng.uniform(0.5, 1.5, NCHAN)
    return data, freqs, w / w.sum()


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) /
                 np.max(np.abs(want)))


@pytest.fixture(scope="module")
def pcas(port):
    data, _, w = port
    mean = (data * w[:, None]).sum(0) / w.sum()
    want = js.pca(data, mean, w)
    got = ts.pca(data, mean, w, device="cpu")
    return mean, want, got


def test_pca_matches_jax(pcas):
    _, (jval, jvec), (tval, tvec) = pcas
    tval, tvec = tval.numpy(), tvec.numpy()
    assert np.max(np.abs(tval - jval) / np.abs(jval[0])) <= 1e-10
    # the leading, well separated components (noise eigenvalues are
    # near-degenerate, so their vectors are not unique)
    for i in range(3):
        assert abs(abs(np.dot(tvec[:, i], jvec[:, i])) - 1.0) <= 1e-10


def test_reconstruct_portrait_matches_jax(port, pcas):
    data = port[0]
    mean, (_, jvec), _ = pcas
    want = np.asarray(js.reconstruct_portrait(data, mean, jvec[:, :3]))
    assert rel(ts.reconstruct_portrait(data, mean, jvec[:, :3],
                                       device="cpu"), want) <= 1e-12


def test_find_significant_eigvec_matches_jax(pcas):
    _, (_, jvec), (_, tvec) = pcas
    jieig, jsm = js.find_significant_eigvec(jvec, snr_cutoff=50.0,
                                            try_nlevels=2)
    tieig, tsm = ts.find_significant_eigvec(tvec, snr_cutoff=50.0,
                                            try_nlevels=2, device="cpu")
    assert len(jieig) >= 1 and list(tieig) == list(jieig)
    for i in jieig:      # smoothed vectors up to the solver's sign
        s = np.sign(np.dot(tsm[:, i], jsm[:, i]))
        assert rel(s * tsm[:, i], jsm[:, i]) <= 1e-12
    jnone = js.find_significant_eigvec(jvec, snr_cutoff=1e9,
                                       return_smooth=False, try_nlevels=2)
    tnone = ts.find_significant_eigvec(tvec, snr_cutoff=1e9,
                                       return_smooth=False, try_nlevels=2,
                                       device="cpu")
    assert len(jnone) == len(tnone) == 0


@pytest.mark.parametrize("frac", [0.5, 2.0])
def test_fit_parametric_spline_matches_jax(port, pcas, frac):
    """s = frac x the knot-free fit's fp: 0.5 inserts knots until fp <= s,
    then bisects the ridge onto s; 2 keeps the knot-free fit."""
    data, freqs, w = port
    mean, (_, jvec), _ = pcas
    proj = (data - mean) @ jvec[:, :2]
    s = frac * js.fit_parametric_spline(freqs, proj.T, weights=w,
                                        s=1e9)[1]
    (jt, jc, jk), jfp = js.fit_parametric_spline(freqs, proj.T, weights=w,
                                                 s=s)
    (tt, tc, tk), tfp = ts.fit_parametric_spline(freqs, proj.T, weights=w,
                                                 s=s)
    assert tk == jk and len(tt) == len(jt)
    assert np.max(np.abs(tt - np.asarray(jt))) <= 1e-12 * np.max(freqs)
    assert rel(tc, jc) <= 1e-9
    assert abs(tfp - jfp) <= 1e-9 * abs(jfp)
    if frac < 1:
        assert len(tt) > 8 and abs(tfp - s) <= 1e-6 * s   # bisected onto s
    else:
        assert len(tt) == 8


@pytest.mark.parametrize("nbin", [None, 128, 512])
def test_gen_spline_portrait_matches_jax(port, pcas, nbin):
    data, freqs, w = port
    mean, (_, jvec), _ = pcas
    proj = (data - mean) @ jvec[:, :2]
    tck, _ = js.fit_parametric_spline(freqs, proj.T, weights=w, s=0.5)
    tck = tuple(np.asarray(v) if i < 2 else v for i, v in enumerate(tck))
    new = np.linspace(1050.0, 1950.0, 20)      # extrapolates at the edges
    want = np.asarray(js.gen_spline_portrait(mean, new, jvec[:, :2], tck,
                                             nbin=nbin))
    got = ts.gen_spline_portrait(mean, new, jvec[:, :2], tck, nbin=nbin,
                                 device="cpu")
    assert rel(got, want) <= 1e-12
    assert ts.gen_spline_portrait(mean, new, jvec[:, :0], tck,
                                  device="cpu").shape == (20, NBIN)


@pytest.mark.parametrize("fmt", ["pickle", "npz"])
def test_spline_model_files_cross_read(tmp_path, port, pcas, fmt):
    """A model the port writes, the JAX reader reads, and the other way
    round; get_spline_model_coords agrees."""
    data, freqs, w = port
    mean, (_, jvec), _ = pcas
    proj = (data - mean) @ jvec[:, :2]
    (t, c, k), _ = ts.fit_parametric_spline(freqs, proj.T, weights=w, s=0.5)
    ext = ".spl.npz" if fmt == "npz" else ".spl"
    mine, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    tio.write_spline_model(mine, "M", "J0", "d.fits", t64(mean),
                           t64(jvec[:, :2]), (t, c, k), fmt=fmt, quiet=True)
    jio.write_spline_model(theirs, "M", "J0", "d.fits", mean, jvec[:, :2],
                           (t, c, k), fmt=fmt, quiet=True)
    for reader, path in ((jio.read_spline_model, mine),
                         (tio.read_spline_model, theirs)):
        name, src, df, mp, ev, tck = reader(path, quiet=True)
        assert (name, src, df) == ("M", "J0", "d.fits")
        assert np.array_equal(mp, mean) and np.array_equal(ev, jvec[:, :2])
        assert np.array_equal(np.asarray(tck[1]), c) and tck[2] == k
    if fmt == "pickle":
        with open(mine, "rb") as f:
            legacy = pickle.load(f)
        assert isinstance(legacy[5][1], list)    # the reference's layout
    jf, jp = jio.get_spline_model_coords(mine, nfreq=50)
    tf, tp = tio.get_spline_model_coords(mine, nfreq=50)
    assert np.array_equal(tf, jf) and rel(tp, jp) <= 1e-12
