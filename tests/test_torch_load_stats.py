"""load_data's per-profile statistics from an int16 archive's raw samples
(ops/load_stats: the plain twin of csrc/load_stats.cu) against the host's
numpy route, and which route load_data and get_TOAs take.

Archives: seeded int16 PSRFITS files (a pulse of random phase and
amplitude, Gaussian noise and a DC level per profile, quantized per
profile with a DAT_SCL and DAT_OFFS) at 2048 bins and at 1536, a
mixed-radix width (3 x 512 complex points).

Tolerances: the noise within 1e-5 relative (float32 FFTs in two
libraries); the baseline within the host's own float32 rounding (its
window sums are float32 cumsums: 16 ulps of their largest partial sum,
over the window's length), and the S/N within that error carried through
sum and max.  A profile where the host's float32 smoothed sums cannot
tell its window from the twin's (within the same 16 ulps of their largest
partial sum; the twin's are exact integers) is excused from both.  The card's
kernel is held against the twin in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu_torch.io.archive import load_data
from pulseportraiture_tpu_torch.io.mjd import MJD
from pulseportraiture_tpu_torch.io.psrfits import (Archive, baseline_window,
                                                   read_psrfits,
                                                   write_psrfits)
from pulseportraiture_tpu_torch.ops import load_stats
from pulseportraiture_tpu_torch.ops.noise import get_noise_PS, get_SNR

EPS = np.finfo(np.float32).eps
CPU = torch.device("cpu")


def _write(path, nsub, nchan, nbin, seed, npol=1, dtype="i2"):
    rng = np.random.default_rng(seed)
    ph = (np.arange(nbin) + 0.5) / nbin
    centre = rng.uniform(0.2, 0.8, (nsub, nchan, 1))
    amp = rng.uniform(0.0, 2.0, (nsub, nchan, 1))
    data = amp * np.exp(-0.5 * ((ph - centre) / 0.02) ** 2) + \
        rng.normal(0.0, 0.1, (nsub, nchan, nbin)) + \
        rng.uniform(-3.0, 3.0, (nsub, nchan, 1))
    data = np.concatenate([data[:, None]] + [
        rng.normal(0.0, 0.1, (nsub, 1, nchan, nbin))] * (npol - 1), 1)
    arch = Archive(
        data=data, freqs=np.broadcast_to(np.linspace(1100.0, 1900.0, nchan),
                                         (nsub, nchan)).copy(),
        weights=np.ones((nsub, nchan)), Ps=np.full(nsub, 0.003),
        epochs=[MJD(58000, 0, 0.0).add_seconds(600.0 * i)
                for i in range(nsub)],
        subtimes=np.full(nsub, 600.0), DM=30.0, nu0=1500.0, bw=800.0,
        source="J1500+3000", telescope="GBT",
        state="Intensity" if npol == 1 else "Stokes")
    write_psrfits(str(path), arch, dtype=dtype)
    return str(path)


def _host_window(d, wlen):
    """Archive.remove_baseline's float32 arithmetic on the cube d (...,
    nbin): (the window means W, the smoothed sums, and the largest
    partial sum of each level), a row a profile."""
    d2 = d.reshape(-1, d.shape[-1]).astype(np.float32)
    A = np.cumsum(np.concatenate([d2, d2[:, :wlen]], 1), -1,
                  dtype=np.float32)
    W = (A[:, wlen:] - A[:, :-wlen]) / np.float32(wlen)
    A2 = np.cumsum(np.concatenate([W, W[:, :wlen]], 1), -1,
                   dtype=np.float32)
    return (W, A2[:, wlen:] - A2[:, :-wlen], np.abs(A).max(-1),
            np.abs(A2).max(-1))


def _twin_window(raw, scl, wlen):
    """The twin's window: the first minimum of its exact smoothed sums."""
    x = raw.float() * scl[..., None]
    a = scl.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
    q = (x.double() / ulp[..., None]).to(torch.int64)
    S = load_stats._window_sums(q, wlen)
    return torch.argmin(load_stats._window_sums(S, wlen), -1).reshape(
        -1).numpy()


@pytest.mark.parametrize("nbin", [2048, 1536])
def test_twin_matches_the_host_numpy_route(tmp_path, nbin):
    path = _write(tmp_path / "a.fits", 3, 128, nbin, nbin)
    host = load_data(path, dededisperse=True, pscrunch=True)
    twin = load_data(path, dededisperse=True, pscrunch=True,
                     stats_device=CPU)
    assert twin.raw_stats and not host.raw_stats
    assert np.allclose(twin.noise_stds, host.noise_stds, rtol=1e-5, atol=0)

    a = read_psrfits(path)
    wlen = baseline_window(nbin)
    W, sel, top, top2 = _host_window(a.data[:, 0], wlen)
    ih = np.argmin(sel, -1)
    it = _twin_window(torch.from_numpy(a.raw_i2[:, 0]),
                      torch.from_numpy(a.raw_scl[:, 0]), wlen)
    rows = np.arange(len(ih))
    tie = sel[rows, it] - sel[rows, ih] <= 16 * np.spacing(top2)
    same = ih == it
    assert np.all(same | tie)
    assert same.mean() > 0.75, same.mean()

    # the twin's baseline of scl raw, plus DAT_OFFS: the cube's
    base = load_stats.profile_stats_reference(
        torch.from_numpy(a.raw_i2[:, 0]),
        torch.from_numpy(a.raw_scl[:, 0]))[0]
    bt = (base.numpy() + a.raw_offs[:, 0]).reshape(-1)
    bh = W[rows, ih]
    tol_b = 16 * EPS * top / wlen + EPS * np.abs(bh)
    assert np.all(np.abs(bt - bh)[same] <= tol_b[same])

    # the S/N, sqrt(sum max) / rms: the baseline's error through sum (nbin
    # samples) and max, and float32 rounding of the sums and the rms
    p = host.subints.reshape(-1, nbin).astype(np.float64)
    sh, st = host.SNRs.reshape(-1), twin.SNRs.reshape(-1)
    ps, pm = p.sum(-1), p.max(-1)
    tol_s = np.abs(sh) * (0.5 * tol_b * (nbin / np.abs(ps) + 1 / pm) +
                          1e-5) + 1e-6
    assert np.all(np.abs(st - sh)[same] <= tol_s[same])

    # the cube the consumers read: baseline-removed with the twin's
    # baselines, in place, at its first read
    assert "subints" in twin
    got = twin.subints
    assert got is twin.arch.data
    want = a.data - (base.numpy() + a.raw_offs[:, 0])[:, None, :, None]
    assert np.array_equal(got, want.astype(np.float32))


def test_twin_takes_the_first_of_equal_windows():
    """Rows whose every window ties (flat; alternating over an even
    window): the first window wins and the baseline is the level."""
    nbin = 256
    assert baseline_window(nbin) % 2 == 0
    raw = torch.full((2, nbin), 7, dtype=torch.int16)
    raw[1, ::2] = -5
    scl = torch.tensor([0.5, -0.25])
    base, noise, psum, pmax = load_stats.profile_stats_reference(raw, scl)
    assert np.array_equal(_twin_window(raw, scl, baseline_window(nbin)),
                          [0, 0])
    assert base.tolist() == [3.5, -0.25]
    assert psum.tolist() == [0.0, 0.0] and pmax.tolist() == [0.0, 1.5]
    assert noise[0] < 1e-5


def test_host_route_is_the_host_numpy_passes_bit_for_bit(tmp_path):
    path = _write(tmp_path / "a.fits", 2, 64, 2048, 3)
    got = load_data(path, dededisperse=True, pscrunch=True)
    a = read_psrfits(path)
    a.remove_baseline()
    d = a.data.astype(np.float32)
    noise = np.asarray(get_noise_PS(d, chans=True), dtype=np.float64)
    nz = noise[noise > 0.0]
    snr = np.asarray(get_SNR(d, noise=np.float32(np.sqrt(np.mean(nz ** 2)))),
                     dtype=np.float64)
    assert not got.raw_stats
    for g, w in ((got.noise_stds, noise), (got.SNRs, snr),
                 (got.subints, a.data)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case,takes", [
    ("int16", True), ("tscrunch", False), ("fscrunch", False),
    ("flux_prof", False), ("no_baseline", False), ("float32_file", False),
    ("npol4", False), ("no_plan", False), ("rotated", False),
    ("no_device", False)])
def test_load_data_takes_the_raw_route_only_where_it_fits(tmp_path, case,
                                                          takes):
    nbin = 1000 if case == "no_plan" else 512
    path = _write(tmp_path / "a.fits", 2, 16, nbin, 5,
                  npol=4 if case == "npol4" else 1,
                  dtype="f4" if case == "float32_file" else "i2")
    kw = dict(dededisperse=True, pscrunch=True, stats_device=CPU)
    kw.update({"tscrunch": dict(tscrunch=True),
               "fscrunch": dict(fscrunch=True),
               "flux_prof": dict(flux_prof=True),
               "no_baseline": dict(rm_baseline=False),
               "rotated": dict(dededisperse=False, dedisperse=True),
               "no_device": dict(stats_device=None)}.get(case, {}))
    data = load_data(path, **kw)
    assert data.raw_stats is takes
    if not takes:
        kw["stats_device"] = None
        host = load_data(path, **kw)
        for name in ("noise_stds", "SNRs", "subints"):
            assert np.array_equal(data[name], host[name])


def test_stats_device_is_the_card_of_a_float32_fit():
    cuda = torch.device("cuda")
    assert load_stats.stats_device(cuda, torch.float32) == cuda
    assert load_stats.stats_device("cuda:1", torch.float32) == \
        torch.device("cuda:1")
    assert load_stats.stats_device(cuda, torch.float64) is None
    assert load_stats.stats_device(CPU, torch.float32) is None
    assert load_stats.stats_device(CPU, torch.float64) is None


@pytest.mark.parametrize("nbin,takes", [
    (64, True), (128, True), (2048, True), (1536, True), (3840, True),
    (8192, True), (1000, False), (96, False), (16384, False)])
def test_kernel_widths_are_the_fft_plans(nbin, takes):
    assert load_stats.takes(nbin) is takes
