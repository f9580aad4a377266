"""Port parity: models.wavelet (Daubechies filters, swt/iswt,
wavelet_smooth, smart_smooth) against the JAX package's, float64 on the
CPU, on a seeded 32 x 256 portrait of noisy Gaussian profiles.

Tolerances: filters 1e-14; transforms and smoothers 1e-12 of the largest
|x|, and smart_smooth's chosen (level, factor) the same for every
profile.  Thresholds take numpy's median of an even length (the mean of
the two middle values); torch.median's lower middle value moves them,
which the median case shows.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.models import wavelet as jw  # noqa: E402
from pulseportraiture_tpu_torch.models import wavelet as tw  # noqa: E402

torch.set_num_threads(2)
NCHAN, NBIN, NLEV = 32, 256, 3


@pytest.fixture(scope="module")
def port():
    rng = np.random.default_rng(11)
    x = (np.arange(NBIN) + 0.5) / NBIN
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) + \
        0.4 * np.exp(-0.5 * ((x - 0.47) / 0.01) ** 2)
    amps = rng.uniform(0.3, 2.0, (NCHAN, 1))
    return prof[None] * amps + rng.normal(0.0, 0.1, (NCHAN, NBIN))


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) /
                 np.max(np.abs(want)))


@pytest.mark.parametrize("N", [2, 4, 8])
def test_daubechies_filters_match_jax(N):
    for j, t in zip(jw._filters(f"db{N}"), tw._filters(f"db{N}")):
        assert np.max(np.abs(np.asarray(t) - np.asarray(j))) <= 1e-14


@pytest.mark.parametrize("case", ["swt", "iswt", "hard", "soft"])
def test_transforms_match_jax(port, case):
    if case in ("swt", "iswt"):
        ja, jd = jw.swt(port, "db8", 5)
        ta, td = tw.swt(t64(port), "db8", 5)
        if case == "swt":
            assert rel(ta, ja) <= 1e-12 and rel(td, jd) <= 1e-12
        else:
            assert rel(tw.iswt(ta, td), jw.iswt(ja, jd)) <= 1e-12
            assert rel(tw.iswt(ta, td), port) <= 1e-10   # perfect recon.
    else:
        want = jw.wavelet_smooth(port, threshtype=case, fact=1.3)
        got = tw.wavelet_smooth(port, threshtype=case, fact=1.3,
                                device="cpu")
        assert rel(got, want) <= 1e-12


def test_even_length_median(port):
    """The thresholds take numpy's median of 2 nbin values: with
    torch.median's lower middle value in its place the smoothed
    portrait leaves the JAX package's by far more than the tolerance."""
    x = t64([1.0, 2.0, 3.0, 4.0])
    assert float(tw._median(x)) == np.median([1.0, 2.0, 3.0, 4.0]) == 2.5
    assert float(torch.median(x)) == 2.0
    want = np.asarray(jw.wavelet_smooth(port, fact=1.0))
    assert rel(tw.wavelet_smooth(port, device="cpu"), want) <= 1e-12
    real = tw._median
    try:
        tw._median = lambda v: torch.median(v, dim=-1).values
        lower = tw.wavelet_smooth(port, device="cpu")
    finally:
        tw._median = real
    assert rel(lower, want) > 1e-6


def _choices(mod, profs, to, nfact=30, rchi2_tol=0.1):
    """(level, factor index) smart_smooth picks for each profile, by
    walking its grid with the package's own pieces (0, -1 where no S/N
    beats 0): the first maximum over levels, then over factors."""
    snrs = []
    for level in range(1, NLEV + 1):
        a, d = mod.swt(to(profs), "db8", level)
        dm = (a[0], d[0])
        deep = np.abs(np.concatenate([np.asarray(v) for v in dm], axis=-1))
        base = np.median(deep, axis=-1) / 0.6745 * np.sqrt(
            2.0 * np.log(NBIN))
        row = []
        for fact in np.linspace(0.0, 3.0, nfact):
            t = to((fact * base)[None, :, None])
            sm = mod.iswt(mod._threshold(a, t), mod._threshold(d, t))
            row.append(np.asarray(mod._snr_objective_batch(
                sm, to(profs), rchi2_tol)))
        snrs.append(row)
    snrs = np.asarray(snrs)                     # (level, fact, chan)
    flat = snrs.reshape(-1, snrs.shape[-1])
    best = np.argmax(flat, axis=0)
    ok = flat[best, np.arange(flat.shape[1])] > 0
    return [(int(b // nfact) + 1, int(b % nfact)) if o else (0, -1)
            for b, o in zip(best, ok)]


def test_smart_smooth_matches_jax(port):
    want = np.asarray(jw.smart_smooth(port, try_nlevels=NLEV))
    got = tw.smart_smooth(port, try_nlevels=NLEV, device="cpu")
    assert rel(got, want) <= 1e-12
    # the result does not depend on the chunk of profiles smoothed at once
    chunked = tw.smart_smooth(port, try_nlevels=NLEV, chan_chunk=5,
                              device="cpu")
    assert rel(chunked, got) <= 1e-12
    jchoice = _choices(jw, port, np.asarray)
    tchoice = _choices(tw, port, t64)
    assert tchoice == jchoice
    assert len({c for c in tchoice}) > 1        # the grid is exercised
    # one profile, odd nbin and try_nlevels=0 as the JAX package
    assert rel(tw.smart_smooth(port[3], try_nlevels=NLEV, device="cpu"),
               want[3]) <= 1e-12
    odd = port[:, :-1]
    assert np.array_equal(tw.smart_smooth(odd, device="cpu").numpy(), odd)
    assert np.array_equal(tw.smart_smooth(port, try_nlevels=0,
                                          device="cpu").numpy(), port)
