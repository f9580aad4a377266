"""Port parity: channel zapping against the JAX package, float64 on the CPU.

An archive of the recipe of tests/test_torch_pipeline.py (2 subints of
32 channels x 256 bins) in which channels 5, 11 and 20 carry 5x the
white noise, and channels 8 and 26 as much again in noise confined to
the lower half of the spectrum (interference the power-spectrum noise
estimate, which reads the top quarter, does not see).  The model-free
path (noise-level clipping) finds the first three; the model path
(GetTOAs.get_channels_to_zap: per-channel reduced chi2 and S/N) the
other two.  get_channels_to_zap on both of its paths (the fit's
per-channel reduced chi2, and show_fit's time-domain recompute),
show_fit itself, zap_archive's written weights and the ppzap tool, each
against the JAX package: the same channel lists and weights.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.pipelines import zap as jzap  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.sim.fake import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu_torch.io.psrfits import (  # noqa: E402
    read_psrfits, write_psrfits)
from pulseportraiture_tpu_torch.pipelines import toas, zap  # noqa: E402

from test_torch_pipeline import NBIN, NCHAN, ws  # noqa: E402,F401
from torch_parity_utils import rel_err  # noqa: E402

torch.set_num_threads(2)
NOISY = [5, 11, 20]        # white noise x5: the model-free path
RFI = [8, 26]              # low-frequency noise: the model path


@pytest.fixture(scope="module")
def noisy(ws):
    noise = np.full(NCHAN, 0.3)
    noise[NOISY] *= 5.0
    path = str(ws["path"] / "noisy.fits")
    make_fake_pulsar(str(ws["path"] / "test.gmodel"),
                     str(ws["path"] / "test.par"), outfile=path, nsub=2,
                     npol=1, nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                     tsub=60.0, dDM=2e-4, start_MJD=MJD(57400.0),
                     noise_stds=noise, dedispersed=False, quiet=True,
                     rng=np.random.default_rng(7))
    arch = read_psrfits(path)
    rng = np.random.default_rng(8)
    spec = np.fft.rfft(rng.normal(0.0, 1.5, (2, len(RFI), NBIN)), axis=-1)
    spec[..., NBIN // 4:] = 0.0
    arch.data = np.asarray(arch.data, np.float64)
    arch.data[:, 0, RFI] += np.fft.irfft(spec, n=NBIN, axis=-1)
    write_psrfits(path, arch)
    return path


def _fits(ws, noisy):
    got = toas.GetTOAs([noisy], ws["fits"], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(quiet=True)
    want = JGetTOAs([noisy], ws["fits"], quiet=True)
    want.get_TOAs(quiet=True)
    return got, want


@pytest.mark.parametrize("path", ["fit", "show_fit"])
def test_channels_to_zap_match_jax(ws, noisy, path):
    got, want = _fits(ws, noisy)
    if path == "show_fit":
        # no stored per-channel chi2: both recompute through show_fit
        got.fit_channel_red_chi2s = []
        want.fit_channel_red_chi2s = []
    zg = got.get_channels_to_zap()
    zw = want.get_channels_to_zap()
    assert zg == zw
    for subint in zg[0]:
        assert set(RFI) <= set(subint), subint
    # the JAX package's show_fit rotates the float32 samples in float32
    tol = 1e-6 if path == "fit" else 1e-3
    for a, b in zip(got.channel_red_chi2s[0], want.channel_red_chi2s[0]):
        assert rel_err(np.array(a), np.array(b)) < tol
    # show=True draws the subints with channels to zap, same lists
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    shown = []
    real = plt.show
    plt.show = lambda *a, **k: shown.append(1)
    try:
        assert got.get_channels_to_zap(show=True) == zg
    finally:
        plt.show = real
    assert len(shown) == sum(bool(z) for z in zg[0])


def test_show_fit_matches_jax(ws, noisy):
    got, want = _fits(ws, noisy)
    for isub in (0, 1):
        a = got.show_fit(isub=isub, show=False, return_fit=True)
        b = want.show_fit(isub=isub, show=False, return_fit=True)
        # (port, scaled model, phases, freqs, errs); the JAX package
        # rotates the float32 samples by thousands of turns in float32
        for x, y, tol in zip(a, b, (1e-3, 1e-9, 0.0, 0.0, 0.0)):
            assert rel_err(x, y) <= tol
    import matplotlib
    matplotlib.use("Agg")
    png = ws["path"] / "show_fit.png"
    assert got.show_fit(isub=0, savefig=str(png), show=False) is None
    assert png.stat().st_size > 1000


@pytest.mark.parametrize("per_subint,normalize", [(False, False),
                                                  (True, False),
                                                  (False, True)])
def test_zap_archive_weights_match_jax(ws, noisy, per_subint, normalize):
    a = str(ws["path"] / f"port-{per_subint}-{normalize}.zap.fits")
    b = str(ws["path"] / f"jax-{per_subint}-{normalize}.zap.fits")
    za = zap.zap_archive(noisy, a, per_subint=per_subint,
                         normalize=normalize, device="cpu")
    zb = jzap.zap_archive(noisy, b, per_subint=per_subint,
                          normalize=normalize)
    assert za == zb
    wa, wb = read_psrfits(a).weights, read_psrfits(b).weights
    assert np.array_equal(wa, wb)
    if not normalize:
        assert not wa[:, NOISY].any()
    assert zap.get_zap_channels(read_psrfits(noisy).weights[0] * 0.0) == []


@pytest.mark.parametrize("model", [False, True])
def test_ppzap_matches_jax(ws, noisy, model, capsys):
    from pulseportraiture_tpu.cli import ppzap as jppzap
    from pulseportraiture_tpu_torch.cli import ppzap
    common = ["-d", noisy, "--quiet"] + (["-m", ws["fits"]] if model
                                        else [])
    a = str(ws["path"] / f"cli-port-{model}.fits")
    b = str(ws["path"] / f"cli-jax-{model}.fits")
    assert ppzap.main(common + ["-o", a, "--device", "cpu"]) == 0
    assert jppzap.main(common + ["-o", b]) == 0
    wa, wb = read_psrfits(a).weights, read_psrfits(b).weights
    assert np.array_equal(wa, wb)
    assert not wa[:, RFI if model else NOISY].any()
    capsys.readouterr()
    assert ppzap.main(common + ["--print_cmds", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert jppzap.main(common + ["--print_cmds"]) == 0
    assert lines == capsys.readouterr().out.splitlines()
    assert len(lines) >= len(RFI)
    if model:
        hist = str(ws["path"] / "rchi2.png")
        assert ppzap.main(common + ["--saveplot", hist, "-o", a,
                                    "--device", "cpu"]) == 0
        assert os.path.getsize(hist) > 1000
