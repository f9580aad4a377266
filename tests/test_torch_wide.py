"""The port at 16384 bins against the JAX package, and its float32 run
against its float64 run.

Above 8192 bins the port's card sets the fit up on its "rfft" route
(torch.fft.rfft + csrc/setup_epilogue.cu) and its phase moments take
harmonics past 4096, where the float32 phase trig reduces k mod 8192
first; on the CPU the same paths run their plain twins.  Archives:
tests/test_torch_pipeline.py's recipe (_workspace: 3 epochs x 2 int16
subints with injected dDMs, a noiseless FITS template) at 4 x 16384, and
two scattered archives x 2 subints of the same model for fit_scat.

Tolerances, in the float64 fit's errors:
  * port float64 against JAX float64: get_TOAs TOAs (moved to one
    frequency by the DM) and DMs within 1e-6 sigma; with fit_scat TOAs
    and DMs within 1e-5 sigma and log10 scat_time within 1e-4 sigma (the
    JAX result depends on its start tau at ~1e-6 sigma,
    tests/test_torch_scattering.py); get_narrowband_TOAs TOAs within 1e-6
    sigma, the JAX package given float64 samples as in
    tests/test_torch_narrowband.py;
  * port float32 against port float64: the same quantities within 0.01
    sigma.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.pipelines import toas as jtoas  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.sim.fake import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu_torch.config import DCONST  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import toas  # noqa: E402

from test_torch_pipeline import _workspace  # noqa: E402
from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)

NCHAN, NBIN = 4, 16384
T_SCAT = 2e-5            # [s] at 1500 MHz: ~0.007 rot
SCAT_GUESS = (2e-5, 1500.0, -4.0)
# mode: (archives, GetTOAs method, keywords, expected TOAs)
MODES = {
    "plain": ("files", "get_TOAs", {}, 6),
    "fit_scat": ("scat", "get_TOAs",
                 dict(fit_scat=True, scat_guess=SCAT_GUESS), 4),
    "narrowband": ("files", "get_narrowband_TOAs", {}, 6 * NCHAN),
}
# port float64 against JAX float64: (TOA, DM, log10 scat_time) in sigma
JAX_SIGMAS = {"plain": (1e-6, 1e-6, None), "fit_scat": (1e-5, 1e-5, 1e-4),
              "narrowband": (1e-6, None, None)}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_wide")
    out = _workspace(path, NCHAN, NBIN)
    rng = np.random.default_rng(2031)
    out["scat"] = []
    for i, dDM in enumerate((2e-4, -1e-4)):
        f = str(path / f"scat-{i}.fits")
        make_fake_pulsar(str(path / "test.gmodel"), str(path / "test.par"),
                         outfile=f, nsub=2, npol=1, nchan=NCHAN, nbin=NBIN,
                         nu0=1500.0, bw=800.0, tsub=60.0, dDM=dDM,
                         start_MJD=MJD(57300.0 + 10 * i), noise_stds=0.1,
                         dedispersed=False, t_scat=T_SCAT, alpha=-4.0,
                         quiet=True, rng=rng)
        out["scat"].append(f)
    return out


@pytest.fixture
def jax_float64_samples(monkeypatch):
    """The JAX pipelines load the archives' float32 samples as float64."""
    orig = jtoas.load_data

    def load(*a, **kw):
        data = orig(*a, **kw)
        data["subints"] = np.asarray(data.subints, np.float64)
        return data

    monkeypatch.setattr(jtoas, "load_data", load)


def _run(gt, mode):
    _, method, kw, n = MODES[mode]
    getattr(gt, method)(quiet=True, **kw)
    assert len(gt.TOA_list) == n
    return gt.TOA_list


def _sigmas(got, want):
    """Largest |TOA| (got's moved to want's frequency by want's DM, where
    there is one), |DM| and |log10 scat_time| differences, in want's
    sigmas (None where the TOAs carry none)."""
    z = [0.0, None, None]
    for a, b in zip(got, want):
        assert a.archive == b.archive
        dt = mjd_diff_s(a.MJD, b.MJD)
        if b.DM is not None:
            dt += DCONST * b.DM * (b.frequency ** -2.0 -
                                   a.frequency ** -2.0)
            z[1] = max(z[1] or 0.0, abs(a.DM - b.DM) / b.DM_error)
        z[0] = max(z[0], abs(dt) * 1e6 / b.TOA_error)
        if "log10_scat_time" in b.flags:
            z[2] = max(z[2] or 0.0, abs(a.flags["log10_scat_time"] -
                                        b.flags["log10_scat_time"]) /
                       b.flags["log10_scat_time_err"])
    return z


@pytest.mark.parametrize("mode", list(MODES))
def test_port_float64_matches_jax_at_16384_bins(ws, mode,
                                                jax_float64_samples):
    files = ws[MODES[mode][0]]
    want = _run(JGetTOAs(files, ws["fits"], quiet=True), mode)
    got = _run(toas.GetTOAs(files, ws["fits"], device="cpu",
                            dtype=torch.float64, quiet=True), mode)
    z = _sigmas(got, want)
    for name, v, bound in zip(("TOA", "DM", "log10 tau"), z,
                              JAX_SIGMAS[mode]):
        assert (v is None) == (bound is None), name
        assert v is None or v <= bound, (name, v, bound)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_float32_matches_float64_at_16384_bins(ws, mode):
    files = ws[MODES[mode][0]]
    runs = [_run(toas.GetTOAs(files, ws["fits"], device="cpu", dtype=dt,
                              quiet=True), mode)
            for dt in (torch.float32, torch.float64)]
    z = _sigmas(*runs)
    assert max(v for v in z if v is not None) <= 1e-2, z
    if mode == "plain":          # the injected per-epoch dDMs, 3 sigma
        gt = toas.GetTOAs(files, ws["fits"], device="cpu",
                          dtype=torch.float32, quiet=True)
        gt.get_TOAs(quiet=True)
        rec = np.asarray(gt.DeltaDM_means)
        err = np.asarray(gt.DeltaDM_errs)
        assert np.all(np.abs(rec - ws["dDMs"]) <= 3 * err)
