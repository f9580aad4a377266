"""Port parity: GetTOAs.get_TOAs (the pptoas wideband path) against the
JAX package's GetTOAs on the same archives and templates.

Archives: 3 epochs x 2 subints of int16 PSRFITS from the JAX package's
make_fake_pulsar (as tests/test_end_to_end.py makes them), with injected
per-epoch dDMs, at 32 x 256, again at 16 x 768 (a band-cap width that
is not a power of two) and at 4 x 8192 (the widest width).  Templates: a
noiseless FITS archive and a .spl spline model written by the JAX
package's write_spline_model.  Both
packages fit in float64 on the CPU: TOAs agree within 1 ns, DMs and their
errors within 1e-6 of the formal error.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.config import DCONST  # noqa: E402
from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.io.tim import write_TOAs  # noqa: E402
from pulseportraiture_tpu.models.gmodel_io import (read_model,  # noqa: E402
                                                   write_model)
from pulseportraiture_tpu.models.spline_io import \
    write_spline_model  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.sim.fake import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu.utils import get_bin_centers  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import template  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import toas  # noqa: E402

from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR_LINES = [
    "PSR             J1234-5678",
    "RAJ      01:02:03.45678901  1",
    "DECJ     -04:05:06.7890123  1",
    "F0      345.67890123456789  1",
    "F1       -1.2345679978D-13  1",
    "PEPOCH        50000.000000",
    "DM                34.56789",
]
MODEL_PARAMS = [0.0, 0.0,
                0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
                0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]
NCHAN, NBIN = 32, 256


def _workspace(ws, NCHAN, NBIN):
    """The archives and templates at NCHAN x NBIN in the directory ws."""
    from scipy.interpolate import splprep

    par = str(ws / "test.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gmodel = str(ws / "test.gmodel")
    write_model(gmodel, "TEST", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    rng = np.random.default_rng(2026)
    dDMs = rng.normal(3e-4, 2e-4, 3)
    files = []
    for i in range(3):
        path = str(ws / f"epoch-{i + 1}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, nsub=2, npol=1,
                         nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                         tsub=60.0, phase=0.0, dDM=dDMs[i],
                         start_MJD=MJD(57202.0 + 20.0 * i), noise_stds=0.3,
                         dedispersed=False, quiet=True, rng=rng)
        files.append(path)
    f4 = str(ws / "epoch-f4.fits")          # float32 DATA: no int16 ingest
    make_fake_pulsar(gmodel, par, outfile=f4, nsub=2, npol=1, nchan=NCHAN,
                     nbin=NBIN, nu0=1500.0, bw=800.0, tsub=60.0, dDM=1e-4,
                     start_MJD=MJD(57302.0), noise_stds=0.3,
                     dedispersed=False, quiet=True, dtype="f4", rng=rng)
    fits_tmpl = str(ws / "template.fits")
    make_fake_pulsar(gmodel, par, outfile=fits_tmpl, nsub=1, npol=1,
                     nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                     tsub=60.0, start_MJD=MJD(57202.0), noise_stds=0.0,
                     dedispersed=True, quiet=True, dtype="f4",
                     rng=np.random.default_rng(1))
    # spline template: PCA of the model portrait + splines of the
    # projections over frequency
    cw = 800.0 / NCHAN
    freqs = np.linspace(1100.0 + cw / 2, 1900.0 - cw / 2, NCHAN)
    _, _, model = read_model(gmodel, get_bin_centers(NBIN), freqs,
                             1.0 / 345.6789, quiet=True)
    model = np.asarray(model)
    mean_prof = model.mean(0)
    _, _, Vt = np.linalg.svd(model - mean_prof, full_matrices=False)
    eigvec = Vt[:2].T
    proj = (model - mean_prof) @ eigvec
    (t, c, k), _ = splprep([proj[:, 0], proj[:, 1]], u=freqs, s=0, k=3)
    spl = str(ws / "template.spl")
    write_spline_model(spl, "TEST", "J1234-5678", "none", mean_prof, eigvec,
                       (t, c, k), quiet=True)
    return dict(files=files, dDMs=dDMs, fits=fits_tmpl, spl=spl, f4=f4,
                path=ws)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return _workspace(tmp_path_factory.mktemp("torch_pipeline"), NCHAN,
                      NBIN)


@pytest.fixture(scope="module")
def ws768(tmp_path_factory):
    return _workspace(tmp_path_factory.mktemp("torch_pipeline_768"), 16, 768)


@pytest.fixture(scope="module")
def ws8192(tmp_path_factory):
    return _workspace(tmp_path_factory.mktemp("torch_pipeline_8192"), 4,
                      8192)


@pytest.mark.parametrize("kind", ["fits", "spl"])
def test_port_toas_match_jax(ws, kind):
    _toas_match_jax(ws, kind)


def test_port_toas_match_jax_at_768_bins(ws768, monkeypatch):
    """At 16 x 768 (6 x 128: the FFT setup route's radix-3 plan on the
    card), the same parity in float64; and the port's float32 run caps
    its template at the mharm the JAX package's band cap gives the same
    template."""
    _toas_match_jax(ws768, "fits")
    from pulseportraiture_tpu.ops.ct_dft import band_cap_model_ft

    seen = []
    orig = template.fit_spectrum

    def spy(model_rot, nbin, f32):
        out = orig(model_rot, nbin, f32)
        mf = np.fft.rfft(np.asarray(model_rot, np.float64), axis=-1)
        seen.append((out[2], band_cap_model_ft(mf.real, mf.imag, nbin)[2]))
        return out
    monkeypatch.setattr(template, "fit_spectrum", spy)
    g32 = toas.GetTOAs(ws768["files"], ws768["fits"], device="cpu",
                       dtype=torch.float32, quiet=True)
    g32.get_TOAs(quiet=True)
    assert len(g32.TOA_list) == 6 and seen
    assert all(mine == theirs is not None for mine, theirs in seen), seen
    assert g32.mharms == sorted({m for m, _ in seen})


def test_port_toas_match_jax_at_8192_bins(ws8192):
    """At 4 x 8192 (the widest width the port fits, its full band on the
    FFT setup route's three radix-16 passes on the card; the JAX package
    sets it up outside its TPU kernels), the same parity in float64."""
    _toas_match_jax(ws8192, "fits")


def _toas_match_jax(ws, kind):
    want = JGetTOAs(ws["files"], ws[kind], quiet=True)
    want.get_TOAs(quiet=True)
    got = toas.GetTOAs(ws["files"], ws[kind], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(quiet=True)
    assert len(got.TOA_list) == len(want.TOA_list) == 6
    for a, b in zip(got.TOA_list, want.TOA_list):
        assert a.archive == b.archive
        assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-9     # seconds: 1 ns
        assert abs(a.frequency - b.frequency) < 1e-6 * b.frequency
        assert abs(a.DM - b.DM) <= 1e-6 * b.DM_error
        assert abs(a.DM_error - b.DM_error) <= 1e-6 * b.DM_error
        assert abs(a.TOA_error - b.TOA_error) <= 1e-6 * b.TOA_error
        for flag in ("snr", "gof"):
            assert abs(a.flags[flag] - b.flags[flag]) <= \
                1e-6 * abs(b.flags[flag])
    lines = write_TOAs(got.TOA_list, outfile=None)
    jlines = write_TOAs(want.TOA_list, outfile=None)
    assert [ln.split()[0] for ln in lines] == [ln.split()[0]
                                               for ln in jlines]
    # injected per-epoch dDMs recovered within 3 sigma
    rec = np.asarray(got.DeltaDM_means)
    err = np.asarray(got.DeltaDM_errs)
    assert np.all(np.abs(rec - ws["dDMs"]) <= 3 * err), (rec, ws["dDMs"],
                                                         err)


def test_int16_ingest_matches_float32_ingest(ws, monkeypatch):
    """float32 fits take the archives' int16 samples + DAT_SCL; the same
    fits on the dequantized float32 subints agree within 0.05 sigma (the
    dropped per-channel offsets only feed the discarded DC harmonic).
    Each TOA is referenced at its own float32 zero-covariance frequency,
    so the two are compared at one frequency: the full-DM delay between
    frequencies one f32 ulp apart is ~10 ns here."""
    gi = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                      dtype=torch.float32, quiet=True)
    gi.get_TOAs(quiet=True)

    orig = toas.load_data
    monkeypatch.setattr(toas, "load_data", lambda *a, **kw: _drop_raw(
        orig(*a, **kw)))
    gf = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                      dtype=torch.float32, quiet=True)
    gf.get_TOAs(quiet=True)
    assert len(gi.TOA_list) == len(gf.TOA_list) == 6
    for a, b in zip(gi.TOA_list, gf.TOA_list):
        dt = (a.MJD - b.MJD) + DCONST * b.DM * (b.frequency ** -2.0 -
                                                a.frequency ** -2.0)
        assert abs(dt) * 1e6 < 0.05 * b.TOA_error
        assert abs(a.DM - b.DM) < 0.05 * b.DM_error


def _drop_raw(data):
    data.pop("raw_i2", None)
    data.pop("raw_scl", None)
    return data


def test_chunked_fits_equal_one_batch(ws, monkeypatch):
    """Chunks of 2 across archives whose ports differ in type (int16 and
    float32 files) give the TOAs of one batch per type."""
    files = [ws["files"][0], ws["f4"], ws["files"][1]]
    whole = toas.GetTOAs(files, ws["fits"], device="cpu",
                         dtype=torch.float32, quiet=True)
    whole.get_TOAs(quiet=True)
    monkeypatch.setattr(toas, "_MAX_CHUNK", 2)
    chunked = toas.GetTOAs(files, ws["fits"], device="cpu",
                           dtype=torch.float32, quiet=True)
    chunked.get_TOAs(quiet=True)
    assert [t.archive for t in chunked.TOA_list] == \
        [t.archive for t in whole.TOA_list] and len(whole.TOA_list) == 6
    for a, b in zip(chunked.TOA_list, whole.TOA_list):
        assert abs(a.MJD - b.MJD) * 1e6 < 1e-3 * b.TOA_error
        assert abs(a.DM - b.DM) < 1e-3 * b.DM_error


def test_port_pipeline_and_cli_never_import_jax(ws):
    """The (phi, DM) and the fit_scat pipeline and the CLI load neither
    jax nor any module of the JAX package."""
    tim = str(ws["path"] / "cli.tim")
    code = (
        "import sys\n"
        "import torch\n"
        "from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs\n"
        "from pulseportraiture_tpu_torch.cli import pptoas\n"
        "torch.set_num_threads(2)\n"
        f"gt = GetTOAs({ws['files']!r}, {ws['spl']!r}, device='cpu',\n"
        "             quiet=True)\n"
        "gt.get_TOAs(quiet=True)\n"
        f"gs = GetTOAs({ws['files'][:1]!r}, {ws['fits']!r}, device='cpu',\n"
        "             quiet=True)\n"
        "gs.get_TOAs(quiet=True, fit_scat=True)\n"
        f"pptoas.main(['-d', {ws['files'][0]!r}, '-m', {ws['fits']!r},\n"
        f"             '-o', {tim!r}, '--device', 'cpu', '--quiet'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'pulseportraiture_tpu')]\n"
        "print(len(gt.TOA_list), len(gs.TOA_list), 'jax' in sys.modules,\n"
        "      len(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-4:] == ["6", "2", "False", "0"], out.stdout
    with open(tim) as f:
        assert len(f.read().splitlines()) == 2


def test_cuda_device_without_a_card_raises(ws):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a CUDA-less box")
    with pytest.raises(RuntimeError):
        toas.GetTOAs(ws["files"], ws["fits"], device="cuda")
    from pulseportraiture_tpu_torch.cli import pptoas
    with pytest.raises(RuntimeError):
        pptoas.main(["-d", ws["files"][0], "-m", ws["fits"]])


def test_unported_options_raise(ws):
    """The options the port once refused now run: mesh sharding gives the
    unsharded run's TOAs (bitwise here: seed sums aside, per-row results
    do not depend on the split; tests/test_torch_mesh.py holds it to
    1e-10 s).  GM, with or without fit_scat: its TOAs match the JAX
    package's (within 1 ns, DM and GM within 1e-6 sigma), as do user
    output references and .gmodel templates."""
    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh
    gt = toas.GetTOAs(ws["files"][:1], ws["fits"], device="cpu",
                      dtype=torch.float64, quiet=True)
    gt.get_TOAs(quiet=True)
    unsharded = gt.TOA_list
    gt.TOA_list = []
    gt.get_TOAs(quiet=True, mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    assert len(gt.TOA_list) == len(unsharded) == 2
    for a, b in zip(gt.TOA_list, unsharded):
        assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-10
        assert abs(a.DM - b.DM) < 1e-9
    for kw in (dict(fit_GM=True), dict(fit_GM=True, fit_scat=True)):
        want = JGetTOAs(ws["files"][:1], ws["fits"], quiet=True)
        want.get_TOAs(quiet=True, **kw)
        gt.TOA_list = []
        gt.get_TOAs(quiet=True, **kw)
        assert len(gt.TOA_list) == len(want.TOA_list) == 2
        for a, b in zip(gt.TOA_list, want.TOA_list):
            assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-9
            assert abs(a.DM - b.DM) <= 1e-6 * b.DM_error
            assert abs(a.flags["gm"] - b.flags["gm"]) <= \
                1e-6 * b.flags["gm_err"]
    gt.TOA_list = []
    gt.get_TOAs(quiet=True, nu_refs=(1400.0, 1400.0, 1400.0))
    assert [t.frequency for t in gt.TOA_list] == [1400.0, 1400.0]
    gmodel = str(ws["path"] / "test.gmodel")
    gg = toas.GetTOAs(ws["files"][:1], gmodel, device="cpu",
                      dtype=torch.float64, quiet=True)
    assert gg.model_source.kind == "gauss"
