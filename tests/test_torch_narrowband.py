"""Port parity, the slice as a whole: the narrowband pipelines
(get_narrowband_TOAs with and without fit_scat, get_psrchive_TOAs), user
output references (nu_refs), a subint with one live channel and a .gmodel
template, against the JAX package's GetTOAs on the same int16 archives.

Both packages fit in float64 on the CPU.  Every TOA agrees within 1e-9 of
a period (3 ps), its error within 1e-6 relative; string and integer flags
are equal and float flags agree within 1e-6 relative (the per-channel
scattering fits start both packages from the same FFTFIT phases, so their
Newton paths coincide too).

One input is made equal first.  load_data keeps an archive's samples in
float32, and the JAX package's narrowband paths hand them to the FFT as
they are, so its data spectra are float32 whatever the fit type, while the
port casts to the fit type first (as both packages' get_TOAs do).  The
narrowband tests give the JAX package float64 copies of the same samples,
so that both transform in float64; test_float32_samples_only_add_noise
bounds what the float32 transform moves.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.io.tim import write_TOAs  # noqa: E402
from pulseportraiture_tpu.models.gmodel_io import write_model  # noqa: E402
from pulseportraiture_tpu.pipelines import toas as jtoas  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.sim.fake import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu_torch.cli import pptoas  # noqa: E402
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
PERIOD = 1.0 / 345.6789
T_SCAT = 2e-5            # [s] at 1500 MHz: ~0.007 rot


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_narrowband")
    par = str(ws / "test.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gmodel = str(ws / "test.gmodel")
    write_model(gmodel, "TEST", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    # the same model with its own scattering: get_TOAs(fit_scat=True)
    # must evaluate it unscattered
    scat_gmodel = str(ws / "scat.gmodel")
    write_model(scat_gmodel, "TEST", "000", 1500.0,
                [0.0, T_SCAT] + MODEL_PARAMS[2:], [1] * len(MODEL_PARAMS),
                -4.0, 0, quiet=True)
    rng = np.random.default_rng(2027)
    common = dict(nsub=2, npol=1, nchan=NCHAN, nbin=NBIN, nu0=1500.0,
                  bw=800.0, tsub=60.0, noise_stds=0.3, dedispersed=False,
                  quiet=True, rng=rng)
    files = []
    for i, dDM in enumerate((3e-4, -2e-4)):
        path = str(ws / f"epoch-{i + 1}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, phase=0.03 * i, dDM=dDM,
                         start_MJD=MJD(57202.0 + 20.0 * i), **common)
        files.append(path)
    scat = str(ws / "scattered.fits")
    make_fake_pulsar(gmodel, par, outfile=scat, dDM=1e-4, t_scat=T_SCAT,
                     start_MJD=MJD(57262.0), **common)
    # subint 1 keeps one live channel; two channels are dead in subint 0
    weights = np.ones((2, NCHAN))
    weights[0, [4, 9]] = 0.0
    weights[1, :] = 0.0
    weights[1, 11] = 1.0
    sparse = str(ws / "sparse.fits")
    make_fake_pulsar(gmodel, par, outfile=sparse, dDM=2e-4, weights=weights,
                     start_MJD=MJD(57282.0), **common)
    sparse_scat = str(ws / "sparse_scattered.fits")
    make_fake_pulsar(gmodel, par, outfile=sparse_scat, dDM=2e-4,
                     weights=weights, t_scat=T_SCAT,
                     start_MJD=MJD(57282.0), **common)
    fits_tmpl = str(ws / "template.fits")
    make_fake_pulsar(gmodel, par, outfile=fits_tmpl, nsub=1, npol=1,
                     nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                     tsub=60.0, start_MJD=MJD(57202.0), noise_stds=0.0,
                     dedispersed=True, quiet=True, dtype="f4",
                     rng=np.random.default_rng(1))
    return dict(files=files, scat=scat, sparse=sparse,
                sparse_scat=sparse_scat, gmodel=gmodel,
                scat_gmodel=scat_gmodel, fits=fits_tmpl, path=ws)


@pytest.fixture
def jax_float64_samples(monkeypatch):
    """The JAX pipelines load the archives' float32 samples as float64."""
    orig = jtoas.load_data

    def load(*a, **kw):
        data = orig(*a, **kw)
        data["subints"] = np.asarray(data.subints, np.float64)
        return data

    monkeypatch.setattr(jtoas, "load_data", load)


def port(files, model):
    return toas.GetTOAs(files, model, device="cpu", dtype=torch.float64,
                        quiet=True)


def same_toas(got, want, n, rtol=1e-6, wideband=False):
    """TOA lists agree: epochs within 1e-9 P, the rest as stated above.
    wideband: each TOA sits at a fitted zero-covariance frequency, which
    both packages find to ~1e-11 relative; the full-DM delay between two
    such frequencies is picoseconds, so the epochs are held to 1 ns and
    the frequencies to 1e-6, as tests/test_torch_pipeline.py holds them."""
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.archive == b.archive
        assert abs(mjd_diff_s(a.MJD, b.MJD)) <= (1e-9 if wideband
                                                 else 1e-9 * PERIOD)
        assert a.frequency == pytest.approx(b.frequency,
                                            rel=1e-6 if wideband else 1e-12)
        assert a.TOA_error == pytest.approx(b.TOA_error, rel=rtol)
        assert (a.DM is None) == (b.DM is None)
        if a.DM is not None:
            assert abs(a.DM - b.DM) <= rtol * b.DM_error
            assert a.DM_error == pytest.approx(b.DM_error, rel=rtol)
        assert list(a.flags) == list(b.flags)
        for key, val in b.flags.items():
            if isinstance(val, float):
                assert a.flags[key] == pytest.approx(val, rel=rtol,
                                                     abs=1e-12), key
            else:
                assert a.flags[key] == val, key
    # and the .tim lines name the same archives (and channel frequencies)
    for la, lb in zip(write_TOAs(got, outfile=None),
                      write_TOAs(want, outfile=None)):
        assert la.split()[:1 if wideband else 2] == \
            lb.split()[:1 if wideband else 2]


@pytest.mark.parametrize("template", ["gmodel", "fits"])
def test_narrowband_toas_match_jax(ws, template, jax_float64_samples):
    kw = dict(print_phase=True, print_flux=True,
              addtnl_toa_flags={"pta": "TEST"}, quiet=True)
    want = JGetTOAs(ws["files"], ws[template], quiet=True)
    want.get_narrowband_TOAs(**kw)
    got = port(ws["files"], ws[template])
    got.get_narrowband_TOAs(**kw)
    same_toas(got.TOA_list, want.TOA_list, 2 * 2 * NCHAN)
    assert got.TOA_list[0].DM is None and "chan" in got.TOA_list[0].flags
    t = got.fit_timing
    assert t["wall_s"] >= t["fit_s"] > 0.0 and t["load_s"] > 0.0


@pytest.mark.parametrize("log10_tau", [True, False])
def test_narrowband_fit_scat_matches_jax(ws, log10_tau, jax_float64_samples):
    kw = dict(fit_scat=True, log10_tau=log10_tau,
              scat_guess=(1e-5, 1500.0, -4.0), quiet=True)
    want = JGetTOAs(ws["scat"], ws["gmodel"], quiet=True)
    want.get_narrowband_TOAs(**kw)
    got = port(ws["scat"], ws["gmodel"])
    got.get_narrowband_TOAs(**kw)
    same_toas(got.TOA_list, want.TOA_list, 2 * NCHAN)
    # the injected tau(nu) comes back: median pull below 1 sigma
    z = [(t.flags["scat_time"] * 1e-6 -
          T_SCAT * (t.frequency / 1500.0) ** -4.0) /
         (t.flags["scat_time_err"] * 1e-6) for t in got.TOA_list]
    assert abs(np.median(z)) < 1.0


@pytest.mark.parametrize("algorithm", ["PGS", "FDM", "SIS", "PIS", "GIS",
                                       "COF"])
def test_psrchive_toas_match_jax(ws, algorithm, jax_float64_samples):
    want = JGetTOAs(ws["files"][:1], ws["gmodel"], quiet=True)
    wobjs = want.get_psrchive_TOAs(algorithm=algorithm)
    got = port(ws["files"][:1], ws["gmodel"])
    gobjs = got.get_psrchive_TOAs(algorithm=algorithm)
    same_toas(gobjs, wobjs, 2 * NCHAN)
    assert len(got.psrchive_toas) == 1
    for la, lb in zip(got.psrchive_toas[0], want.psrchive_toas[0]):
        fa, fb = la.split(), lb.split()
        assert fa[:2] == fb[:2] and fa[4] == fb[4] and fa[5::2] == fb[5::2]  # code, flag names
        assert abs(float(fa[2][5:]) - float(fb[2][5:])) <= 1e-9 * PERIOD / \
            86400.0 and fa[2][:5] == fb[2][:5]
        assert float(fa[3]) == pytest.approx(float(fb[3]), abs=2e-3)
    with pytest.raises(ValueError):
        got.get_psrchive_TOAs(algorithm="XYZ")


def test_float32_samples_only_add_noise(ws):
    """Against the JAX package as it runs (float32 data spectra), the
    port's float64 transform moves no TOA by more than 1e-4 sigma."""
    want = JGetTOAs(ws["files"][:1], ws["gmodel"], quiet=True)
    want.get_narrowband_TOAs(quiet=True)
    got = port(ws["files"][:1], ws["gmodel"])
    got.get_narrowband_TOAs(quiet=True)
    assert len(got.TOA_list) == len(want.TOA_list) == 2 * NCHAN
    for a, b in zip(got.TOA_list, want.TOA_list):
        assert abs(mjd_diff_s(a.MJD, b.MJD)) * 1e6 <= 1e-4 * b.TOA_error


@pytest.mark.parametrize("kw", [
    dict(nu_refs=(1400.0, 1400.0, 1400.0)),
    dict(nu_refs=(None, None, 1350.0), fit_scat=True),
    dict(nu_refs=(1600.0, None, None), bary=False),
    dict(nu_refs=(1400.0, 1400.0, 1450.0), fit_scat=True, fix_alpha=False,
         log10_tau=False, scat_guess=(1e-5, 1500.0, -4.0)),
], ids=["all", "tau_only_fit_scat", "DM_only_topo", "fit_alpha_linear"])
def test_nu_refs_match_jax(ws, kw):
    """User output references: the per-subint route (FFTFIT phase start,
    no DM seed, pinned references; the tau reference divided by the
    Doppler factor when bary)."""
    files = [ws["scat"]] if kw.get("fit_scat") else ws["files"]
    want = JGetTOAs(files, ws["gmodel"], quiet=True)
    want.get_TOAs(quiet=True, **kw)
    got = port(files, ws["gmodel"])
    got.get_TOAs(quiet=True, **kw)
    same_toas(got.TOA_list, want.TOA_list, 2 * len(files), rtol=1e-5,
              wideband=True)
    if kw["nu_refs"][0] is not None:
        assert all(t.frequency == kw["nu_refs"][0] for t in got.TOA_list)
        assert "phi_DM_cov" in got.TOA_list[0].flags
    for a, b in zip(got.nu_refs, want.nu_refs):
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-9)


@pytest.mark.parametrize("fit_scat", [False, True])
def test_subint_with_one_live_channel_matches_jax(ws, fit_scat):
    """The degenerate subint is fitted with flags (1, 0, 0, 0, 0) from a
    brute phase start; its neighbour goes through the batch."""
    files = [ws["sparse_scat"], ws["scat"]] if fit_scat else \
        [ws["sparse"], ws["files"][0]]
    want = JGetTOAs(files, ws["gmodel"], quiet=True)
    want.get_TOAs(quiet=True, fit_scat=fit_scat)
    got = port(files, ws["gmodel"])
    got.get_TOAs(quiet=True, fit_scat=fit_scat)
    same_toas(got.TOA_list, want.TOA_list, 4, rtol=1e-5, wideband=True)
    assert [t.flags["nchx"] for t in got.TOA_list] == [NCHAN - 2, 1, NCHAN,
                                                        NCHAN]
    assert got.TOA_list[1].DM_error == 0.0


def test_gmodel_with_its_own_scattering_is_unscattered_for_fit_scat(ws):
    kw = dict(fit_scat=True, quiet=True)
    want = JGetTOAs(ws["scat"], ws["scat_gmodel"], quiet=True)
    want.get_TOAs(**kw)
    got = port(ws["scat"], ws["scat_gmodel"])
    got.get_TOAs(**kw)
    same_toas(got.TOA_list, want.TOA_list, 2, rtol=1e-5, wideband=True)
    # without fit_scat the model's own TAU is applied (and depends on P)
    want.TOA_list.clear()
    want.get_TOAs(quiet=True)
    got.TOA_list.clear()
    got.get_TOAs(quiet=True)
    same_toas(got.TOA_list, want.TOA_list, 2, wideband=True)


def test_cli_narrowband_psrchive_and_nu_ref(ws, capsys):
    tim = str(ws["path"] / "nb.tim")
    base = ["-d", ws["files"][0], "-m", ws["gmodel"], "--device", "cpu",
            "--quiet"]
    assert pptoas.main(base + ["-o", tim, "--narrowband"]) == 0
    with open(tim) as f:
        assert len(f.read().splitlines()) == 2 * NCHAN
    pat = str(ws["path"] / "pat.tim")
    assert pptoas.main(base + ["-o", pat, "--psrchive", "--algorithm",
                               "SIS"]) == 0
    with open(pat) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 * NCHAN and "-chan 0" in lines[0]
    ref = str(ws["path"] / "ref.tim")
    assert pptoas.main(base + ["-o", ref, "--nu_ref", "1400", "--one_DM"]) \
        == 0
    with open(ref) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and all(ln.split()[1] == "1400.00000000"
                                   for ln in lines)
    assert len({ln.split("-pp_dm ")[1].split()[0] for ln in lines}) == 1
    prn = str(ws["path"] / "princeton.tim")
    assert pptoas.main(base + ["-o", prn, "--princeton"]) == 0
    with open(prn) as f:
        assert len(f.read().splitlines()) == 2
    # --fit_dt4 (GM) runs now: its lines carry the gm flags
    gm = str(ws["path"] / "gm.tim")
    assert pptoas.main(base + ["-o", gm, "--fit_dt4"]) == 0
    with open(gm) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and all(" -gm " in ln and " -gm_err " in ln
                                   for ln in lines)


def test_narrowband_paths_never_import_jax(ws):
    code = (
        "import sys\n"
        "import torch\n"
        "from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs\n"
        "torch.set_num_threads(2)\n"
        f"gt = GetTOAs({ws['files'][:1]!r}, {ws['gmodel']!r}, device='cpu',\n"
        "             quiet=True)\n"
        "gt.get_narrowband_TOAs(quiet=True)\n"
        "n = len(gt.get_psrchive_TOAs(algorithm='FDM'))\n"
        "gt.get_TOAs(quiet=True, nu_refs=(1400.0, None, None))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'pulseportraiture_tpu')]\n"
        "print(len(gt.TOA_list), n, len(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-3:] == [str(2 * NCHAN + 2), str(2 * NCHAN),
                                       "0"], out.stdout
