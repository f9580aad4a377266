"""Port parity: pipelines.align (average_archives, psrsmooth_archive,
align_archives with its post-processing options) and cli/ppalign against
the JAX package's, float64 on the CPU; and the slice as a whole: the
port's align_archives -> DataPortrait.make_spline_model -> GetTOAs on
archives from the port's own sim.fake, against the same chain in the JAX
package (tests/test_end_to_end.py:215).

Tolerances: output archives 1e-9 relative; TOAs within 1 ns, DMs within
1e-6 of their errors.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.psrfits import \
    read_psrfits as jread  # noqa: E402
from pulseportraiture_tpu.pipelines import align as jal  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.portrait import \
    DataPortrait as JDataPortrait  # noqa: E402
from pulseportraiture_tpu_torch.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu_torch.io.psrfits import read_psrfits  # noqa: E402
from pulseportraiture_tpu_torch.models.gmodel_io import \
    write_model  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import align as tal  # noqa: E402
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs  # noqa: E402
from pulseportraiture_tpu_torch.portrait import DataPortrait  # noqa: E402
from pulseportraiture_tpu_torch.sim.fake import \
    make_fake_pulsar  # noqa: E402

from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)
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


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """tests/test_end_to_end.py's epochs (3 x 2 subints, 32 x 256, noise
    0.2, dDMs from seed 2026) made by the port, and a 16 x 32 pair for
    the smoothing cases (whose full wavelet search the JAX package
    compiles per level)."""
    ws = tmp_path_factory.mktemp("torch_align")
    par = str(ws / "test.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gm = str(ws / "test.gmodel")
    write_model(gm, "TEST", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    rng = np.random.default_rng(2026)
    dDMs = rng.normal(3e-4, 2e-4, 3)
    files, small = [], []
    for i in range(3):
        f = str(ws / f"epoch-{i + 1}.fits")
        make_fake_pulsar(gm, par, outfile=f, nsub=2, npol=1, nchan=32,
                         nbin=256, tsub=60.0, dDM=dDMs[i],
                         start_MJD=MJD(57202.0 + 20.0 * i), noise_stds=0.2,
                         quiet=True, rng=rng)
        files.append(f)
    for i in range(2):
        f = str(ws / f"small-{i}.fits")
        make_fake_pulsar(gm, par, outfile=f, nsub=2, npol=1, nchan=16,
                         nbin=32, tsub=60.0, start_MJD=MJD(57202.0 + i),
                         noise_stds=0.2, quiet=True, rng=rng)
        small.append(f)
    return dict(path=ws, files=files, dDMs=dDMs, small=small)


def rel_archive(a, b):
    da, db = jread(a).data, read_psrfits(b).data
    assert da.shape == db.shape
    return float(np.max(np.abs(da - db)) / np.max(np.abs(da)))


def test_average_archives_matches_jax(ws):
    a, b = str(ws["path"] / "avg-j.fits"), str(ws["path"] / "avg-t.fits")
    jal.average_archives(ws["files"], a)
    tal.average_archives(ws["files"], b)
    assert rel_archive(a, b) <= 1e-9


ALIGN_CASES = {
    "plain": dict(),
    "norm_prof": dict(norm="prof"),
    "norm_rms": dict(norm="rms"),
    "place": dict(place=0.3),
    "rot_phase": dict(rot_phase=0.1),
    "phase_only_niter2": dict(fit_dm=False, niter=2),
    "subints": dict(tscrunch=False, SNR_cutoff=5.0),
    "smooth": dict(small=True, smooth=True),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_archives_matches_jax(ws, case):
    kw = dict(ALIGN_CASES[case])
    files = ws["small"] if kw.pop("small", False) else ws["files"]
    kw.setdefault("tscrunch", True)
    a, b = (str(ws["path"] / f"al-{case}-{n}.fits") for n in "jt")
    jal.align_archives(datafiles=files, initial_guess=files[0], outfile=a,
                       **kw)
    tal.align_archives(datafiles=files, initial_guess=files[0], outfile=b,
                       device="cpu", **kw)
    assert rel_archive(a, b) <= 1e-9
    assert np.array_equal(jread(a).weights, read_psrfits(b).weights)


def test_psrsmooth_archive(ws):
    """The JAX package's psrsmooth_archive raises on an archive's float32
    samples (its wavelet scan carries float32 into a float64 body:
    ROADMAP queue 3); the port smooths them in float64, as the JAX
    smart_smooth does float64 profiles."""
    src = ws["small"][0]
    with pytest.raises(TypeError):
        jal.psrsmooth_archive(src, str(ws["path"] / "sm-j.fits"))
    from pulseportraiture_tpu.models.wavelet import smart_smooth
    from pulseportraiture_tpu_torch.io.psrfits import write_psrfits
    arch = read_psrfits(src)
    arch.data = np.stack([[np.asarray(smart_smooth(
        np.asarray(p, dtype=np.float64))) for p in sub] for sub in arch.data])
    want = str(ws["path"] / "sm-want.fits")
    write_psrfits(want, arch)
    b = tal.psrsmooth_archive(src, str(ws["path"] / "sm-t.fits"),
                              device="cpu")
    assert rel_archive(want, b) <= 1e-9


@pytest.mark.parametrize("init", ["I", "g", "average", "I_one_channel"])
def test_ppalign_cli_matches_jax(ws, init):
    """The port's ppalign writes what the JAX package's writes, for each
    way of picking the initial template (ppalign.py:342-368)."""
    from pulseportraiture_tpu.cli import ppalign as jcli
    from pulseportraiture_tpu_torch.cli import ppalign
    files = ws["files"]
    one = str(ws["path"] / "one-channel.fits")
    extra = {"I": ["-I", files[1]], "g": ["-g", "0.05"], "average": [],
             "I_one_channel": ["-I", one]}[init]
    if init == "I_one_channel":
        make_fake_pulsar(str(ws["path"] / "test.gmodel"),
                         str(ws["path"] / "test.par"), outfile=one, nsub=1,
                         nchan=1, nbin=256, quiet=True,
                         rng=np.random.default_rng(0))
    a, b = (str(ws["path"] / f"cli-{init}-{n}.fits") for n in "jt")
    base = ["-d", *files, "-T", "--niter", "1", "--quiet"] + extra
    assert jcli.main(base + ["-o", a, "--platform", "cpu", "--x64"]) == 0
    assert ppalign.main(base + ["-o", b, "--device", "cpu"]) == 0
    assert rel_archive(a, b) <= 1e-9


def test_slice_as_a_whole_matches_jax(ws):
    """align -> spline model -> TOAs in each package, on the port's own
    fake archives (tests/test_end_to_end.py:215)."""
    files, p = ws["files"], ws["path"]
    toas = {}
    for name, align, DP, GT, kw in (
            ("jax", jal.align_archives, JDataPortrait, JGetTOAs, {}),
            ("port", tal.align_archives, DataPortrait,
             lambda f, m, quiet: GetTOAs(f, m, device="cpu",
                                         dtype=torch.float64, quiet=quiet),
             dict(device="cpu"))):
        port = str(p / f"built-{name}.fits")
        align(datafiles=files, initial_guess=files[0], tscrunch=True,
              outfile=port, niter=1, quiet=True, **kw)
        dp = DP(port, quiet=True, **kw)
        dp.normalize_portrait("prof")
        dp.make_spline_model(max_ncomp=3, smooth=False, quiet=True,
                             try_nlevels=2)
        spl = str(p / f"built-{name}.spl")
        dp.write_model(spl, quiet=True)
        gt = GT(files, spl, quiet=True)
        gt.get_TOAs(quiet=True)
        toas[name] = gt
    got, want = toas["port"], toas["jax"]
    assert len(got.TOA_list) == len(want.TOA_list) == 6
    for a, b in zip(got.TOA_list, want.TOA_list):
        assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-9
        assert abs(a.DM - b.DM) <= 1e-6 * b.DM_error
    # the relative dDM structure tracks the injection
    rec = np.asarray(got.DeltaDM_means)
    errs = np.asarray(got.DeltaDM_errs) + 1e-5
    inj = ws["dDMs"]
    assert np.all(np.abs((rec - rec.mean()) - (inj - inj.mean())) <
                  8 * errs)


def test_cuda_without_a_card_raises(ws):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a CUDA-less box")
    with pytest.raises(RuntimeError):
        tal.align_archives(datafiles=ws["files"], outfile=str(
            ws["path"] / "never.fits"))


def test_align_fits_recover_the_injected_dDMs(ws):
    """return_fits: one fit a tscrunched epoch, its DM the injected dDM
    less the template epoch's, within 5 of its errors."""
    out = str(ws["path"] / "al-fits.fits")
    got, fits = tal.align_archives(datafiles=ws["files"],
                                   initial_guess=ws["files"][0],
                                   outfile=out, tscrunch=True, device="cpu",
                                   return_fits=True)
    assert got == out and [f["datafile"] for f in fits] == ws["files"]
    for f, dDM in zip(fits, ws["dDMs"]):
        assert abs(f["DM"] - (dDM - ws["dDMs"][0])) <= 5 * f["DM_err"]


def test_float32_fit_polished_to_the_float64_optimum(ws):
    """On the card align_archives fits (phi, DM) in float32, then
    polishes them in float64 (polish_phi_dm).  On the CPU: a float32 fit
    of one epoch against another, polished, reaches the float64 fit
    within 1e-9 of its errors (the float32 fit alone does not), its
    scales within 1e-9 relative."""
    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full, polish_phi_dm)
    from pulseportraiture_tpu_torch.io.archive import load_data
    from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait
    tmpl = load_data(ws["files"][0], dedisperse=True, tscrunch=True,
                     rm_baseline=True, quiet=True)
    model = torch.as_tensor(tmpl.subints[0, 0])
    d = load_data(ws["files"][1], tscrunch=True, rm_baseline=True,
                  quiet=True)
    freqs, P, errs = d.freqs[0], d.Ps[0], d.noise_stds[0, 0]
    nu = float(freqs.mean())
    base = rotate_portrait(torch.as_tensor(d.subints[0, 0]), 0.0, d.DM, P,
                           freqs, nu)
    kw = dict(nu_fits=(nu,) * 3, nu_outs=(nu,) * 3, errs=errs,
              fit_flags=(1, 1, 0, 0, 0), log10_tau=False, scattering=False,
              device="cpu")
    r64, _ = fit_portrait_full(base, model, [0.0] * 5, P, freqs, **kw)
    r32, _ = fit_portrait_full(base.to(torch.float32), model, [0.0] * 5, P,
                               freqs, **kw)
    phi, DM, scales = polish_phi_dm(base, model, float(r32.phi),
                                    float(r32.DM), P, freqs, nu, errs)

    def z(p, dm):
        return max(abs(p - float(r64.phi)) / float(r64.phi_err),
                   abs(dm - float(r64.DM)) / float(r64.DM_err))

    assert z(float(r32.phi), float(r32.DM)) > 1e-9
    assert z(phi, DM) <= 1e-9
    assert float(torch.max(torch.abs(scales - r64.scales)) /
                 torch.max(torch.abs(r64.scales))) <= 1e-9
