"""Port parity: DataPortrait (loading, the metafile join machinery,
normalization, smoothing, rotation, the flux fit, make_spline_model,
make_gaussian_model) and the ppspline/ppgauss CLIs against the JAX
package's, float64 on the CPU.

Data: tests/test_portrait_class.py's recipes made by the port's own
sim.fake (the same samples as the JAX package's): the one-archive
avg_archive (32 x 256) and the two-band metafile (2 x 16 x 256).
Tolerances: attributes and portraits 1e-12 relative (join seeds 1e-9 of
a bin); the spline model 1e-12 with the same significant eigenvectors;
Gaussian parameters within 1e-6 of their errors.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.models.gmodel_io import \
    read_model as jread_model  # noqa: E402
from pulseportraiture_tpu.models.spline_io import \
    read_spline_model as jread_spline  # noqa: E402
from pulseportraiture_tpu.portrait import \
    DataPortrait as JDataPortrait  # noqa: E402
from pulseportraiture_tpu_torch.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu_torch.models.gmodel_io import (  # noqa: E402
    read_model, write_model)
from pulseportraiture_tpu_torch.portrait import DataPortrait  # noqa: E402
from pulseportraiture_tpu_torch.sim.fake import \
    make_fake_pulsar  # noqa: E402

torch.set_num_threads(2)
PAR_LINES = [
    "PSR             J1234-5678",
    "RAJ      01:02:03.45678901  1",
    "DECJ     -04:05:06.7890123  1",
    "F0      345.67890123456789  1",
    "PEPOCH        50000.000000",
    "DM                34.56789",
]
MODEL_PARAMS = [0.0, 0.0, 0.40, 0.0, 0.05, -0.4, 5.0, -1.6]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_dp")
    par = str(ws / "t.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gmodel = str(ws / "t.gmodel")
    write_model(gmodel, "TRUE", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    avg = str(ws / "avg.fits")
    make_fake_pulsar(gmodel, par, outfile=avg, nsub=1, npol=1, nchan=32,
                     nbin=256, nu0=1500.0, bw=800.0, tsub=600.0, dDM=0.0,
                     start_MJD=MJD(57000.0), noise_stds=0.05,
                     dedispersed=False, quiet=True,
                     rng=np.random.default_rng(4))
    # the two-band metafile (tests/test_portrait_class.py:108)
    jpar = ws / "j.par"
    jpar.write_text("PSR J1\nRAJ 01:02:03\nDECJ 04:05:06\n"
                    "F0 200.0\nPEPOCH 57000\nDM 20.0\n")
    jgm = str(ws / "j.gmodel")
    write_model(jgm, "J", "000", 1500.0,
                [0.0, 0.0, 0.35, 0.0, 0.04, -0.5, 4.0, -1.5], [1] * 8, -4.0,
                0, quiet=True)
    rng = np.random.default_rng(12)
    bands = []
    for i, nu0 in enumerate([1300.0, 1700.0]):
        f = str(ws / f"band{i}.fits")
        make_fake_pulsar(jgm, str(jpar), outfile=f, nsub=1, npol=1,
                         nchan=16, nbin=256, nu0=nu0, bw=400.0, tsub=60.0,
                         dDM=0.0, start_MJD=MJD(57202.0), noise_stds=0.05,
                         dedispersed=True, quiet=True, rng=rng)
        bands.append(f)
    meta = ws / "bands.meta"
    meta.write_text("\n".join(bands) + "\n")
    return dict(path=ws, avg=avg, meta=str(meta))


def pair(ws, kind):
    return (JDataPortrait(ws[kind], quiet=True),
            DataPortrait(ws[kind], quiet=True, device="cpu"))


def rel(got, want):
    want = np.asarray(want, dtype=float)
    return float(np.max(np.abs(np.asarray(got, dtype=float) - want)) /
                 max(np.max(np.abs(want)), 1e-300))


ATTRS = ("port", "portx", "freqs", "noise_stds", "noise_stdsxs", "SNRs",
         "SNRsxs", "weights", "flux_prof", "flux_profx", "Ps", "masks")


@pytest.mark.parametrize("kind", ["avg", "meta"])
def test_attributes_and_manipulation_match_jax(ws, kind):
    jd, td = pair(ws, kind)
    for a in ATTRS:
        assert rel(getattr(td, a), getattr(jd, a)) <= 1e-12, a
    assert (td.nchan, td.nbin, td.njoin, td.source) == \
        (jd.nchan, jd.nbin, jd.njoin, jd.source)
    assert td.nu0 == pytest.approx(jd.nu0, rel=1e-15)
    assert td.bw == pytest.approx(jd.bw, rel=1e-15)
    if kind == "meta":
        assert np.max(np.abs(td.join_params - jd.join_params)) <= \
            1e-9 / td.nbin
        for a, b in zip(td.join_ichanxs, jd.join_ichanxs):
            assert np.array_equal(a, b)
        f1, f2 = ws["path"] / "p.join", ws["path"] / "j.join"
        td.write_join_parameters(str(f1), quiet=True)
        jd.write_join_parameters(str(f2), quiet=True)
        assert f1.read_text() == f2.read_text()
        for d in (jd, td):
            d.apply_joinfile(1500.0)
        assert rel(td.port, jd.port) <= 1e-12
    for d in (jd, td):
        d.rotate_stuff(0.013, 2e-3, 1400.0)
    assert rel(td.port, jd.port) <= 1e-12
    assert rel(td.portx, jd.portx) <= 1e-12
    for d in (jd, td):
        d.smooth_portrait(nlevel=3)
    assert rel(td.portx, jd.portx) <= 1e-12
    # the noise of a smoothed portrait is at its rounding: held to the
    # portrait's own scale
    assert np.max(np.abs(td.noise_stdsxs - jd.noise_stdsxs)) <= \
        1e-12 * np.max(np.abs(jd.portx))


@pytest.mark.parametrize("method", ["prof", "rms", "mean", "max", "abs"])
def test_normalize_matches_jax(ws, method):
    jd, td = pair(ws, "avg")
    before = td.port.copy()
    for d in (jd, td):
        d.normalize_portrait(method)
    for a in ("port", "portx", "norm_values", "noise_stds", "noise_stdsxs",
              "flux_profx"):
        assert rel(getattr(td, a), getattr(jd, a)) <= 1e-12, a
    if method == "prof":
        jr = jd.fit_flux_profile(quiet=True)
        tr = td.fit_flux_profile(quiet=True)
        for k in ("alpha", "amp"):
            assert abs(tr[k] - jr[k]) <= 1e-6 * jr[k + "_err"]
    td.unnormalize_portrait()
    assert rel(td.port, before) <= 1e-12


def test_make_spline_model_matches_jax(ws):
    jd, td = pair(ws, "avg")
    for d in (jd, td):
        d.normalize_portrait("prof")
        d.make_spline_model(max_ncomp=3, smooth=True, snr_cutoff=50.0,
                            quiet=True, try_nlevels=2)
    assert list(td.ieig) == list(jd.ieig) and len(td.ieig) >= 1
    assert rel(td.model, jd.model) <= 1e-12
    assert rel(td.modelx, jd.modelx) <= 1e-12
    assert rel(td.reconst_port, jd.reconst_port) <= 1e-12
    assert rel(td.eigval, jd.eigval) <= 1e-10
    assert set(td.timing) >= {"pca_s", "smooth_s", "spline_fit_s"}
    out = str(ws["path"] / "port.spl")
    td.write_model(out, quiet=True)
    name, source, datafile, mean_prof, eigvec, tck = jread_spline(out)
    assert rel(mean_prof, jd.smooth_mean_prof) <= 1e-12
    assert eigvec.shape == (256, len(td.ieig))


@pytest.mark.parametrize("kind", ["avg", "meta"])
def test_make_gaussian_model_matches_jax(ws, kind):
    jd, td = pair(ws, kind)
    kw = dict(ref_prof=(1500.0, 200.0), ngauss=1, niter=2,
              fiducial_gaussian=True) if kind == "avg" else \
        dict(ngauss=1, niter=1)
    outs = {}
    for name, d in (("jax", jd), ("port", td)):
        outs[name] = str(ws["path"] / f"{kind}-{name}.gmodel")
        d.make_gaussian_model(outfile=outs[name], quiet=True,
                              writeerrfile=True, **kw)
    want, got = jd.gauss_fit_results, td.gauss_fit_results
    e = np.asarray(want.fit_errs)
    m = e > 0
    assert np.max(np.abs(got.fitted_params - want.fitted_params)[m] /
                  e[m]) <= 1e-6
    assert np.max(np.abs(got.fit_errs - e)[m] / e[m]) <= 1e-6
    assert abs(got.chi2 - want.chi2) <= 1e-9 * want.chi2
    assert rel(td.model, jd.model) <= 1e-9
    if kind == "meta":
        assert np.max(np.abs(td.join_params - jd.join_params)) <= 1e-9
    # the .gmodel the port writes, the JAX reader reads
    jp, tp = jread_model(outs["port"])[4], read_model(outs["jax"])[4]
    assert np.max(np.abs(jp - tp)) <= 2e-8
    assert td.timing["lm_iters"] >= 1
    # every Jacobian is followed by an iteration, accepted or rejected
    assert 1 <= td.timing["lm_jacobians"] <= td.timing["lm_iters"]
    assert 0 <= td.timing["lm_rejected"] < td.timing["lm_iters"]


def test_plots_are_not_ported(ws, tmp_path):
    """The plots are ported now: each show_* method draws and writes its
    file (tests/test_torch_viz.py holds the drawn arrays against the JAX
    package's)."""
    import matplotlib
    matplotlib.use("Agg")
    td = DataPortrait(ws["avg"], quiet=True, device="cpu")
    td.normalize_portrait("prof")
    td.make_spline_model(max_ncomp=3, smooth=False, snr_cutoff=50.0,
                         quiet=True)
    for i, show in enumerate((td.show_data_portrait, td.show_model_fit,
                              td.show_eigenprofiles,
                              td.show_spline_curve_projections)):
        show(savefig=str(tmp_path / f"{i}.png"), show=False)
        assert (tmp_path / f"{i}.png").stat().st_size > 1000


def test_cuda_without_a_card_raises(ws):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a CUDA-less box")
    with pytest.raises(RuntimeError):
        DataPortrait(ws["avg"], quiet=True)


def test_ppspline_and_ppgauss_cli(ws):
    """The port's CLIs write models the JAX readers read; the JAX
    package's models (its ppgauss CLI, its spline writer) the port reads,
    and they agree."""
    from pulseportraiture_tpu.cli import ppgauss as jgauss
    from pulseportraiture_tpu_torch.cli import ppgauss, ppspline
    from pulseportraiture_tpu_torch.models.spline_io import \
        read_spline_model
    p = ws["path"]
    assert ppspline.main(["-d", ws["avg"], "-o", str(p / "cli-port.spl"),
                          "-n", "3", "-S", "50", "--device", "cpu",
                          "--quiet"]) == 0
    jd = JDataPortrait(ws["avg"], quiet=True)
    jd.normalize_portrait("prof")
    jd.make_spline_model(max_ncomp=3, smooth=False, snr_cutoff=50.0,
                         quiet=True, try_nlevels=2)
    jd.write_model(str(p / "api-jax.spl"), quiet=True)
    mine = jread_spline(str(p / "cli-port.spl"))
    theirs = read_spline_model(str(p / "api-jax.spl"))
    assert mine[3].shape == theirs[3].shape == (256,)
    assert rel(mine[3], theirs[3]) <= 1e-12         # the mean profiles
    for cli, out, extra in ((ppgauss, "cli-port.gmodel", ["--device", "cpu"]),
                            (jgauss, "cli-jax.gmodel",
                             ["--platform", "cpu", "--x64"])):
        assert cli.main(["-d", ws["avg"], "-o", str(p / out), "--ngauss",
                         "1", "--niter", "1", "--quiet"] + extra) == 0
    jp = jread_model(str(p / "cli-port.gmodel"))[4]
    tp = read_model(str(p / "cli-jax.gmodel"))[4]
    assert np.max(np.abs(jp - tp)) <= 2e-8
    pre = str(p / "cli-plots")
    assert ppspline.main(["-d", ws["avg"], "-o", str(p / "plots.spl"),
                          "-n", "3", "-S", "50", "--saveplots", pre,
                          "--device", "cpu", "--quiet"]) == 0
    for suffix in ("_eig.png", "_spl.png"):
        assert (p / f"cli-plots{suffix}").stat().st_size > 1000
