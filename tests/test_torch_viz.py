"""Port parity: viz (the diagnostic plots) and the plotting callers, on
the Agg backend with plt.show patched out.

Every plot function on seeded inputs draws the same arrays (images, line
data, histogram bars) as the JAX package's figure within 1e-12 of their
scale, and writes its file.  The callers (GetTOAs.show_fit,
get_channels_to_zap(show=True), get_TOAs(show_plot=True), the four
DataPortrait.show_* methods, pptoas --saveplot, ppzap --saveplot,
ppspline --saveplots) draw what they compute: the fit tuple show_fit
returns, the DataPortrait's own arrays (the JAX package's within 1e-12
where both build the same model; the JAX show_fit rotates float32
samples in float32, so there 1e-3, as tests/test_torch_zap.py holds it).
The GaussianSelector event workflow of tests/test_viz.py, with its fits
against the JAX selector's within 1e-6 of their errors.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax = pytest.importorskip("jax")

from pulseportraiture_tpu import viz as jviz  # noqa: E402
from pulseportraiture_tpu_torch import viz  # noqa: E402
from pulseportraiture_tpu_torch.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu_torch.models.gmodel_io import \
    write_model  # noqa: E402
from pulseportraiture_tpu_torch.sim.fake import \
    make_fake_pulsar  # noqa: E402

torch.set_num_threads(2)


def drawn(fig):
    """What a figure draws: each axes' images, lines' (x, y) and bars."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(im.get_array(), float) for im in ax.get_images()]
        out += [np.asarray(ln.get_xydata(), float) for ln in ax.get_lines()]
        out += [np.array([[p.get_x(), p.get_y(), p.get_width(),
                           p.get_height()] for p in ax.patches], float)]
    return out


def assert_same_drawing(a, b, tol=1e-12):
    da, db = drawn(a), drawn(b)
    assert len(da) == len(db)
    for x, y in zip(da, db):
        assert x.shape == y.shape
        if x.size:
            scale = max(np.max(np.abs(y)), 1e-300)
            assert np.max(np.abs(x - y)) <= tol * scale


@pytest.fixture
def figs(monkeypatch):
    """The figures the port's and the JAX package's viz functions finish,
    in order; plt.show does nothing."""
    got = {"port": [], "jax": []}
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    for name, mod in (("port", viz), ("jax", jviz)):
        real = mod._finish

        def finish(plt_, fig, savefig, show, real=real, into=got[name]):
            into.append(fig)
            return real(plt_, fig, savefig, show)
        monkeypatch.setattr(mod, "_finish", finish)
    return got


@pytest.fixture(scope="module")
def port():
    rng = np.random.default_rng(0)
    nchan, nbin = 12, 64
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.05) ** 2)
    p = prof[None] * np.linspace(2.0, 1.0, nchan)[:, None]
    return p + rng.normal(0, 0.05, (nchan, nbin))


def _both(tmp_path, name, fn, *args, **kw):
    figs = []
    for mod in (viz, jviz):
        path = tmp_path / f"{mod.__name__.split('.')[0]}-{name}.png"
        figs.append(getattr(mod, fn)(*args, savefig=str(path), show=False,
                                     **kw))
        assert path.stat().st_size > 1000
    assert_same_drawing(*figs)


def test_plot_functions_match_jax(port, tmp_path):
    rng = np.random.default_rng(1)
    freqs = np.linspace(1100, 1900, 12)
    _both(tmp_path, "p", "show_portrait", port, freqs=freqs, title="t")
    _both(tmp_path, "p2", "show_portrait", torch.from_numpy(port), rvrsd=True,
          prof=False, fluxprof=False)
    _both(tmp_path, "a", "show_profiles", port, nprofs=4)
    _both(tmp_path, "b", "show_stacked_profiles", port)
    _both(tmp_path, "r", "show_residual_plot", port, port * 0.95,
          title="overall")
    _both(tmp_path, "r2", "show_residual_plot", port, port * 0.9,
          freqs=freqs, errs=np.full(12, 0.05))
    _both(tmp_path, "e", "show_eigenprofiles", rng.normal(0, 1, (64, 3)),
          mean_prof=rng.normal(0, 1, 64))


def test_spline_curve_projections_match_jax(tmp_path):
    from pulseportraiture_tpu.models.spline import fit_parametric_spline
    freqs = np.linspace(1100, 1900, 24)
    proj = np.stack([np.sin(freqs / 300.0), np.cos(freqs / 500.0)], -1)
    tck, _ = fit_parametric_spline(freqs, proj.T, s=0.1)
    tck = tuple(np.asarray(v) if not np.isscalar(v) else v for v in tck)
    _both(tmp_path, "s", "show_spline_curve_projections", proj, freqs,
          tck=tck)


def test_set_colormap():
    viz.set_colormap("magma")
    assert matplotlib.rcParams["image.cmap"] == "magma"
    viz.set_colormap()


def test_gaussian_selector_event_workflow(monkeypatch):
    """tests/test_viz.py's headless drive: drag-add through the rubber
    band, middle-click fit (residual panel), right-click removes the last
    component, auto_gauss bootstrap; each fit within 1e-6 of its errors
    of the JAX selector's on the same events."""
    from pulseportraiture_tpu_torch.ops.gaussian import gaussian_profile

    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    nbin = 128
    rng = np.random.default_rng(0)
    prof = 2.0 * np.asarray(gaussian_profile(nbin, 0.45, 0.06)) + \
        rng.normal(0, 0.02, nbin)

    class _Ev:
        def __init__(self, ax, x, y, button=1, key=None):
            self.inaxes, self.xdata, self.ydata = ax, x, y
            self.button, self.key = button, key

    sels = []
    for mod in (viz, jviz):
        sel = mod.GaussianSelector(prof, 0.02, quiet=True)
        assert sel.ax_resid is not None
        sel._on_press(_Ev(sel.ax, 0.40, 0.0, button=1))
        sel._on_move(_Ev(sel.ax, 0.48, 1.8))
        sel._on_release(_Ev(sel.ax, 0.48, 1.8, button=1))
        assert len(sel.components) == 1
        loc, wid, amp = sel.components[0]
        assert abs(loc - 0.44) < 0.02 and abs(wid - 0.08) < 0.02
        sel._on_press(_Ev(sel.ax, 0.45, 1.0, button=2))
        assert sel.fitted_params is not None
        assert abs(sel.components[0][0] - 0.45) < 0.01
        assert abs(sel.components[0][1] - 0.06) < 0.02
        assert sel.residuals is not None and sel.residuals.std() < 0.05
        sels.append((np.array(sel.fitted_params), np.array(sel.fit_errs)))
        sel._on_press(_Ev(sel.ax, 0.1, 0.0, button=1))
        sel._on_release(_Ev(sel.ax, 0.15, 0.5, button=1))
        assert len(sel.components) == 2
        sel._on_press(_Ev(sel.ax, 0.9, 0.0, button=3))
        assert len(sel.components) == 1
        assert abs(sel.components[0][0] - 0.45) < 0.01
        sel2 = mod.GaussianSelector(prof, 0.02, quiet=True, auto_gauss=0.05)
        assert abs(sel2.components[0][0] - 0.45) < 0.01
        sels.append((np.array(sel2.fitted_params), np.array(sel2.fit_errs)))
        sel._on_key(_Ev(sel.ax, 0.0, 0.0, key="q"))
    for (got, _), (want, errs) in ((sels[0], sels[2]), (sels[1], sels[3])):
        live = errs > 0
        assert np.all(np.abs(got - want)[live] <= 1e-6 * errs[live])


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """One archive of 2 subints x 16 channels x 128 bins from a .gmodel."""
    d = tmp_path_factory.mktemp("torch_viz")
    par = str(d / "m.par")
    with open(par, "w") as f:
        f.write("PSR            TESTPSR\nRAJ            04:37:15.8\n"
                "DECJ           -47:15:08.6\nF0             173.6879\n"
                "DM             2.64476\nPEPOCH         57200\n")
    gmodel = str(d / "m.gmodel")
    params = [0.0, 0.0, 0.35, 0.0, 0.05, 0.0, 5.0, 0.0]
    write_model(gmodel, "TESTPSR", "000", 1500.0, params,
                [1] * len(params), -4.0, 0, quiet=True)
    path = str(d / "m.fits")
    make_fake_pulsar(gmodel, par, outfile=path, nsub=2, npol=1, nchan=16,
                     nbin=128, nu0=1500.0, bw=800.0, tsub=60.0, dDM=2e-4,
                     start_MJD=MJD(57202.0), noise_stds=0.3, quiet=True,
                     rng=np.random.default_rng(7))
    return d, path, gmodel


def _gettoas(archive):
    from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    _, path, gmodel = archive
    got = GetTOAs([path], gmodel, device="cpu", dtype=torch.float64,
                  quiet=True)
    got.get_TOAs(quiet=True)
    want = JGetTOAs([path], gmodel, quiet=True)
    want.get_TOAs(quiet=True)
    return got, want


def test_show_fit_and_zap_plots(archive, figs):
    d, path, _ = archive
    got, want = _gettoas(archive)
    fit = got.show_fit(isub=1, savefig=str(d / "fit.png"), show=False,
                       return_fit=True)
    assert (d / "fit.png").stat().st_size > 1000
    want.show_fit(isub=1, show=True)
    (fp,), (fj,) = figs["port"], figs["jax"]
    port, model = fit[0], fit[1]
    images = [im.get_array() for ax in fp.axes for im in ax.get_images()]
    for im, arr in zip(images, (port, model, port - model)):
        np.testing.assert_array_equal(np.asarray(im), arr)
    assert fp._suptitle.get_text() == fj._suptitle.get_text() == \
        f"{path} subint 1"
    assert_same_drawing(fp, fj, tol=1e-3)
    # every channel below an S/N of 1e3: each subint is drawn, titled
    # with its channels to zap
    figs["port"].clear()
    figs["jax"].clear()
    zg = got.get_channels_to_zap(SNR_threshold=1e3, show=True)
    zw = want.get_channels_to_zap(SNR_threshold=1e3, show=True)
    assert zg == zw and len(figs["port"]) == len(figs["jax"]) == 2
    for isub, (a, b) in enumerate(zip(figs["port"], figs["jax"])):
        assert a.axes[0].get_title() == b.axes[0].get_title() == \
            f"{path} subint {isub} bad chans: {list(range(16))}"
        np.testing.assert_array_equal(
            np.asarray(a.axes[0].get_images()[0].get_array()),
            got.show_fit(isub=isub, show=False, return_fit=True)[0])
        assert_same_drawing(a, b, tol=1e-3)


def test_get_toas_show_plot(archive, figs):
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    _, path, gmodel = archive
    gt = GetTOAs([path], gmodel, device="cpu", dtype=torch.float64,
                 quiet=True)
    gt.get_TOAs(quiet=True, show_plot=True)
    assert len(gt.TOA_list) == 2 and len(figs["port"]) == 2
    for isub, fig in enumerate(figs["port"]):
        port, model = gt.show_fit(isub=isub, show=False,
                                  return_fit=True)[:2]
        np.testing.assert_array_equal(
            np.asarray(fig.axes[2].get_images()[0].get_array()),
            port - model)


def test_cli_plots(archive, figs, tmp_path):
    from pulseportraiture_tpu.cli import ppzap as jppzap
    from pulseportraiture_tpu_torch.cli import pptoas, ppzap
    _, path, gmodel = archive
    pre = str(tmp_path / "res")
    assert pptoas.main(["-d", path, "-m", gmodel, "-o",
                        str(tmp_path / "t.tim"), "--saveplot", pre,
                        "--device", "cpu", "--quiet"]) == 0
    assert (tmp_path / "res_0_0.png").stat().st_size > 1000
    assert len(figs["port"]) == 1
    assert pptoas.main(["-d", path, "-m", gmodel, "-o",
                        str(tmp_path / "t.tim"), "--showplot",
                        "--device", "cpu", "--quiet"]) == 0
    assert len(figs["port"]) == 2
    assert_same_drawing(*figs["port"])
    hists = []
    real = plt.Figure.savefig

    def keep(fig, *a, **k):
        hists.append(drawn(fig))
        return real(fig, *a, **k)

    plt.Figure.savefig = keep
    try:
        for mod, name, extra in ((ppzap, "port", ["--device", "cpu"]),
                                 (jppzap, "jax", [])):
            out = tmp_path / f"{name}-hist.png"
            assert mod.main(["-d", path, "-m", gmodel, "-o",
                             str(tmp_path / f"{name}.zap.fits"),
                             "--saveplot", str(out), "--quiet"] + extra) == 0
            assert out.stat().st_size > 1000
    finally:
        plt.Figure.savefig = real
    assert len(hists) == 2
    # the same channels' reduced chi2 in both: the fits agree within 1e-6
    for x, y in zip(*hists):
        assert x.shape == y.shape
        assert np.max(np.abs(x - y)) <= 1e-6 * max(np.max(np.abs(y)), 1.0)


@pytest.fixture(scope="module")
def spline_portraits(tmp_path_factory):
    """The same spline model built by both packages on one averaged
    archive (tests/test_torch_portrait.py's avg recipe)."""
    from pulseportraiture_tpu.portrait import DataPortrait as JDataPortrait
    from pulseportraiture_tpu_torch.portrait import DataPortrait
    d = tmp_path_factory.mktemp("torch_viz_dp")
    par = str(d / "t.par")
    with open(par, "w") as f:
        f.write("PSR J1234-5678\nRAJ 01:02:03.45678901\n"
                "DECJ -04:05:06.7890123\nF0 345.67890123456789\n"
                "PEPOCH 50000.000000\nDM 34.56789\n")
    gmodel = str(d / "t.gmodel")
    params = [0.0, 0.0, 0.40, 0.0, 0.05, -0.4, 5.0, -1.6]
    write_model(gmodel, "TRUE", "000", 1500.0, params, [1] * len(params),
                -4.0, 0, quiet=True)
    avg = str(d / "avg.fits")
    make_fake_pulsar(gmodel, par, outfile=avg, nsub=1, npol=1, nchan=32,
                     nbin=256, nu0=1500.0, bw=800.0, tsub=600.0, dDM=0.0,
                     start_MJD=MJD(57000.0), noise_stds=0.05, quiet=True,
                     rng=np.random.default_rng(4))
    out = []
    for dp in (DataPortrait(avg, quiet=True, device="cpu"),
               JDataPortrait(avg, quiet=True)):
        dp.normalize_portrait("prof")
        kw = {} if isinstance(dp, DataPortrait) else {"try_nlevels": 2}
        dp.make_spline_model(max_ncomp=3, smooth=False, snr_cutoff=50.0,
                             quiet=True, **kw)
        out.append(dp)
    return d, avg, out


@pytest.mark.parametrize("method", ["show_data_portrait", "show_model_fit",
                                    "show_eigenprofiles",
                                    "show_spline_curve_projections"])
def test_data_portrait_plots_match_jax(spline_portraits, figs, method):
    d, _, (td, jd) = spline_portraits
    getattr(td, method)(savefig=str(d / f"{method}.png"), show=False)
    getattr(jd, method)(show=True)
    assert (d / f"{method}.png").stat().st_size > 1000
    assert_same_drawing(figs["port"][0], figs["jax"][0])


def test_ppspline_saveplots(spline_portraits, figs, tmp_path):
    from pulseportraiture_tpu_torch.cli import ppspline
    _, avg, (td, _) = spline_portraits
    pre = str(tmp_path / "spl")
    assert ppspline.main(["-d", avg, "-o", str(tmp_path / "a.spl"), "-n",
                          "3", "-S", "50", "--saveplots", pre, "--device",
                          "cpu", "--quiet"]) == 0
    for suffix in ("_eig.png", "_spl.png"):
        assert (tmp_path / f"spl{suffix}").stat().st_size > 1000
    assert len(figs["port"]) == 2
    td.show_eigenprofiles(show=True)
    td.show_spline_curve_projections(show=True)
    assert_same_drawing(figs["port"][0], figs["port"][2])
    assert_same_drawing(figs["port"][1], figs["port"][3])
