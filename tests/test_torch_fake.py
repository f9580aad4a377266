"""Port parity: sim.fake (make_fake_pulsar, make_constant_portrait,
add_scintillation, mean_C2N, dDM) against the JAX package's.  The same
seed must write the same archive: the samples equal to float32 rounding
(and the int16 codes equal) for each recipe; the port's tests can then
make their data without the JAX package.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.mjd import MJD as JMJD  # noqa: E402
from pulseportraiture_tpu.io.psrfits import \
    read_psrfits as jread  # noqa: E402
from pulseportraiture_tpu.sim import fake as jf  # noqa: E402
from pulseportraiture_tpu_torch.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu_torch.io.psrfits import read_psrfits  # noqa: E402
from pulseportraiture_tpu_torch.models.gmodel_io import \
    write_model  # noqa: E402
from pulseportraiture_tpu_torch.sim import fake as tf  # noqa: E402

PAR_LINES = [
    "PSR             J1234-5678",
    "RAJ      01:02:03.45678901  1",
    "DECJ     -04:05:06.7890123  1",
    "F0      345.67890123456789  1",
    "F1       -1.2345679978D-13  1",
    "PEPOCH        50000.000000",
    "DM                34.56789",
]
PARAMS = [0.0, 0.0, 0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
          0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_fake")
    par = str(ws / "t.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gm = str(ws / "t.gmodel")
    write_model(gm, "T", "000", 1500.0, PARAMS, [1] * len(PARAMS), -4.0, 0,
                quiet=True)
    scat = str(ws / "s.gmodel")
    p = list(PARAMS)
    p[1] = 2e-5                                # tau [s] in the model
    write_model(scat, "S", "000", 1500.0, p, [1] * len(p), -4.0, 0,
                quiet=True)
    return ws, par, gm, scat


RECIPES = {
    "dispersed_i2": dict(dDM=3e-4, phase=0.1),
    "dedispersed_f4": dict(dedispersed=True, dtype="f4", dDM=-2e-4),
    "t_scat_scint": dict(t_scat=3e-5, scint=True),
    "model_tau": dict(model="scat"),
    "xs_Cs": dict(xs=[-2.0, -4.1], Cs=[1.0, 1e-3], nu_DM=1400.0, dDM=1e-4,
                  phase=0.05),
    "stokes": dict(npol=4, scales=2.0, noise_stds=0.5),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_make_fake_pulsar_matches_jax(ws, recipe):
    path, par, gm, scat = ws
    kw = dict(RECIPES[recipe])
    model = scat if kw.pop("model", None) == "scat" else gm
    out = {}
    for name, mod, mjd in (("jax", jf, JMJD), ("port", tf, MJD)):
        f = str(path / f"{recipe}-{name}.fits")
        mod.make_fake_pulsar(model, par, outfile=f, nsub=2, nchan=16,
                             nbin=128, tsub=60.0, start_MJD=mjd(57000.0),
                             quiet=True, rng=np.random.default_rng(9),
                             **kw)
        out[name] = f
    a, b = jread(out["jax"]), read_psrfits(out["port"])
    eps = np.finfo(np.float32).eps * np.max(np.abs(a.data))
    assert a.data.shape == b.data.shape
    assert np.max(np.abs(a.data - b.data)) <= eps
    if a.raw_i2 is not None:
        assert np.array_equal(a.raw_i2, b.raw_i2)
    assert (a.DM, a.dedispersed, a.state) == (b.DM, b.dedispersed, b.state)
    assert np.array_equal(a.Ps, b.Ps) and np.array_equal(a.freqs, b.freqs)


def test_make_constant_portrait_matches_jax(ws):
    path, par, gm, _ = ws
    src = str(path / "src.fits")
    tf.make_fake_pulsar(gm, par, outfile=src, nsub=2, nchan=8, nbin=64,
                        quiet=True, rng=np.random.default_rng(2))
    prof = np.sin(np.linspace(0, 2 * np.pi, 64)) ** 2
    for profile, dmc in ((None, False), (prof, True)):
        a, b = str(path / "cj.fits"), str(path / "ct.fits")
        jf.make_constant_portrait(src, a, profile=profile, DM=1.5, dmc=dmc,
                                  quiet=True)
        tf.make_constant_portrait(src, b, profile=profile, DM=1.5, dmc=dmc,
                                  quiet=True)
        ja, tb = jread(a), read_psrfits(b)
        assert np.array_equal(ja.data, tb.data)
        assert (ja.DM, ja.dedispersed) == (tb.DM, tb.dedispersed)
    with pytest.raises(ValueError):
        tf.make_constant_portrait(src, b, profile=prof[:10], quiet=True)


def test_scintillation_and_screen_helpers_match_jax():
    port = np.ones((16, 8))
    for kw in (dict(params=[0.5, 2.0, 0.1, 0.3, 4.0, 0.7]),
               dict(random=True, nsin=3, amax=1.0, wmax=5.0)):
        want = jf.add_scintillation(port, rng=np.random.default_rng(1), **kw)
        got = tf.add_scintillation(port, rng=np.random.default_rng(1), **kw)
        assert np.array_equal(got, want)
    assert np.array_equal(tf.add_scintillation(port, random=False), port)
    assert tf.mean_C2N(1400.0, 1.2, 0.5) == jf.mean_C2N(1400.0, 1.2, 0.5)
    assert tf.dDM(1.2, 0.6, 1400.0, 0.5) == jf.dDM(1.2, 0.6, 1400.0, 0.5)
