"""Port parity: .gmodel templates (models.gmodel_io.read_model,
models.gaussian, ops.gaussian) against the JAX package's, on a .gmodel the
test writes with the JAX package's write_model.

Both evaluate in float64; portraits and profiles agree within 1e-10 of the
peak, spectra within 1e-10 of the largest harmonic.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.models import gaussian as jg  # noqa: E402
from pulseportraiture_tpu.models import gmodel_io as jio  # noqa: E402
from pulseportraiture_tpu.ops import gaussian as jog  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    _ModelSource as JModelSource  # noqa: E402
from pulseportraiture_tpu_torch.models import gaussian as tg  # noqa: E402
from pulseportraiture_tpu_torch.models import gmodel_io as tio  # noqa: E402
from pulseportraiture_tpu_torch.ops import gaussian as tog  # noqa: E402
from pulseportraiture_tpu_torch.pipelines.template import \
    ModelSource  # noqa: E402

NCHAN, NBIN, P = 32, 256, 0.003
FREQS = np.linspace(1100.0, 1900.0, NCHAN)
PHASES = (np.arange(NBIN) + 0.5) / NBIN
# [dc, tau_sec, (loc, m_loc, wid, m_wid, amp, m_amp) x 2]
PARAMS = [0.01, 2e-5,
          0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
          0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]


def peak_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) /
                 np.max(np.abs(want)))


@pytest.fixture(scope="module", params=["000", "010", "111"])
def gmodel(request, tmp_path_factory):
    """A two-component .gmodel with scattering, per evolution code."""
    path = str(tmp_path_factory.mktemp("gmodel") / f"t{request.param}.gmodel")
    params = list(PARAMS)
    if request.param[1] == "1":      # linear width evolution: small slopes
        params[5], params[11] = -2e-5, 1e-5
    if request.param == "111":
        params[3], params[9] = -1e-5, 2e-5
        params[7], params[13] = -2e-3, 1e-3
    jio.write_model(path, "TEST", request.param, 1500.0, params,
                    [1] * len(params), -4.0, 0, quiet=True)
    return path


def test_read_model_header_matches_jax(gmodel):
    want, got = jio.read_model(gmodel), tio.read_model(gmodel)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    for i in (2, 4, 5, 6, 7):
        assert np.array_equal(np.asarray(got[i]), np.asarray(want[i])), i


def test_read_model_portrait_matches_jax(gmodel):
    """Scattered (TAU in seconds -> bins through P)."""
    _, nw, want = jio.read_model(gmodel, PHASES, FREQS, P)
    _, ng, got = tio.read_model(gmodel, PHASES, FREQS, P)
    assert ng == nw == 2 and got.shape == (NCHAN, NBIN)
    assert got.dtype == np.float64
    assert peak_err(got, want) <= 1e-10
    with pytest.raises(ValueError):
        tio.read_model(gmodel, PHASES, FREQS)        # scattered: needs P


@pytest.mark.parametrize("unscat", [False, True])
def test_model_source_matches_jax(gmodel, unscat):
    """The pipelines' template evaluation, with the model's own
    scattering applied and with it zeroed (what fit_scat asks for)."""
    want = JModelSource(gmodel).eval(PHASES, FREQS, P, unscat=unscat)
    src = ModelSource(gmodel)
    got = src.eval(PHASES, FREQS, P, unscat=unscat)
    assert src.kind == "gauss"
    assert peak_err(got, want) <= 1e-10
    assert src.eval(PHASES, FREQS, P, unscat=unscat) is got      # cached
    other = src.eval(PHASES, FREQS, 2 * P, unscat=unscat)
    # only a scattered Gaussian model depends on P
    assert (other is got) == unscat


def test_portrait_with_joins_matches_jax():
    p = np.concatenate([PARAMS, [0.01, 1e-4, -0.02, -2e-4]])
    p[1] = 3.0                                        # tau [bin]
    joins = (np.arange(0, 8), np.arange(20, 32))
    want = jg.gen_gaussian_portrait("000", jnp.asarray(p), -4.0, PHASES,
                                    FREQS, 1500.0, join_ichans=joins, P=P)
    got = tg.gen_gaussian_portrait("000", p, -4.0, PHASES, FREQS, 1500.0,
                                   join_ichans=joins, P=P)
    assert peak_err(got, want) <= 1e-10


@pytest.mark.parametrize("tau_bin", [0.0, 1.5])
def test_profile_and_its_FT_match_jax(tau_bin):
    p = [0.1, tau_bin, 0.3, 0.05, 1.0, 0.62, 0.01, 0.5, 0.9, -0.02, 0.7]
    assert peak_err(tg.gen_gaussian_profile(p, NBIN),
                    jg.gen_gaussian_profile(jnp.asarray(p), NBIN)) <= 1e-10
    assert peak_err(tog.gen_gaussian_profile_FT(p, NBIN),
                    jog.gen_gaussian_profile_FT(jnp.asarray(p), NBIN)) \
        <= 1e-10


@pytest.mark.parametrize("loc,wid", [(0.7, 0.03), (0.02, 0.2), (0.5, 0.0)])
def test_single_gaussians_match_jax(loc, wid):
    for norm in (False, True):
        assert np.max(np.abs(
            tog.gaussian_profile(NBIN, loc, wid, norm=norm) -
            np.asarray(jog.gaussian_profile(NBIN, loc, wid, norm=norm)))) \
            <= 1e-10 * (1.0 if not norm or not wid else 1.0 / wid)
    assert peak_err(tog.gaussian_profile_FT(NBIN, loc, wid, 2.0) + 1e-300,
                    np.asarray(jog.gaussian_profile_FT(NBIN, loc, wid, 2.0))
                    + 1e-300) <= 1e-10
    if wid:
        assert peak_err(tog.gaussian_function(PHASES, loc, wid, True),
                        jog.gaussian_function(PHASES, loc, wid, True)) \
            <= 1e-12


def test_evolution_functions_match_jax():
    for code in ("0", "1"):
        got = tg.evolve_parameter(FREQS, 1500.0, [0.2, 0.5], [-0.1, 0.3],
                                  code)
        want = jg.evolve_parameter(FREQS, 1500.0, jnp.asarray([0.2, 0.5]),
                                   jnp.asarray([-0.1, 0.3]), code)
        assert got.shape == (NCHAN, 2) and peak_err(got, want) <= 1e-14
