"""Port parity: fitters.phase_shift (FFTFIT) against the JAX package's, in
float64 on the CPU, on the same seeded profiles.

Tolerances: phase within 1e-10 rot; phase_err, scale, scale_err, snr and
red_chi2 within 1e-9 relative (both run the same grid and six Newton
steps; only the order of the harmonic sums differs).  The merged twin is
the split twin on the two halves of the stream, bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import phase_shift as jps  # noqa: E402
from pulseportraiture_tpu_torch.fitters import phase_shift as tps  # noqa: E402
from pulseportraiture_tpu_torch.ops import moments as mom  # noqa: E402

from torch_parity_utils import template  # noqa: E402

torch.set_num_threads(2)

NCHAN, NBIN, NOISE = 24, 256, 0.05


def shifted_profiles(seed=0, nchan=NCHAN, nbin=NBIN, noise=NOISE):
    """(data, model, shifts): template rows rotated by seeded shifts in
    [-0.4, 0.4] rot plus white noise."""
    rng = np.random.default_rng(seed)
    model = template(nchan, nbin)
    shifts = rng.uniform(-0.4, 0.4, nchan)
    k = np.arange(nbin // 2 + 1)
    data = np.fft.irfft(np.fft.rfft(model, axis=-1) *
                        np.exp(-2j * np.pi * k * shifts[:, None]), n=nbin,
                        axis=-1) + rng.normal(0.0, noise, (nchan, nbin))
    return data, model, shifts


def _check(got, want):
    assert np.max(np.abs(got.phase.numpy() - np.asarray(want.phase))) <= 1e-10
    for name in ("phase_err", "scale", "scale_err", "snr", "red_chi2"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        # (equal infinities pass: a profile with no convex maximum)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0.0, err_msg=name)


@pytest.mark.parametrize("with_noise", [True, False],
                         ids=["noise_given", "noise_None"])
def test_batch_matches_jax(with_noise):
    data, model, shifts = shifted_profiles()
    noise = np.full(NCHAN, NOISE) if with_noise else None
    want = jps.fit_phase_shift_batch(
        jnp.asarray(data), jnp.asarray(model),
        noise=None if noise is None else jnp.asarray(noise))
    got = tps.fit_phase_shift_batch(
        torch.from_numpy(data), torch.from_numpy(model),
        noise=None if noise is None else torch.from_numpy(noise))
    _check(got, want)
    # and the injected shifts come back within 5 sigma
    z = (got.phase.numpy() - shifts) / got.phase_err.numpy()
    assert np.max(np.abs(z)) < 5.0


@pytest.mark.parametrize("with_noise", [True, False],
                         ids=["noise_given", "noise_None"])
def test_single_matches_jax(with_noise):
    data, model, _ = shifted_profiles(seed=1)
    noise = NOISE if with_noise else None
    want = jps.fit_phase_shift(jnp.asarray(data[3]), jnp.asarray(model[3]),
                               noise=noise, Ns=64)
    got = tps.fit_phase_shift(data[3], model[3], noise=noise, Ns=64)
    assert got.phase.dim() == 0
    _check(got, want)


def test_bounds_and_grid_size_match_jax():
    data, model, _ = shifted_profiles(seed=2)
    kw = dict(bounds=(-0.25, 0.3), Ns=37)
    want = jps.fit_phase_shift_batch(jnp.asarray(data), jnp.asarray(model),
                                     noise=jnp.full(NCHAN, NOISE), **kw)
    got = tps.fit_phase_shift_batch(
        torch.from_numpy(data), torch.from_numpy(model),
        noise=torch.full((NCHAN,), NOISE, dtype=torch.float64), **kw)
    _check(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_merged_twin_equals_split_twin_bitwise(dtype):
    rng = np.random.default_rng(3)
    nh = 129
    Gr = torch.as_tensor(rng.normal(size=(2, 7, nh)), dtype=dtype)
    Gi = torch.as_tensor(rng.normal(size=(2, 7, nh)), dtype=dtype)
    phis = torch.as_tensor(rng.uniform(-3, 3, (2, 7)), dtype=dtype)
    g = torch.cat([Gr, Gi], dim=-1)
    n0 = mom.phase_moments_merged.launches
    for a, b in zip(mom.phase_moments_merged(phis, g),
                    mom.phase_moments_reference(phis, Gr, Gi)):
        assert a.shape == (2, 7) and torch.equal(a, b)
    # a CPU tensor takes the twin: no launch is counted
    assert mom.phase_moments_merged.launches == n0
    with pytest.raises(ValueError):
        mom.phase_moments_merged(phis, g[..., :-1])


def test_float32_fit_stays_within_a_hundredth_sigma_of_float64():
    """float32 (double-single phasor in the moments, float64-built grid
    table) against float64 on the same profiles: 0.01 sigma."""
    data, model, _ = shifted_profiles(seed=4)
    noise = torch.full((NCHAN,), NOISE, dtype=torch.float64)
    ref = tps.fit_phase_shift_batch(torch.from_numpy(data),
                                    torch.from_numpy(model), noise=noise)
    got = tps.fit_phase_shift_batch(torch.from_numpy(data).float(),
                                    torch.from_numpy(model).float(),
                                    noise=noise.float())
    assert got.phase.dtype == torch.float32
    z = (got.phase.double() - ref.phase) / ref.phase_err
    assert float(z.abs().max()) < 1e-2
    assert float(((got.phase_err.double() - ref.phase_err) /
                  ref.phase_err).abs().max()) < 1e-4


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tps.fit_phase_shift_batch(torch.zeros(4, 64), torch.zeros(3, 64))
