"""Port parity: fitters.arrival_time (the six pat-style shift estimators)
against the JAX package's, in float64 on the CPU, on the same seeded
profiles.

Tolerances: shift within 1e-10 rot; shift_err, scale and snr within 1e-9
relative.  shift_FDM's quadrature walks the channels in chunks; its result
does not depend on the chunk, bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import arrival_time as jat  # noqa: E402
from pulseportraiture_tpu_torch.fitters import arrival_time as tat  # noqa: E402

from test_torch_phase_shift import NCHAN, NOISE, shifted_profiles  # noqa: E402

torch.set_num_threads(2)


def _check(got, want):
    assert np.max(np.abs(got.shift.numpy() - np.asarray(want.shift))) <= 1e-10
    for name in ("shift_err", "scale", "snr"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        # (equal infinities pass: a profile with no convex maximum)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=0.0, err_msg=name)


@pytest.mark.parametrize("algorithm", tat.ALGORITHMS)
def test_algorithm_matches_jax(algorithm):
    data, model, shifts = shifted_profiles(seed=10)
    noise = np.full(NCHAN, NOISE)
    want = jat.arrival_time_shifts(jnp.asarray(data), jnp.asarray(model),
                                   noise=jnp.asarray(noise),
                                   algorithm=algorithm)
    got = tat.arrival_time_shifts(torch.from_numpy(data),
                                  torch.from_numpy(model),
                                  noise=torch.from_numpy(noise),
                                  algorithm=algorithm)
    _check(got, want)
    if algorithm != "COF":       # the centroid is biased by the second peak
        assert np.max(np.abs(got.shift.numpy() - shifts)) < 1.0 / 256


@pytest.mark.parametrize("algorithm", ["PGS", "SIS", "GIS"])
def test_self_estimated_noise_matches_jax(algorithm):
    data, model, _ = shifted_profiles(seed=11)
    want = jat.arrival_time_shifts(jnp.asarray(data), jnp.asarray(model),
                                   algorithm=algorithm)
    got = tat.arrival_time_shifts(torch.from_numpy(data),
                                  torch.from_numpy(model),
                                  algorithm=algorithm)
    _check(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fdm_is_independent_of_its_chunk(dtype):
    data, model, _ = shifted_profiles(seed=12)
    args = (torch.as_tensor(data, dtype=dtype),
            torch.as_tensor(model, dtype=dtype),
            torch.full((NCHAN,), NOISE, dtype=dtype))
    whole = tat.shift_FDM(*args)
    for chunk in (1, 5, NCHAN):
        part = tat.shift_FDM(*args, chunk=chunk)
        for a, b in zip(part, whole):
            assert torch.equal(a, b), chunk


def test_pgs_and_sis_points_coincide_and_errors_differ():
    """With one white noise level per channel the scalar weight cancels in
    the CCF argmax."""
    data, model, _ = shifted_profiles(seed=13)
    args = (torch.from_numpy(data), torch.from_numpy(model))
    noise = torch.full((NCHAN,), NOISE, dtype=torch.float64)
    pgs = tat.shift_PGS(*args, noise=noise)
    sis = tat.shift_SIS(*args, noise=noise)
    assert torch.equal(pgs.shift, sis.shift)
    assert not torch.allclose(pgs.shift_err, sis.shift_err, rtol=1e-3)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        tat.arrival_time_shifts(torch.zeros(2, 64), torch.zeros(2, 64),
                                algorithm="XYZ")
