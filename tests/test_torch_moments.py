"""Port parity: ops.moments.phase_moments against the JAX package.

On the CPU the port's wrapper runs its plain twin.  float32: against the
JAX Pallas phase-moments kernel run in interpret mode (the JAX package's
own CPU mode), natural order.  The JAX kernel factors the phasor
(e^{i t 128 q} e^{i t r}) while the twin evaluates it per harmonic, so
the two agree to f32 rounding of the phasor and of the sums: 2e-6 of
sum_k |G_k| k^p (2 pi)^p.  float64: against the JAX plain reference at
1e-12 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.ops import pallas_moments as jpm  # noqa: E402
from pulseportraiture_tpu_torch.ops import moments as mom  # noqa: E402

from torch_parity_utils import rel_err  # noqa: E402

torch.set_num_threads(2)


def _inputs(nchan, nharm, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, nchan), rng.normal(size=(nchan, nharm)),
            rng.normal(size=(nchan, nharm)))


@pytest.mark.parametrize("nharm", [129, 257])
def test_phase_moments_float32_matches_jax_kernel(nharm):
    phis, Gr, Gi = (a.astype(np.float32) for a in _inputs(40, nharm, 7))
    n0 = mom.phase_moments.launches
    got = mom.phase_moments(*(torch.from_numpy(a) for a in (phis, Gr, Gi)))
    assert mom.phase_moments.launches == n0      # CPU: the twin, no launch
    want = jpm.phase_moments(jnp.asarray(phis), jnp.asarray(Gr),
                             jnp.asarray(Gi), interpret=True)
    k = np.arange(nharm)
    a = np.abs(Gr).astype(np.float64) + np.abs(Gi)
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        bound = 2e-6 * (a * k ** p).sum(-1) * (2 * np.pi) ** p
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= bound), p


def test_phase_moments_float64_matches_jax_reference():
    phis, Gr, Gi = _inputs(3 * 17, 200, 8)
    Gr, Gi = Gr.reshape(3, 17, 200), Gi.reshape(3, 17, 200)
    phis = phis.reshape(3, 17)
    got = mom.phase_moments(*(torch.from_numpy(a) for a in (phis, Gr, Gi)))
    want = jpm.phase_moments_reference(jnp.asarray(phis), jnp.asarray(Gr),
                                       jnp.asarray(Gi))
    for g, w in zip(got, want):
        assert g.shape == (3, 17)
        assert rel_err(g, w) < 1e-12
