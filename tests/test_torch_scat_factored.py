"""The scattering-moments kernel's own algorithm on the CPU.

ops.moments.scattering_moments_factored_reference walks the steps of
csrc/scat_moments.cu (closed-form sums, groups of 4 harmonics from each
row's aligned body, the factored phasor F_l E_m S_j, the lanes' butterfly)
in torch; it is held against the plain twin and the JAX package here, and
against the kernel on the card in tests/test_torch_kernels.py.  Also the
host rule scat_geometry.

Tolerances:
  * float64, against the twin and JAX _scat_terms_ref: 1e-12 of
    sum_k |summand_k| per sum (the closed forms are exact algebra; rounding
    only);
  * float32, against the JAX Pallas kernel in interpret mode (its phasor
    factored another way, its B-algebra the long form):
    tests/test_torch_scattering.py's 2e-6 of sum_k |summand_k|;
  * the float32 three-factor phasor: 6e-7 from the float64 phasor for
    k <= 4096 (the direct double-single phasor strays up to ~5.7e-7).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.ops import pallas_moments as jpm  # noqa: E402
from pulseportraiture_tpu_torch.fitters.stats import SCAT_NAMES  # noqa: E402
from pulseportraiture_tpu_torch.ops import moments as mom  # noqa: E402

torch.set_num_threads(2)

TAUS = (8e-3, 3e-5, -2e-3, 0.4)


def _inputs(lead, nh, seed, tau):
    """(phis, taus, Gr, Gi, M2) float64 numpy, M2 shared by the items."""
    rng = np.random.default_rng(seed)
    phis = rng.uniform(-3.0, 3.0, lead)
    taus = tau * 10.0 ** rng.uniform(-1.0, 1.0, lead)
    Gr = rng.normal(size=lead + (nh,))
    Gi = rng.normal(size=lead + (nh,))
    M2 = np.abs(rng.normal(size=lead[-1:] + (nh,)))
    return phis, taus, Gr, Gi, M2


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("nh", [1, 3, 127, 128, 129, 1025, 2049])
def test_factored_float64_matches_twin_and_jax(nh, tau):
    """Every row offset mod 4 (base, and the rows of an odd nh), each lane
    count: within 1e-12 of sum |summand| of the twin and of JAX."""
    arrs = _inputs((2, 5), nh, nh, tau)
    t = [torch.from_numpy(a) for a in arrs]
    twin = mom.scattering_moments_reference(*t)
    scale = mom.scattering_moments_reference(*t, absolute=True)
    want = jpm._scat_terms_ref(*(jnp.asarray(a) for a in arrs),
                               jnp.arange(float(nh)))
    for lanes in mom.SCAT_LANES:
        for base in range(4):
            got = mom.scattering_moments_factored_reference(
                *t, lanes=lanes, base=base)
            for name, g, r, w, s in zip(SCAT_NAMES, got, twin, want, scale):
                assert g.dtype == torch.float64 and g.shape == (2, 5)
                bound = 1e-12 * s.numpy()
                assert np.all(np.abs((g - r).numpy()) <= bound), \
                    (name, lanes, base)
                assert np.all(np.abs(g.numpy() - np.asarray(w)) <= bound), \
                    (name, lanes, base)


@pytest.mark.parametrize("lanes", [8, 32])
@pytest.mark.parametrize("nharm", [64, 200, 257])
def test_factored_float32_matches_jax_kernel(nharm, lanes):
    """Float32 against the JAX Pallas kernel in interpret mode, as
    tests/test_torch_scattering.py runs it (40 channels), per-item M2 rows
    as the narrowband fit_scat path gives them."""
    rng = np.random.default_rng(nharm + lanes)
    freqs = np.linspace(1100.0, 1900.0, 40)
    phis = rng.uniform(-3.0, 3.0, 40).astype(np.float32)
    taus = (8e-3 * (freqs / 1500.0) ** -4.0 * 10.0 ** rng.uniform(
        -1, 1, 40)).astype(np.float32)
    Gr, Gi, M2 = (rng.normal(size=(40, nharm)).astype(np.float32)
                  for _ in range(3))
    M2 = np.abs(M2)
    t = [torch.from_numpy(a) for a in (phis, taus, Gr, Gi, M2)]
    got = mom.scattering_moments_factored_reference(*t, lanes=lanes, base=1)
    want = jpm.scattering_moments(*(jnp.asarray(a) for a in
                                    (phis, taus, Gr, Gi, M2)),
                                  interpret=True)
    scale = mom.scattering_moments_reference(*(a.double() for a in t),
                                             absolute=True)
    for name, g, w, s in zip(SCAT_NAMES, got, want, scale):
        assert g.dtype == torch.float32 and g.shape == (40,)
        err = np.abs(g.double().numpy() - np.asarray(w, np.float64))
        assert np.all(err <= 2e-6 * s.numpy()), (name, err.max())


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_factored_phasor_float32_within_6e_7(lanes):
    """F_l E_m S_j in float32 against e^{2 pi i phi k} in float64 at every
    k <= 4096 the groups reach, every head offset, phases of several turns
    (the kernel wraps them first)."""
    phis = np.concatenate([[0.0123456, -0.4999, 0.25, 1e-4, 1.73219,
                            -2.61803, 2.999, -1.5],
                           np.random.default_rng(lanes).uniform(-3, 3, 56)])
    phis = phis.astype(np.float32)
    p = torch.from_numpy(phis)
    p = p - torch.round(p)
    for h in range(4):
        steps = -(-((4096 + 1 + h + 3) // 4) // lanes)
        h0 = torch.full((len(phis),), -h)
        pr, pi = mom._scat_phasor(p, h0, lanes, 4, steps)
        assert pr.dtype == torch.float32
        k = (-h + 4 * (torch.arange(lanes)[None, :, None] + lanes *
                       torch.arange(steps)[:, None, None]) +
             torch.arange(4)).reshape(-1)
        ok = (k >= 0) & (k <= 4096)
        ang = 2.0 * np.pi * torch.from_numpy(phis.astype(np.float64))[
            :, None] * k[ok].double()
        err = torch.hypot(pr.reshape(len(phis), -1)[:, ok].double() -
                          torch.cos(ang),
                          pi.reshape(len(phis), -1)[:, ok].double() -
                          torch.sin(ang))
        assert float(err.max()) <= 6e-7, (h, float(err.max()))


@pytest.mark.parametrize("rows,nh,want", [
    (131072, 128, (8, 8, 4096)), (131072, 1025, (16, 4, 16)),
    (4096, 128, (16, 4, 4096)), (4096, 1025, (16, 4, 4096)),
])
def test_scat_geometry_fills_the_card(rows, nh, want):
    """chip_smoke.py's shapes on an H100 (132 SMs, 50 MB of L2): B=32 items
    of 4096 channels against a shared M2, and 4096 items with an M2 row
    each.  8 lanes a row unless a lane would hold 128 harmonics or the grid
    fewer than SCAT_FILL_WARPS warps an SM; blocks of 64 threads unless
    there would be fewer than two an SM; row order unless an item's pass
    over its rows outgrows half the L2 (the full band's 50 MB)."""
    lanes, rpb, tile = mom.scat_geometry(rows, nh, 132, 4096, 50 * 2 ** 20)
    assert (lanes, rpb, tile) == want
    assert rows * lanes // 32 >= mom.SCAT_FILL_WARPS * 132
    assert nh < mom.SCAT_LANE_HARMONICS * lanes
    assert lanes == 8 or (rows * lanes // 64 < mom.SCAT_FILL_WARPS * 132 or
                          nh >= mom.SCAT_LANE_HARMONICS * lanes // 2)
    assert -(-rows // rpb) >= 2 * 132
    assert (lanes * rpb) % 32 == 0 and lanes * rpb <= mom.SCAT_MAX_THREADS


@pytest.mark.parametrize("rows", [1, 7, 77, 4096, 10 ** 6])
def test_scat_geometry_is_a_launch_the_kernel_takes(rows):
    """Any row count and nh, one SM or the H100's 132; a row gets no more
    lanes than it has groups of 4 harmonics, nor fewer than 8; the tile
    is 1..m2_rows."""
    for nsm in (1, 132):
        for nh in (1, 3, 40, 128, 1025, 4097):
            for m2_rows in {1, rows}:
                lanes, rpb, tile = mom.scat_geometry(rows, nh, nsm, m2_rows)
                assert lanes in mom.SCAT_LANES and rpb >= 1
                assert (lanes * rpb) % 32 == 0 and lanes * rpb <= 256
                assert lanes == 8 or lanes <= -(-nh // 4)
                assert 1 <= tile <= m2_rows


def test_task_order_is_a_permutation():
    """csrc/scat_moments.cu task_row, written out: every tile (the last
    one short) visits each row once and reads M2 row r % m2_rows."""
    for rows, m2_rows in ((32 * 70, 70), (3 * 45, 45), (6, 1), (77, 77)):
        items = rows // m2_rows
        for tile in sorted({1, 7, 16, m2_rows} & set(range(1, m2_rows + 1))):
            seen = []
            for t in range(rows):
                k, w = divmod(t, tile * items)
                tt = min(tile, m2_rows - k * tile)
                item, c = divmod(w, tt)
                c += k * tile
                seen.append(item * m2_rows + c)
                assert seen[-1] % m2_rows == c
            assert sorted(seen) == list(range(rows))
            if tile == m2_rows:
                assert seen == list(range(rows))


def test_cpu_wrapper_keeps_the_twin():
    """On the CPU the wrapper is the twin, bit for bit, and counts no
    launch; the factored reference is for tests only."""
    t = [torch.from_numpy(a.astype(np.float32)) for a in
         _inputs((3, 4), 129, 5, 8e-3)]
    n0 = mom.scattering_moments.launches
    got = mom.scattering_moments(*t)
    want = mom.scattering_moments_reference(*t)
    assert mom.scattering_moments.launches == n0
    assert all(torch.equal(g, w) for g, w in zip(got, want))
