"""The port's CUDA kernels against their plain torch twins, on the card.

Needs an NVIDIA card (and nvcc to build csrc/); every test here skips
without one.  On the card machine, which has no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tolerances: the kernels compute in float32 and are held against the twin
in float64 on the same (f32-exact) inputs.  The bound is stated relative
to the largest magnitude in the output (or to the sum of magnitudes of
the summed terms), with room for f32 rounding over nbin/nharm-term sums
and different summation orders.  The trust-region kernel computes in
float64 and is held against its twin's LAPACK eigh relative to |p|
(_tr_tolerance).
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu_torch.ops import moments as mom
from pulseportraiture_tpu_torch.ops import setup_dft as sdft


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _portrait(rng, B, nchan, nbin, noise=0.1):
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) + \
        0.4 * np.exp(-0.5 * ((x - 0.47) / 0.01) ** 2)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    model = prof[None, :] * (freqs[:, None] / 1500.0) ** -1.5
    shifts = rng.uniform(-0.05, 0.05, (B, nchan, 1))
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    data = np.fft.irfft(np.fft.rfft(model, axis=-1) * np.exp(-k * shifts),
                        n=nbin, axis=-1)
    data = data + rng.normal(0.0, noise, data.shape)
    return model, data.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [128, 1025, 2049, 8193])
def test_phase_moments_kernel_matches_twin(cuda, nh):
    rng = np.random.default_rng(nh)
    B, nchan = 3, 77
    Gr = rng.normal(size=(B, nchan, nh)).astype(np.float32)
    Gi = rng.normal(size=(B, nchan, nh)).astype(np.float32)
    phis = rng.uniform(-3.0, 3.0, (B, nchan)).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda) for a in (phis, Gr, Gi)]
    n0 = mom.phase_moments.launches
    got = mom.phase_moments(*t)
    torch.cuda.synchronize()
    assert mom.phase_moments.launches == n0 + 1
    ref = mom.phase_moments_reference(*[a.double() for a in t])
    k = np.arange(nh)
    # bound: f32 rounding of the phasor (~1e-6 rad at k ~ 4096 after the
    # double-single reduction, 1.3e-6 at 8192 through k mod 8192) and of
    # the sums, relative to sum |terms|
    scale = np.sum(np.abs(Gr) + np.abs(Gi), axis=-1)
    for g, r, kp in zip(got, ref, (0, 1, 2)):
        w = np.sum((np.abs(Gr) + np.abs(Gi)) * k ** kp, axis=-1) * \
            (2 * np.pi) ** kp
        err = np.abs(g.double().cpu().numpy() - r.cpu().numpy())
        assert np.all(err <= 2e-6 * (w + scale)), (kp, err.max())


def _scat_inputs(rng, lead, nh, shared_m2):
    """(phis, taus, Gr, Gi, M2) float32 numpy: taus around 8e-3
    (nu/1500)^-4 over two decades, the first rows of item 0 unscattered."""
    freqs = np.linspace(1100.0, 1900.0, lead[-1])
    Gr = rng.normal(size=lead + (nh,)).astype(np.float32)
    Gi = rng.normal(size=lead + (nh,)).astype(np.float32)
    M2 = np.abs(rng.normal(size=lead[-1:] + (nh,) if shared_m2 else
                           lead + (nh,))).astype(np.float32)
    phis = rng.uniform(-3.0, 3.0, lead).astype(np.float32)
    taus = (8e-3 * (freqs / 1500.0) ** -4.0 *
            10.0 ** rng.uniform(-1.0, 1.0, lead)).astype(np.float32)
    taus.reshape(-1)[:3] = 0.0                  # unscattered rows
    return phis, taus, Gr, Gi, M2


def _complex_scale(t):
    """sum_k of the magnitudes of the complex products whose real or
    imaginary parts the 9 sums add (|z| = |G| |B|, |w| = |G| |B|^2, |v| =
    |G| |B|^3), and for S2 of its two parts, |f|^2 and Re(B conj g)
    (8 pi^2 k^2 |B|^6 (3 c^2 + 1) M2), times the sums' k and constant
    factors, float64; S and S1 add real products: their absolute twin."""
    phis, taus, Gr, Gi, M2 = [a.double() for a in t]
    nh = Gr.shape[-1]
    k = torch.arange(nh, dtype=torch.float64, device=Gr.device)
    c2 = (2 * np.pi * k * taus[..., None]) ** 2
    b2 = 1.0 / (1.0 + c2)                                       # |B|^2
    g = torch.hypot(Gr, Gi)
    z, w, v = g * b2.sqrt(), g * b2, g * b2 ** 1.5
    s = mom.scattering_moments_reference(phis, taus, Gr, Gi, M2,
                                         absolute=True)
    f1, f2 = 2 * np.pi, 4 * np.pi ** 2
    return (z.sum(-1), s[1], f1 * (k * z).sum(-1), f1 * (k * w).sum(-1),
            s[4], f2 * (k * k * z).sum(-1), f2 * (k * k * w).sum(-1),
            2 * f2 * (k * k * v).sum(-1),
            2 * f2 * (k * k * b2 ** 3 * (3 * c2 + 1) * M2).sum(-1))


def _check_scat(got, t, lanes, base=0):
    """Each of the 9 sums within 2e-6 of sum |summand| of the float64
    twin, and of the kernel's own algorithm in float32
    (scattering_moments_factored_reference) on the card.  With nh <= 3
    the few summands' real or imaginary parts can be far below the
    magnitudes float32 rounds (the plain float32 twin itself fails 2e-6
    sum |summand| at nh=3): there the scale is _complex_scale."""
    ref = mom.scattering_moments_reference(*[a.double() for a in t])
    bound = mom.scattering_moments_reference(*[a.double() for a in t],
                                             absolute=True)
    if t[2].shape[-1] <= 3:
        bound = _complex_scale(t)
    fac = mom.scattering_moments_factored_reference(*t, lanes=lanes,
                                                    base=base)
    for j, (g, r, f, b) in enumerate(zip(got, ref, fac, bound)):
        assert g.dtype == torch.float32 and g.shape == t[0].shape
        err = (g.double() - r).abs()
        assert bool((err <= 2e-6 * b).all()), (j, float(err.max()))
        err = (g.double() - f.double()).abs()
        assert bool((err <= 2e-6 * b).all()), (j, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("nh,shared_m2,lead", [
    (128, True, (3, 77)), (1025, True, (3, 77)), (2049, True, (3, 77)),
    (200, False, (3, 77)), (1, True, (3, 77)), (3, True, (3, 77)),
    (129, True, (3, 77)), (2049, False, (3, 77)), (4097, True, (2, 9)),
    (1025, False, (4096, 1)), (128, False, (4096, 1)), (8193, True, (2, 9)),
])
def test_scattering_moments_kernel_matches_twin(cuda, nh, shared_m2, lead):
    """Ragged nh (every row offset mod 4), and 4096 items of one channel
    with an M2 row each (the narrowband fit_scat path); a second call
    gives the same bits."""
    rng = np.random.default_rng(nh + 7)
    t = [torch.from_numpy(a).to(cuda)
         for a in _scat_inputs(rng, lead, nh, shared_m2)]
    n0 = mom.scattering_moments.launches
    got = mom.scattering_moments(*t)
    torch.cuda.synchronize()
    assert mom.scattering_moments.launches == n0 + 1
    _check_scat(got, t, mom.scat_launch_geometry(t[0], t[4])[0])
    again = mom.scattering_moments(*t)
    torch.cuda.synchronize()
    for j, (g, a) in enumerate(zip(got, again)):
        assert torch.equal(g, a), j


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_scattering_moments_kernel_every_geometry(cuda, lanes, threads):
    """Every (lanes, rows per block) the kernel takes and
    scripts/torch_scat_tune.py sweeps, at a ragged row count and nh, in
    row order and in tiles of 16 and of 7 M2 rows (the last tile short):
    the same bits in every order."""
    rng = np.random.default_rng(lanes + threads)
    t = [torch.from_numpy(a).to(cuda)
         for a in _scat_inputs(rng, (3, 45), 1025, True)]
    first = None
    for tile in (45, 16, 7):
        got = mom._launch_scat(*t, geometry=(lanes, threads // lanes, tile))
        torch.cuda.synchronize()
        _check_scat(got, t, lanes)
        first = first or got
        for j, (g, f) in enumerate(zip(got, first)):
            assert torch.equal(g, f), (tile, j)


@pytest.mark.cuda
@pytest.mark.parametrize("off_r,off_i,off_m", [(1, 1, 1), (2, 2, 0),
                                               (3, 1, 2), (0, 3, 3)])
def test_scattering_moments_kernel_offset_views(cuda, off_r, off_i, off_m):
    """Gr, Gi and M2 as contiguous views that start off_* elements into
    their storage: the aligned body moves with Gr's offset; a Gi or M2 at
    another offset mod 16 bytes is read by 32-bit loads."""
    rng = np.random.default_rng(off_r + 4 * off_i + 16 * off_m)
    arrs = _scat_inputs(rng, (2, 33), 259, True)

    def view(a, off):
        buf = torch.zeros(a.size + off, dtype=torch.float32, device=cuda)
        buf[off:] = torch.from_numpy(a.ravel()).to(cuda)
        v = buf[off:].view(a.shape)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4 * off
        return v
    t = [torch.from_numpy(a).to(cuda) for a in arrs[:2]]
    t += [view(arrs[2], off_r), view(arrs[3], off_i), view(arrs[4], off_m)]
    got = mom._launch_scat(*t, geometry=(8, 4, 33))
    torch.cuda.synchronize()
    _check_scat(got, t, 8, base=off_r)


@pytest.mark.cuda
@pytest.mark.parametrize("nbin,capped,i16,f0_fact,nchan,seeds,route", [
    (512, True, False, False, 70, True, "fft"),
    (512, False, False, False, 70, True, "fft"),
    (512, True, True, False, 64, True, "fft"),
    (2048, False, True, False, 130, True, "fft"),
    (2048, True, False, True, 33, True, "fft"),
    (256, False, False, True, 5, True, "fft"),
    (255, False, False, False, 7, False, "rfft"),  # odd nbin: no Nyquist term
    (512, True, True, False, 64, False, "fft"),
    (768, True, False, False, 70, True, "fft"),    # 6 x 128: radix 3
    (4096, False, False, False, 33, True, "fft"),
    (4096, True, True, False, 70, False, "fft"),
    (128, False, False, True, 33, True, "fft"),
    (2048, True, True, False, 130, True, "fft"),   # ragged last tile, int16
    (1024, False, False, False, 33, True, "fft"),  # passes 16, 16, 2
    (2048, False, False, False, 5, False, "fft"),  # less than one tile
    (4096, True, True, False, 70, True, "fft"),
    (128, False, True, False, 33, False, "fft"),
    # every odd factor of the mixed-radix plans: int16, ragged last tiles
    # (70 and 130 channels), K=0, less than one tile
    (768, False, True, False, 33, True, "fft"),    # 3 x 128
    (1280, True, False, False, 70, True, "fft"),   # 5 x 128
    (1280, False, True, False, 5, False, "fft"),
    (1792, False, False, True, 33, True, "fft"),   # 7 x 128
    (2304, True, True, False, 130, True, "fft"),   # 9 x 128
    (2816, False, False, False, 5, False, "fft"),  # 11 x 128
    (3328, True, False, False, 70, False, "fft"),  # 13 x 128
    (3840, False, True, False, 33, True, "fft"),   # 15 x 128, one block/SM
    (3840, True, False, False, 70, True, "fft"),
    (1536, False, False, False, 130, True, "fft"),  # 3 x 256
    (3072, True, True, False, 33, True, "fft"),    # 3 x 512
    (2560, False, False, False, 70, False, "fft"),  # 5 x 256
    (3584, True, False, False, 33, True, "fft"),   # 7 x 256
    (1000, False, False, False, 33, True, "rfft"),  # 8 x 125: no FFT plan
    # the packed workers (2, 4, 8, 16 threads: several rows to a warp, a
    # group of rows in one bulk copy) and 8192 (a third radix-16 pass,
    # 512-thread blocks): int16, ragged last tiles, K=0, less than one tile
    (64, False, False, False, 70, True, "fft"),
    (64, False, True, False, 300, True, "fft"),
    (64, False, False, True, 5, False, "fft"),
    (128, False, True, False, 130, True, "fft"),
    (128, False, False, False, 5, False, "fft"),
    (256, True, True, False, 70, True, "fft"),
    (256, False, False, False, 33, False, "fft"),
    (512, False, True, False, 130, True, "fft"),
    (512, True, False, True, 5, False, "fft"),
    (8192, False, False, False, 33, True, "fft"),
    (8192, False, True, False, 70, True, "fft"),
    (8192, False, False, True, 5, False, "fft"),
    (8192, False, True, False, 130, False, "fft"),
    (4608, False, False, False, 33, True, "rfft"),  # 256 x 18: no FFT plan
    # the rfft route above 8192 bins: odd rows of an odd nhf start off a
    # 16-byte boundary (64-bit loads), int16, ragged last tile, K=0
    (16384, False, False, False, 33, True, "rfft"),
    (16384, False, True, False, 70, True, "rfft"),
    (16384, False, False, True, 5, False, "rfft"),
    # the rfft route's epilogue: every head offset (nh odd: rows four
    # channels apart share one), nh mod 4 = 0..3 over odd nhf (501, 503,
    # 129) and even nhf (502, 500), prefixes (capped = nh), K = 0, 1 and
    # 2 (seeds), one tile (B = 1, one channel: nchan = (B, nchan)),
    # channels not a multiple of the tile, two row slices (16384)
    (1000, 500, False, False, 33, True, "rfft"),
    (1000, 499, True, False, 33, 1, "rfft"),
    (1000, 498, False, True, (1, 7), False, "rfft"),
    (1000, 125, False, False, (2, 70), True, "rfft"),
    (1002, False, False, False, 33, True, "rfft"),
    (1002, 501, True, False, 70, 1, "rfft"),
    (1002, 500, False, False, (1, 5), True, "rfft"),
    (1002, 499, False, True, (2, 33), False, "rfft"),
    (1004, False, True, False, 33, 1, "rfft"),
    (998, False, False, False, 70, True, "rfft"),
    (257, False, False, False, 33, 1, "rfft"),
    (1000, False, False, False, (1, 1), True, "rfft"),
    (4608, False, True, False, (3, 300), 1, "rfft"),
    (16384, False, False, False, (1, 9), 1, "rfft"),
    (16384, 8000, True, False, (2, 13), True, "rfft"),
])
def test_fused_setup_kernel_matches_twin(cuda, nbin, capped, i16, f0_fact,
                                         nchan, seeds, route):
    # nchan may be (B, nchan); seeds: True for 2 seed columns, False for
    # none, or the count; capped: True for the band cap, False for the
    # full band, or the count of harmonics of a prefix
    B, nchan = nchan if isinstance(nchan, tuple) else (3, nchan)
    kseed = 2 if seeds is True else 0 if seeds is False else seeds
    seeds = kseed > 0
    rng = np.random.default_rng(nbin + nchan)
    model, data = _portrait(rng, B, nchan, nbin)
    mf = np.fft.rfft(model, axis=-1)
    mr, mi = mf.real.astype(np.float32), mf.imag.astype(np.float32)
    if capped is True:
        mr, mi, mh = sdft.band_cap_model_ft(mr, mi, nbin, f0_fact=f0_fact)
        assert mh is not None
        nh = sdft.cap_nharm(nbin, mh)
        mr, mi = mr[:, :nh], mi[:, :nh]
    elif capped is not False:
        mr, mi = mr[:, :capped], mi[:, :capped]
    scale = None
    x = data
    if i16:
        from pulseportraiture_tpu_torch.io.native import quantize_i2
        raw, scl, _ = quantize_i2(data)
        x, scale = raw, scl.astype(np.float32)
    w = rng.uniform(0.5, 2.0, (B, nchan, max(kseed, 1))).astype(np.float32)
    w[:, : nchan // 2, -1] = 0.0
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
           for a in (x, mr, mi, w)]
    sc = None if scale is None else torch.from_numpy(scale).to(cuda)
    wt = dev[3] if seeds else None
    assert sdft.setup_route(nbin) == route
    n0, r0 = sdft.fused_setup.launches, dict(sdft.fused_setup.routes)
    got = sdft.fused_setup(dev[0], dev[1], dev[2], f0_fact=f0_fact, w=wt,
                           scale=sc)
    torch.cuda.synchronize()
    assert sdft.fused_setup.launches == n0 + 1
    other = "rfft" if route == "fft" else "fft"
    assert sdft.fused_setup.routes[route] == r0[route] + 1
    assert sdft.fused_setup.routes[other] == r0[other]
    assert len(got) == (5 if seeds else 3)
    ref = sdft.fused_setup_reference(
        dev[0], dev[1].double(), dev[2].double(), f0_fact=f0_fact,
        w=None if wt is None else wt.double(),
        scale=None if sc is None else sc.double())
    names = ("Gr", "Gi", "sd", "gsr", "gsi")
    gmax = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
    smax = max(float(r.abs().max()) for r in ref[3:]) if seeds else 0.0
    # above 8192 bins 2e-5 of the largest |output| would admit a TF32
    # DFT's error (chip_smoke.setup_case): 4e-6 there
    rel = 2e-5 if nbin <= 8192 else 4e-6
    for name, g, r in zip(names, got, ref):
        err = float((g.double() - r).abs().max())
        bound = {"sd": rel * float(r.abs().max()),
                 "gsr": rel * smax, "gsi": rel * smax}.get(name, rel * gmax)
        assert err <= bound, (name, err, bound)
    # no float atomics, fixed summation orders: the same bits again
    again = sdft.fused_setup(dev[0], dev[1], dev[2], f0_fact=f0_fact,
                             w=wt, scale=sc)
    torch.cuda.synchronize()
    for name, g, a in zip(names, got, again):
        assert torch.equal(g, a), name
    if route == "rfft":
        # the epilogue alone against its twin on the same spectrum
        X = torch.fft.rfft(dev[0].float(), dim=-1)
        epi = sdft._launch_epilogue(X, dev[1], dev[2], f0_fact, wt, sc)
        rows = sdft.epilogue_geometry(B, nchan, X.shape[-1],
                                      dev[1].shape[-1], kseed, cuda).rows
        twin = sdft.setup_epilogue_reference(
            X, dev[1].double(), dev[2].double(), f0_fact=f0_fact,
            w=None if wt is None else wt.double(),
            scale=None if sc is None else sc.double(), rows=rows)
        again = sdft._launch_epilogue(X, dev[1], dev[2], f0_fact, wt, sc)
        torch.cuda.synchronize()
        assert len(epi) == (5 if seeds else 3)
        for name, g, r, a in zip(names, epi, twin, again):
            bound = 4e-6 * float(r.abs().max())
            assert float((g.double() - r).abs().max()) <= bound, name
            assert torch.equal(g, a), name


@pytest.mark.cuda
def test_fused_setup_routes_agree_on_the_card(cuda):
    """The two hand-written routes on the same input of a width both take
    (1536 = 6 x 256: the FFT route's radix-3 plan; the rfft route through
    its launcher): the same function."""
    rng = np.random.default_rng(9)
    B, nchan, nbin = 2, 70, 1536
    model, data = _portrait(rng, B, nchan, nbin)
    mf = np.fft.rfft(model, axis=-1)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        data, mf.real.astype(np.float32), mf.imag.astype(np.float32),
        rng.uniform(0.5, 2.0, (B, nchan, 2)).astype(np.float32))]
    assert sdft._check(*t, None) == 2
    r0 = dict(sdft.fused_setup.routes)
    fft = sdft._launch_fft(t[0], t[1], t[2], False, t[3], None)
    rfft = sdft._launch_rfft(t[0], t[1], t[2], False, t[3], None)
    torch.cuda.synchronize()
    assert sdft.fused_setup.routes == {"fft": r0["fft"] + 1,
                                       "rfft": r0["rfft"] + 1}
    for name, a, b in zip(("Gr", "Gi", "sd", "gsr", "gsi"), fft, rfft):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-5 * scale, name


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 4, 256), dtype=torch.float64, device=cuda)
    m = torch.zeros((4, 129), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        sdft.fused_setup(x, m, m)
    # the FFT route's bulk copies need a 16-byte aligned x: a contiguous
    # view that starts 4 bytes into its storage is refused, not rerouted
    buf = torch.zeros(4 * 256 + 1, dtype=torch.float32, device=cuda)
    off = buf[1:].view(1, 4, 256)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    n0 = sdft.fused_setup.launches
    with pytest.raises(ValueError, match="16-byte"):
        sdft.fused_setup(off, m, m)
    assert sdft.fused_setup.launches == n0
    # the FFT route keeps two seed columns' sums in registers, no more
    x = torch.zeros((1, 4, 256), device=cuda)
    with pytest.raises(ValueError, match="seed columns"):
        sdft.fused_setup(x, m, m, w=torch.ones((1, 4, 3), device=cuda))
    assert sdft.fused_setup.launches == n0
    with pytest.raises(TypeError):
        mom.phase_moments(torch.zeros((1, 4), dtype=torch.float64,
                                      device=cuda), m[None].double(),
                          m[None].double())
    # harmonic numbers past 2^24 are not exact in f32 (no rows: nothing
    # is allocated)
    wide = torch.zeros((1, 0, mom.MAX_NHARM + 1), device=cuda)
    with pytest.raises(ValueError, match="nharm"):
        mom.phase_moments(torch.zeros((1, 0), device=cuda), wide, wide)
    g = torch.zeros((1, 33, 4), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):          # not contiguous
        mom.phase_moments(torch.zeros((1, 4), device=cuda), g, g)
    p = torch.zeros((1, 4), device=cuda)
    G = torch.zeros((1, 4, 33), device=cuda)
    with pytest.raises(TypeError):
        mom.scattering_moments(p, p, G, G, G[0].double())
    with pytest.raises(ValueError):          # M2 of another shape
        mom.scattering_moments(p, p, G, G, G[0, :, :20].contiguous())
    with pytest.raises(ValueError, match="nharm"):
        mom.scattering_moments(p[:, :0], p[:, :0], wide, wide, wide[0])
    with pytest.raises(ValueError):          # not contiguous
        mom.scattering_moments(p, p, G, G, g[0])


@pytest.mark.cuda
def test_batched_fit_on_card_matches_cpu_float64(cuda):
    from pulseportraiture_tpu_torch.config import DCONST
    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full_batch, template_spectrum)
    rng = np.random.default_rng(0)
    B, nchan, nbin, P, noise = 4, 256, 512, 0.003, 0.1
    model, _ = _portrait(rng, 1, nchan, nbin)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    nu_fit = freqs.mean()
    phis = rng.uniform(-0.01, 0.01, B)
    dms = rng.uniform(-2e-4, 2e-4, B)
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    mf = np.fft.rfft(model, axis=-1)
    data = np.stack([np.fft.irfft(mf * np.exp(-k * (
        phis[i] + DCONST * dms[i] / P * (freqs ** -2 - nu_fit ** -2))[:,
        None]), n=nbin, axis=-1) for i in range(B)])
    data = (data + rng.normal(0, noise, data.shape)).astype(np.float32)
    mr, mi = template_spectrum(model)
    out = {}
    for dev, dt in ((cuda, torch.float32), (torch.device("cpu"),
                                            torch.float64)):
        def t(a):
            return torch.as_tensor(a, dtype=dt, device=dev)
        res = fit_portrait_full_batch(
            torch.from_numpy(data).to(dev), (mr, mi), t(np.zeros((B, 5))),
            t(np.full(B, P)), t(freqs), t(np.full((B, nchan), noise)),
            nu_fits=t(np.full((B, 3), nu_fit)), dtype=dt)
        out[dev.type] = res
    g, c = out["cuda"], out["cpu"]
    assert bool(g.return_code.lt(3).all())
    # f32 on the card vs the f64 CPU twin route: within 1e-2 sigma
    for j in (0, 1):
        d = (g.params[:, j].double().cpu() - c.params[:, j]).abs()
        assert bool((d <= 1e-2 * c.param_errs[:, j]).all()), (j, d)
    # TF32 matmuls would cost the seed and the Newton steps precision
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            fit_portrait_full_batch(
                torch.from_numpy(data).to(cuda), (mr, mi),
                torch.zeros((B, 5), device=cuda),
                torch.full((B,), P, device=cuda),
                torch.as_tensor(freqs, dtype=torch.float32, device=cuda),
                torch.full((B, nchan), noise, device=cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_scattering_fit_on_card_matches_cpu_float64(cuda):
    """(phi, DM, tau, alpha) on the card in float32 (both kernels) agrees
    with the float64 twin route on the CPU within 1e-2 sigma."""
    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full_batch, template_spectrum)
    rng = np.random.default_rng(5)
    B, nchan, nbin, P, noise, tau = 4, 256, 512, 0.003, 0.1, 8e-3
    model, _ = _portrait(rng, 1, nchan, nbin)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    nu_fit = freqs.mean()
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    mf = np.fft.rfft(model, axis=-1)
    sf = mf / (1.0 + k * (tau * (freqs / nu_fit) ** -4.0)[:, None])
    data = np.fft.irfft(sf * np.exp(-k * rng.uniform(-0.01, 0.01, (B, 1, 1))),
                        n=nbin, axis=-1)
    data = (data + rng.normal(0, noise, data.shape)).astype(np.float32)
    init = np.zeros((B, 5))
    init[:, 3], init[:, 4] = np.log10(4e-3), -4.0
    mr, mi = template_spectrum(model)
    out = {}
    n0 = mom.scattering_moments.launches
    for dev, dt in ((cuda, torch.float32), (torch.device("cpu"),
                                            torch.float64)):
        def t(a):
            return torch.as_tensor(a, dtype=dt, device=dev)
        out[dev.type] = fit_portrait_full_batch(
            torch.from_numpy(data).to(dev), (mr, mi), t(init),
            t(np.full(B, P)), t(freqs), t(np.full((B, nchan), noise)),
            nu_fits=t(np.full((B, 3), nu_fit)), fit_flags=(1, 1, 0, 1, 1),
            dtype=dt)
    assert mom.scattering_moments.launches > n0
    g, c = out["cuda"], out["cpu"]
    assert bool(g.return_code.lt(3).all())
    for j in (0, 1, 3, 4):
        d = (g.params[:, j].double().cpu() - c.params[:, j]).abs()
        assert bool((d <= 1e-2 * c.param_errs[:, j]).all()), (j, d)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,aligned", [(128, True), (1024, True),
                                        (1025, True), (130, True),
                                        (2049, True), (128, False),
                                        (8193, True)])
def test_phase_moments_merged_kernel_matches_twin(cuda, nh, aligned):
    """The merged-stream kernel against its float64 twin (the split
    kernel's tolerance) and against the split kernel on the same data:
    with 128-bit loads (nh a multiple of 4 on a 16-byte aligned base) the
    sums are taken in another order, within float32 rounding of
    sum |terms|; with scalar loads (other nh, or a misaligned base) in the
    split kernel's order."""
    rng = np.random.default_rng(nh + 11)
    B, nchan = 3, 77
    Gr = rng.normal(size=(B, nchan, nh)).astype(np.float32)
    Gi = rng.normal(size=(B, nchan, nh)).astype(np.float32)
    phis = rng.uniform(-3.0, 3.0, (B, nchan)).astype(np.float32)
    merged = np.concatenate([Gr, Gi], axis=-1)
    if aligned:
        g = torch.from_numpy(merged).to(cuda)
    else:       # a contiguous view that starts 4 bytes into its storage
        buf = torch.zeros(merged.size + 1, dtype=torch.float32, device=cuda)
        buf[1:] = torch.from_numpy(merged.ravel()).to(cuda)
        g = buf[1:].view(B, nchan, 2 * nh)
        assert g.is_contiguous() and g.data_ptr() % 16 != 0
    p = torch.from_numpy(phis).to(cuda)
    n0 = mom.phase_moments_merged.launches
    got = mom.phase_moments_merged(p, g)
    torch.cuda.synchronize()
    assert mom.phase_moments_merged.launches == n0 + 1
    ref = mom.phase_moments_merged_reference(p.double(), g.double())
    split = mom.phase_moments(p, torch.from_numpy(Gr).to(cuda),
                              torch.from_numpy(Gi).to(cuda))
    k = np.arange(nh)
    a = np.abs(Gr) + np.abs(Gi)
    eps = np.finfo(np.float32).eps
    for o, r, s, kp in zip(got, ref, split, (0, 1, 2)):
        assert o.dtype == torch.float32 and o.shape == (B, nchan)
        w = np.sum(a * k ** kp, axis=-1) * (2 * np.pi) ** kp
        err = np.abs(o.double().cpu().numpy() - r.cpu().numpy())
        assert np.all(err <= 2e-6 * (w + a.sum(-1))), (kp, err.max())
        d = np.abs(o.double().cpu().numpy() - s.double().cpu().numpy())
        assert np.all(d <= eps * w), (kp, d.max())


@pytest.mark.cuda
def test_phase_moments_merged_wrapper_refuses_what_it_does_not_take(cuda):
    p = torch.zeros((1, 4), device=cuda)
    g = torch.zeros((1, 4, 66), device=cuda)
    with pytest.raises(TypeError):
        mom.phase_moments_merged(p.double(), g.double())
    with pytest.raises(ValueError):          # odd last axis: no [Gr | Gi]
        mom.phase_moments_merged(p, g[..., :65].contiguous())
    with pytest.raises(ValueError):          # phis of another shape
        mom.phase_moments_merged(p[:, :3], g)
    with pytest.raises(ValueError):          # nharm beyond the exact range
        mom.phase_moments_merged(p[:, :0], torch.zeros(
            (1, 0, 2 * mom.MAX_NHARM + 2), device=cuda))
    with pytest.raises(ValueError):          # not contiguous
        mom.phase_moments_merged(
            p, torch.zeros((1, 66, 4), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError):          # a CPU phis for a card stream
        mom.phase_moments_merged(p.cpu(), g)


@pytest.mark.cuda
def test_narrowband_fits_on_card_match_cpu_float64(cuda):
    """FFTFIT and the six estimators on the card in float32 (the merged
    kernel in their Newton steps) against the float64 twin route on the
    CPU: shifts within 1e-2 of the formal error."""
    from pulseportraiture_tpu_torch.fitters import arrival_time as at
    from pulseportraiture_tpu_torch.fitters import phase_shift as ps
    rng = np.random.default_rng(21)
    nchan, nbin, noise = 96, 1024, 0.05
    model, _ = _portrait(rng, 1, nchan, nbin)
    shifts = rng.uniform(-0.4, 0.4, (nchan, 1))
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    data = np.fft.irfft(np.fft.rfft(model, axis=-1) * np.exp(-k * shifts),
                        n=nbin, axis=-1) + rng.normal(0, noise,
                                                      (nchan, nbin))

    def args(dev, dt):
        return (torch.as_tensor(data, dtype=dt, device=dev),
                torch.as_tensor(model, dtype=dt, device=dev),
                torch.full((nchan,), noise, dtype=dt, device=dev))

    n0 = mom.phase_moments_merged.launches
    g = ps.fit_phase_shift_batch(*args(cuda, torch.float32))
    assert mom.phase_moments_merged.launches == n0 + 7     # 6 steps + 1
    c = ps.fit_phase_shift_batch(*args(torch.device("cpu"), torch.float64))
    z = (g.phase.double().cpu() - c.phase) / c.phase_err
    assert float(z.abs().max()) < 1e-2
    for alg in at.ALGORITHMS:
        n0 = mom.phase_moments_merged.launches
        g = at.arrival_time_shifts(*args(cuda, torch.float32), algorithm=alg)
        if alg in ("PGS", "FDM", "SIS"):
            assert mom.phase_moments_merged.launches == n0 + 9  # 8 + 1
        c = at.arrival_time_shifts(*args(torch.device("cpu"),
                                         torch.float64), algorithm=alg)
        z = (g.shift.double().cpu() - c.shift) / c.shift_err
        assert float(z.abs().max()) < 1e-2, alg


def _builder_archives(tmp_path, nfile=2):
    """A two-component .gmodel and nfile one-subint archives of it, 32
    channels x 256 bins, from the port's own sim.fake (no JAX here)."""
    from pulseportraiture_tpu_torch.io.mjd import MJD
    from pulseportraiture_tpu_torch.models.gmodel_io import write_model
    from pulseportraiture_tpu_torch.sim.fake import make_fake_pulsar
    par = tmp_path / "b.par"
    par.write_text("PSR J1\nRAJ 01:02:03\nDECJ 04:05:06\nF0 200.0\n"
                   "PEPOCH 57000\nDM 20.0\n")
    gm = str(tmp_path / "b.gmodel")
    p = [0.0, 0.0, 0.4, 0.0, 0.05, -0.4, 5.0, -1.6,
         0.47, 0.0, 0.02, 0.0, 2.0, -1.0]
    write_model(gm, "B", "000", 1500.0, p, [1] * len(p), -4.0, 0,
                quiet=True)
    rng = np.random.default_rng(21)
    files = []
    for i in range(nfile):
        f = str(tmp_path / f"b{i}.fits")
        make_fake_pulsar(gm, str(par), outfile=f, nsub=1, nchan=32,
                         nbin=256, tsub=600.0, dDM=1e-4 * i,
                         start_MJD=MJD(57000.0 + i), noise_stds=0.05,
                         quiet=True, rng=rng)
        files.append(f)
    return files


@pytest.mark.cuda
def test_gaussian_model_on_card_matches_cpu_float64(cuda, tmp_path):
    """make_gaussian_model(niter=1) on the card (float64 LM; float32
    check_convergence fits) against the CPU float64 run: every fitted
    parameter within 0.01 of its error."""
    from pulseportraiture_tpu_torch.portrait import DataPortrait
    f = _builder_archives(tmp_path, 1)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        dp = DataPortrait(f, quiet=True, device=dev)
        res[dev] = dp.make_gaussian_model(
            ngauss=2, niter=1, quiet=True,
            outfile=str(tmp_path / f"{dev}.gmodel"))
    e = np.asarray(res["cpu"].fit_errs)
    fitted = e > 0
    d = np.abs(res["cuda"].fitted_params - res["cpu"].fitted_params)
    assert fitted.sum() >= 10
    assert np.max(d[fitted] / e[fitted]) <= 1e-2


@pytest.mark.cuda
def test_builders_fit_through_the_kernels(cuda, tmp_path):
    """The float32 fits inside the builders reach the CUDA kernels, not
    the twins: check_convergence and align_archives each raise the
    launch counts of fused_setup, phase_moments and
    phase_moments_merged."""
    from pulseportraiture_tpu_torch.pipelines.align import align_archives
    from pulseportraiture_tpu_torch.portrait import DataPortrait
    files = _builder_archives(tmp_path, 2)
    counters = (sdft.fused_setup, mom.phase_moments,
                mom.phase_moments_merged)

    def launched(run):
        before = [c.launches for c in counters]
        run()
        torch.cuda.synchronize()
        return [c.launches - b for c, b in zip(counters, before)]

    dp = DataPortrait(files[0], quiet=True, device="cuda")
    dp.make_gaussian_model(ngauss=1, niter=0, quiet=True, writemodel=False)
    assert min(launched(lambda: dp.check_convergence(dp.nu0))) > 0
    out = str(tmp_path / "aligned.fits")
    assert min(launched(lambda: align_archives(
        datafiles=files, initial_guess=files[0], tscrunch=True,
        outfile=out, quiet=True, device="cuda"))) > 0


@pytest.mark.cuda
def test_align_on_card_matches_cpu_float64(cuda, tmp_path):
    """align_archives on the card (float32 fits through the kernels, then
    the float64 polish) against the CPU float64 run: each subint's phi
    and DM within 1e-6 of their errors, the averages (stored as float32)
    within 2**-23 of their largest value."""
    from pulseportraiture_tpu_torch.io.psrfits import read_psrfits
    from pulseportraiture_tpu_torch.pipelines.align import align_archives
    files = _builder_archives(tmp_path, 2)
    got = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"al-{dev}.fits")
        _, fits = align_archives(datafiles=files, initial_guess=files[0],
                                 tscrunch=True, outfile=out, quiet=True,
                                 device=dev, return_fits=True)
        got[dev] = (read_psrfits(out).data, fits)
    (a, fa), (b, fb) = got["cuda"], got["cpu"]
    for x, y in zip(fa, fb):
        assert abs(x["phi"] - y["phi"]) <= 1e-6 * y["phi_err"]
        assert abs(x["DM"] - y["DM"]) <= 1e-6 * y["DM_err"]
    assert np.max(np.abs(a - b)) <= 2.0 ** -23 * np.max(np.abs(b))


@pytest.mark.cuda
def test_sharded_fit_on_one_card_matches_the_unsharded_fit(cuda):
    """Meshes laid over the one card (parallel.mesh).  Channel slabs
    (1 x 2) with seed_phase=False: bitwise the unsharded card fit (the
    setup and phase-moments kernels compute each row on its own, and the
    per-channel template sums are taken on the lead).  A 2 x 2 mesh (two
    batch shards in threads): within 0.01 of the errors, with and without
    the seed, not bitwise: torch's CUDA reductions over the channels
    choose their order by the number of items.  Every shard launched the
    setup and phase-moments kernels.  (A launch on a second card is not
    shown by one card.)"""
    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full_batch, template_spectrum)
    from pulseportraiture_tpu_torch.parallel.mesh import (
        fit_portrait_full_sharded, make_mesh)

    rng = np.random.default_rng(8)
    B, nchan, nbin = 6, 96, 512
    model, data = _portrait(rng, B, nchan, nbin)
    mft = template_spectrum(model)
    t = dict(dtype=torch.float32, device=cuda)
    args = (torch.from_numpy(data).to(cuda), mft, torch.zeros((B, 5), **t),
            torch.full((B,), 0.003, **t),
            torch.as_tensor(np.linspace(1100.0, 1900.0, nchan), **t),
            torch.full((B, nchan), 0.1, **t))
    slabs = make_mesh(1, 2, devices=["cuda:0"] * 2)
    want = fit_portrait_full_batch(*args, seed_phase=False)
    got = fit_portrait_full_sharded(slabs, *args, seed_phase=False)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    mesh = make_mesh(2, 2, devices=["cuda:0"] * 4)
    for seed in (False, True):
        want = fit_portrait_full_batch(*args, seed_phase=seed)
        got = fit_portrait_full_sharded(mesh, *args, seed_phase=seed)
        z = ((got.params - want.params).abs() / want.param_errs)[:, :2]
        assert float(z.max()) < 1e-2, (seed, z)
    for m, n in ((slabs, 1), (mesh, 2)):
        for shard, counts in m.launches.items():
            assert counts["fused_setup"] == n and \
                counts["phase_moments"] > 0, (shard, counts)


# the trust-region subproblem (csrc/tr_solve.cu) against its twin
TR_KINDS = ("interior", "boundary", "indefinite", "hard", "masked")
TR_SCALES = (1e-3, 1.0, 1e6, 1e13)


def _tr_item(rng, n, kind, scale):
    """One subproblem (g (n,), H (n, n), radius, k) in float64 numpy.
    H = scale Q diag(lam) Q^T, |lam| log-uniform in [1e-3, 1] (condition
    <= 1e3), g = scale Q u; radii log-uniform in [1e-14, 1e3], or above
    the Newton step's length for "interior".  "hard": the lowest
    eigenvalue's eigenvector is the axis k, decoupled from the rest, and
    g[k] = 0 (gt[0] = 0, lam_min < 0), with radii past |p(floor)|, where
    the hard case takes the rest of the radius along that axis; k is the
    first or the last axis, which LAPACK's tridiagonal reduction keeps
    decoupled to the bit, so the twin's gt[0] is 0 too (elsewhere it is
    ~1e-16, and p(floor) carries gt[0] / eps of it along the axis).
    "masked": axis k an identity row and column with g[k] = 0, as the
    fits pin a parameter.  k is -1 for the other kinds."""
    lam = 10.0 ** rng.uniform(-3.0, 0.0, n)
    if kind == "indefinite":
        lam = lam * rng.choice([-1.0, 1.0], n)
        lam[0] = -abs(lam[0])
    k = -1
    if kind == "hard":
        k = int(rng.choice([0, n - 1]))
    elif kind == "masked":
        k = int(rng.integers(n))
    m = n - 1 if k >= 0 else n
    Q = np.linalg.qr(rng.normal(size=(m, m)))[0] if m else np.eye(0)
    sub = lam[:m]
    A = (Q * sub) @ Q.T
    u = rng.normal(size=m)
    idx = [i for i in range(n) if i != k]
    H = np.zeros((n, n))
    H[np.ix_(idx, idx)] = scale * A
    g = np.zeros(n)
    g[idx] = scale * (Q @ u)
    if kind == "hard":
        H[k, k] = -scale * 10.0 ** rng.uniform(-3.0, 0.0)
    elif kind == "masked":
        H[k, k] = 1.0
    if kind == "interior":
        radius = np.linalg.norm(np.linalg.solve(H, g)) * \
            10.0 ** rng.uniform(0.1, 3.0)
    elif kind == "hard":
        # |p(floor)|: the rest of the step at mu = -lam_min
        pf = np.linalg.norm(u / (sub - H[k, k] / scale))
        radius = max(pf, 1e-14) * 10.0 ** rng.uniform(0.1, 3.0)
    else:
        radius = 10.0 ** rng.uniform(-14.0, 3.0)
        if kind == "boundary":
            radius = min(radius, 0.5 * np.linalg.norm(np.linalg.solve(H, g)))
    return g, H, radius, k


def _tr_batch(rng, n, B, kinds=TR_KINDS):
    """B subproblems cycling over kinds and TR_SCALES: (g, H, radius, k,
    kind) arrays."""
    items = [_tr_item(rng, n, kinds[i % len(kinds)],
                      TR_SCALES[(i // len(kinds)) % len(TR_SCALES)])
             for i in range(B)]
    g, H, r, k = (np.array(a) for a in zip(*items))
    kind = np.array([kinds[i % len(kinds)] for i in range(B)])
    return g, H, r, k, kind


def _tr_gaps(p, ref, k, kind):
    """|p - ref| / |ref| per item (|p - ref| where ref is 0).  "masked":
    without the pinned axis k, as the Newton loop's step_mask projects it
    out (the twin's eigh leaves ~1e-16 of g in that direction, over an
    eigenvalue down to 1e-13).  "hard": up to the sign of p[k], which
    comes from the eigensolver's sign of v0 where gt[0] = 0."""
    p = np.array(p, dtype=np.float64)
    ref = np.array(ref, dtype=np.float64)
    for i in np.flatnonzero(kind == "masked"):
        p[i, k[i]] = ref[i, k[i]] = 0.0
    d = np.linalg.norm(p - ref, axis=-1)
    for i in np.flatnonzero(kind == "hard"):
        q = ref[i].copy()
        q[k[i]] = -q[k[i]]
        d[i] = min(d[i], np.linalg.norm(p[i] - q))
    nref = np.linalg.norm(ref, axis=-1)
    return np.where(nref > 0.0, d / np.where(nref > 0.0, nref, 1.0), d)


def _tr_tolerance(dtype, hard_case, kind):
    """The bound on _tr_gaps.  float64: 1e-9 (the twin's LAPACK eigh and
    the kernel's Jacobi round differently; at condition <= 1e3, and with
    a pinned eigenvalue down to 1e-13, the steps differed by <= 2e-11 in
    the CPU rehearsal of the kernel's source).  float32: 2.5e-7, p rounded
    to float32 on both sides, a few ulps.  With hard_case on an indefinite
    H: 2e-6, as the hard case is ill-conditioned there: a boundary step
    whose norm rounds below the radius (by delta r) gets the rest of it,
    sqrt(2 delta) r, along v0; delta up to 1e-12 of the secular
    iteration's rounding (rehearsal: <= 1.3e-7)."""
    if hard_case and kind == "indefinite":
        return 2e-6
    return 1e-9 if dtype == torch.float64 else 2.5e-7


@pytest.mark.cuda
@pytest.mark.parametrize("hard_case", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_tr_solve_kernel_matches_twin(cuda, n, dtype, hard_case):
    """csrc/tr_solve.cu against tr_solve_reference (on the CPU: LAPACK's
    eigh) on interior, boundary, indefinite, hard-case and pinned
    subproblems, curvatures 1e-3..1e13, radii 1e-14..1e3; B = 64 in one
    launch and B = 1 of each kind.  hit must agree exactly; p within
    _tr_tolerance of the twin's |p|."""
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    rng = np.random.default_rng(1000 * n + 10 * hard_case +
                                (dtype == torch.float64))
    calls = [_tr_batch(rng, n, 64)] + [_tr_batch(rng, n, 1, kinds=(kind,))
                                       for kind in TR_KINDS]
    for g, H, r, k, kind in calls:
        t = [torch.as_tensor(a, dtype=dtype) for a in (g, H, r)]
        n0 = trs.tr_solve.launches
        p, hit = trs.tr_solve(*[a.to(cuda) for a in t], hard_case=hard_case)
        torch.cuda.synchronize()
        assert trs.tr_solve.launches == n0 + 1
        assert p.dtype == dtype and p.shape == t[0].shape
        want, want_hit = trs.tr_solve_reference(*t, hard_case=hard_case)
        assert torch.equal(hit.cpu(), want_hit), (kind, hit, want_hit)
        gaps = _tr_gaps(p.cpu(), want, k, kind)
        tol = np.array([_tr_tolerance(dtype, hard_case, c) for c in kind])
        assert np.all(gaps <= tol), [(c, e) for c, e, b in
                                     zip(kind, gaps, tol) if e > b]


@pytest.mark.cuda
def test_tr_solve_kernel_reads_strided_views(cuda):
    """The kernel reads g, H and radius through their strides (no copy,
    one launch): views of wider buffers, a transposed H and one radius
    expanded over the items give the bits of the contiguous inputs."""
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    g, H, r, _, _ = _tr_batch(np.random.default_rng(7), 5, 64)
    t = [torch.as_tensor(a, dtype=torch.float32, device=cuda)
         for a in (g, H, r)]
    gw = torch.zeros((64, 10), dtype=torch.float32, device=cuda)
    gw[:, ::2] = t[0]
    Hw = t[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    rw = torch.stack([t[2], t[2]], dim=-1)[:, 1]
    assert not (gw[:, ::2].is_contiguous() or Hw.is_contiguous() or
                rw.is_contiguous())
    for hard in (False, True):
        want = trs.tr_solve(*t, hard_case=hard)
        n0 = trs.tr_solve.launches
        got = trs.tr_solve(gw[:, ::2], Hw, rw, hard_case=hard)
        assert trs.tr_solve.launches == n0 + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        one = torch.full((1,), 0.5, dtype=torch.float32, device=cuda)
        assert torch.equal(trs.tr_solve(*t[:2], one.expand(64),
                                        hard_case=hard)[0],
                           trs.tr_solve(*t[:2], one.repeat(64),
                                        hard_case=hard)[0])


@pytest.mark.cuda
def test_tr_solve_wrapper_refuses_what_it_does_not_take(cuda):
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    n0 = trs.tr_solve.launches
    g = torch.zeros((4, 9), device=cuda)
    with pytest.raises(ValueError, match="n=9"):
        trs.tr_solve(g, torch.zeros((4, 9, 9), device=cuda),
                     torch.ones(4, device=cuda))
    g = torch.zeros((4, 5), device=cuda)
    with pytest.raises(TypeError):
        trs.tr_solve(g, torch.zeros((4, 5, 5), device=cuda).double(),
                     torch.ones(4, device=cuda))
    with pytest.raises(TypeError):
        trs.tr_solve(g.half(), torch.zeros((4, 5, 5), device=cuda).half(),
                     torch.ones(4, device=cuda).half())
    with pytest.raises(ValueError):          # radius of another shape
        trs.tr_solve(g, torch.zeros((4, 5, 5), device=cuda),
                     torch.ones(3, device=cuda))
    with pytest.raises(ValueError):          # on another device
        trs.tr_solve(g, torch.zeros((4, 5, 5)), torch.ones(4, device=cuda))
    assert trs.tr_solve.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("fit_flags", [(1, 1, 0, 0, 0), (1, 1, 0, 1, 1)])
def test_newton_loop_solves_through_the_kernel(cuda, fit_flags):
    """A (phi, DM) fit and a fit_scat fit on the card, float32: two
    tr_solve launches a traced Newton iteration (pp:newton.iter), and
    the answers within 1e-2 sigma of the float64 CPU fit, as the other
    card fits are held."""
    from torch.profiler import ProfilerActivity, profile

    from pulseportraiture_tpu_torch.fitters.portrait import (
        fit_portrait_full_batch, template_spectrum)
    from pulseportraiture_tpu_torch.ops import tr_solve as trs
    rng = np.random.default_rng(11)
    B, nchan, nbin, P, noise, tau = 4, 128, 512, 0.003, 0.1, 8e-3
    scat = bool(fit_flags[3])
    model, _ = _portrait(rng, 1, nchan, nbin)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    nu_fit = freqs.mean()
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    mf = np.fft.rfft(model, axis=-1)
    if scat:
        mf = mf / (1.0 + k * (tau * (freqs / nu_fit) ** -4.0)[:, None])
    data = np.fft.irfft(mf * np.exp(-k * rng.uniform(-0.01, 0.01,
                                                       (B, 1, 1))),
                        n=nbin, axis=-1)
    data = (data + rng.normal(0, noise, data.shape)).astype(np.float32)
    init = np.zeros((B, 5))
    if scat:
        init[:, 3], init[:, 4] = np.log10(4e-3), -4.0
    mr, mi = template_spectrum(model)
    out = {}
    for dev, dt in ((cuda, torch.float32), (torch.device("cpu"),
                                            torch.float64)):
        def t(a):
            return torch.as_tensor(a, dtype=dt, device=dev)
        n0 = trs.tr_solve.launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out[dev.type] = fit_portrait_full_batch(
                torch.from_numpy(data).to(dev), (mr, mi), t(init),
                t(np.full(B, P)), t(freqs), t(np.full((B, nchan), noise)),
                nu_fits=t(np.full((B, 3), nu_fit)), fit_flags=fit_flags,
                dtype=dt)
        iters = sum(e.name == "pp:newton.iter" for e in prof.events())
        assert iters == int(out[dev.type].niter.max()) > 0
        assert trs.tr_solve.launches - n0 == (2 * iters if dev.type == "cuda"
                                              else 0)
    g, c = out["cuda"], out["cpu"]
    assert bool(g.return_code.lt(3).all())
    for j in np.flatnonzero(fit_flags):
        d = (g.params[:, j].double().cpu() - c.params[:, j]).abs()
        assert bool((d <= 1e-2 * c.param_errs[:, j]).all()), (j, d)


def _stats_rows(rng, nprof, nbin):
    """(raw (nprof, nbin) int16, scale (nprof,) float32): a pulse of random
    phase, width and height on a DC level with noise, quantized over the
    int16 range; row 0 flat (every window ties), row 1 a zero scale, row 2
    a negative scale, row 3 all zeros."""
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.uniform(0.0, 2.0, (nprof, 1)) * np.exp(
        -0.5 * ((ph - rng.uniform(0, 1, (nprof, 1))) /
                rng.uniform(0.01, 0.1, (nprof, 1))) ** 2) + \
        rng.normal(0.0, 0.1, (nprof, nbin)) + rng.uniform(-3, 3, (nprof, 1))
    lo, hi = x.min(-1, keepdims=True), x.max(-1, keepdims=True)
    scale = ((hi - lo) / 65534.0)[:, 0].astype(np.float32)
    raw = np.clip(np.round((x - 0.5 * (lo + hi)) / scale[:, None]),
                  -32767, 32767).astype(np.int16)
    raw[0] = 1234
    scale[1] = 0.0
    scale[2] = -scale[2]
    raw[3] = 0
    return raw, scale


@pytest.mark.cuda
@pytest.mark.parametrize("nbin,nprof", [
    (64, 300), (128, 70), (256, 33), (512, 70), (1024, 70), (2048, 4096),
    (4096, 70), (8192, 17),                      # every power-of-two plan
    (768, 33), (1280, 33), (1536, 130), (3328, 5), (3840, 33)])  # M > 1
def test_load_stats_kernel_matches_twin(cuda, nbin, nprof):
    from pulseportraiture_tpu_torch.ops import load_stats as ls
    raw, scale = _stats_rows(np.random.default_rng(nbin), nprof, nbin)
    r, s = torch.from_numpy(raw).to(cuda), torch.from_numpy(scale).to(cuda)
    n0 = ls.profile_stats.launches
    got = [t.cpu() for t in ls.profile_stats(r, s)]
    again = [t.cpu() for t in ls.profile_stats(r, s)]
    torch.cuda.synchronize()
    assert ls.profile_stats.launches == n0 + 2
    want = ls.profile_stats_reference(torch.from_numpy(raw),
                                      torch.from_numpy(scale))
    # the window from exact integers: baseline, sum and max to the bit;
    # every output the same bits on a second launch
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i]), \
            (i, (got[i] - want[i]).abs().max())
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    # the noise: two float32 FFTs (the kernel's of raw, times |scale|),
    # relative to the noise and to the row's largest sample
    top = (torch.from_numpy(raw).float().abs().amax(-1) *
           torch.from_numpy(scale).abs())
    err = (got[1] - want[1]).abs()
    assert torch.all(err <= 2e-6 * want[1] + 1e-6 * top), err.max()


@pytest.mark.cuda
def test_load_stats_on_the_card_match_the_twin_route(cuda):
    """archive_stats (the copy, the kernel, the S/N on the card, the copy
    back) against the same on the CPU (the twin)."""
    from pulseportraiture_tpu_torch.ops import load_stats as ls
    raw, scale = _stats_rows(np.random.default_rng(7), 8 * 512, 2048)
    raw, scale = raw.reshape(8, 512, 2048), scale.reshape(8, 512)
    got = ls.archive_stats(raw, scale, cuda)
    want = ls.archive_stats(raw, scale, torch.device("cpu"))
    assert got[0].shape == (8, 512) and got[1].dtype == np.float64
    assert np.array_equal(got[0], want[0])
    ok = want[1] > 0
    assert np.allclose(got[1][ok], want[1][ok], rtol=2e-6, atol=0)
    # (the flat and all-zero rows' S/N is 0/0, NaN, on both routes)
    assert np.allclose(got[2], want[2], rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
def test_load_stats_wrapper_refuses_what_it_does_not_take(cuda):
    from pulseportraiture_tpu_torch.ops import load_stats as ls
    n0 = ls.profile_stats.launches
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="nbin=1000"):
        ls.profile_stats(torch.zeros((4, 1000), dtype=torch.int16,
                                     device=cuda), s)
    with pytest.raises(TypeError):
        ls.profile_stats(torch.zeros((4, 256), device=cuda), s)
    with pytest.raises(ValueError):              # a scale of another shape
        ls.profile_stats(torch.zeros((4, 256), dtype=torch.int16,
                                     device=cuda), s[:3])
    buf = torch.zeros(4 * 256 + 2, dtype=torch.int16, device=cuda)
    off = buf[2:].view(4, 256)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        ls.profile_stats(off, s)
    assert ls.profile_stats.launches == n0
