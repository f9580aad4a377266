"""The FFT setup route of ops.setup_dft on the CPU: the plain torch version
of csrc/setup_fft.cu's own algorithm (fused_setup_fft_reference: packed
half-length Stockham FFT in passes of radix 16/16/2-16 and, for nbin/2 =
m 2^a with m odd, a closing pass of radix m; untangling step, the
kernel's twiddle table) against the rfft twin and against the JAX
package's setup functions (at 256 bins, at the mixed-radix widths 768
and 1280, and at 64 and 8192 bins, where the JAX package sets up outside
its TPU kernels), the twiddle table itself, the kernel's block layout
and the route rule.

Tolerances:
  * float64, against the rfft twin: <= 1e-12 of the largest magnitude of
    each output (two exact algorithms, rounding only);
  * float32, against the JAX package (outputs mapped back from the TPU's
    Cooley-Tukey order by ct_perm_np): test_torch_setup.py's, 1e-5 for the
    f32-class routes, 1e-4 for the split-bf16 pallas_direct_setup;
  * float64, against the JAX package's stats.make_setup (rfft in XLA):
    1e-12, as against the rfft twin;
  * float32 accuracy class: the error against the float64 twin is at most
    twice the float32 rfft twin's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu.io.native import quantize_i2  # noqa: E402
from pulseportraiture_tpu_torch.ops import setup_dft as sdft  # noqa: E402

from test_torch_setup import B, NCHAN, _case, _jax  # noqa: E402
from torch_parity_utils import template, unpermute  # noqa: E402

torch.set_num_threads(2)


def _inputs(nbin, nchan, capped, i16, K, f0_fact, seed=3):
    """(x, mr, mi, w, scale) as float64/int16 torch tensors."""
    rng = np.random.default_rng(seed + nbin + nchan)
    model = template(nchan, nbin)
    data = np.stack([np.roll(model, int(s), axis=-1) for s in
                     rng.integers(-9, 9, 2)]) + \
        rng.normal(0.0, 0.1, (2, nchan, nbin))
    data = data.astype(np.float32)
    mf = np.fft.rfft(model, axis=-1)
    mr, mi = mf.real.astype(np.float32), mf.imag.astype(np.float32)
    nh = nbin // 2 + 1
    if capped and sdft.cap_supported(nbin):
        mr, mi, mh = sdft.band_cap_model_ft(mr, mi, nbin, f0_fact=f0_fact)
        nh = sdft.cap_nharm(nbin, mh)
    elif capped:
        nh = nbin // 8
    x, scale = data, None
    if i16:
        x, scale, _ = quantize_i2(data)
        scale = torch.from_numpy(scale.astype(np.float64))
    w = None
    if K:
        w = rng.uniform(0.5, 2.0, (2, nchan, K))
        w[:, : nchan // 2, K - 1] = 0.0
        w = torch.from_numpy(w)
    return (torch.from_numpy(x), torch.from_numpy(mr[:, :nh]).double(),
            torch.from_numpy(mi[:, :nh]).double(), w, scale)


@pytest.mark.parametrize("nbin,nchan,capped,i16,K,f0_fact", [
    (128, 5, False, False, 2, False),
    (128, 33, True, True, 0, False),
    (128, 70, False, False, 2, True),
    (256, 5, True, False, 0, True),
    (256, 33, False, True, 2, False),
    (256, 70, True, False, 2, False),
    (512, 5, False, True, 0, False),
    (512, 33, True, False, 2, True),
    (512, 70, False, False, 0, False),
    (2048, 5, True, True, 2, False),
    (2048, 33, False, False, 2, True),
    (2048, 70, True, False, 0, False),
    (2048, 70, False, True, 2, False),
    (4096, 5, False, False, 2, False),
    (4096, 33, True, True, 2, False),
    (4096, 70, True, False, 0, True),
    # the mixed-radix plans: odd factors 3, 5, 3 (over 256), 9 and 15
    (768, 5, True, False, 2, False),
    (768, 33, False, True, 0, False),
    (768, 70, True, True, 2, False),
    (1280, 5, False, False, 0, True),
    (1280, 33, True, True, 2, False),
    (1280, 70, False, False, 2, False),
    (1536, 5, True, True, 0, False),
    (1536, 33, False, False, 2, True),
    (1536, 70, True, False, 2, False),
    (2304, 5, False, True, 2, False),
    (2304, 33, True, False, 0, True),
    (2304, 70, False, False, 2, False),
    (3840, 5, True, False, 2, False),
    (3840, 33, False, True, 2, False),
    (3840, 70, True, True, 0, False),
    # the radix-16 + radix-2 plan (64) and three radix-16 passes (8192)
    (64, 5, False, False, 2, False),
    (64, 33, True, True, 0, False),
    (64, 70, False, False, 2, True),
    (64, 70, False, True, 2, False),
    (8192, 5, False, True, 2, False),
    (8192, 9, True, False, 0, True),
    (8192, 33, False, False, 2, False),
    (8192, 33, False, True, 0, False),
])
def test_fft_reference_matches_rfft_twin_float64(nbin, nchan, capped, i16, K,
                                                 f0_fact):
    x, mr, mi, w, scale = _inputs(nbin, nchan, capped, i16, K, f0_fact)
    got = sdft.fused_setup_fft_reference(x, mr, mi, f0_fact, w, scale)
    want = sdft.fused_setup_reference(x, mr, mi, f0_fact, w, scale)
    assert len(got) == len(want) == (5 if K else 3)
    gmax = max(float(want[0].abs().max()), float(want[1].abs().max()))
    scales = [gmax, gmax, float(want[2].abs().max())]
    if K:
        scales += [max(float(want[3].abs().max()),
                       float(want[4].abs().max()))] * 2
    for g, r, s in zip(got, want, scales):
        assert g.shape == r.shape and g.dtype == torch.float64
        assert float((g - r).abs().max()) <= 1e-12 * s
    if not f0_fact:                      # DC zeroed exactly, not to rounding
        assert not got[0][..., 0].any() and not got[1][..., 0].any()


@pytest.mark.parametrize("nz", [32, 64, 128, 256, 512, 1024, 2048, 4096,
                                192, 320, 448, 576, 704, 832, 960, 1920])
def test_stockham_stages_match_fft(nz):
    """Two and three passes, every closing radix (2 .. 16), every odd
    closing pass (3 .. 15): the pass walk is torch.fft.fft."""
    rng = np.random.default_rng(nz)
    z = torch.from_numpy(rng.normal(size=(3, nz)) +
                         1j * rng.normal(size=(3, nz)))
    tb = torch.from_numpy(sdft._fft_tables_np(2 * nz))
    got = sdft._stockham_fft(z, tb)
    want = torch.fft.fft(z, dim=-1)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("route,capped,i16,K,f0_fact", [
    ("direct", True, False, 2, False),
    ("direct", True, True, 1, False),
    ("ct", True, False, 2, False),
    ("ct", False, True, 2, False),
    ("ct", False, False, 1, True),
    ("pallas_direct", True, False, 2, False),
])
def test_fft_reference_matches_jax_setups(route, capped, i16, K, f0_fact):
    _matches_jax(route, _case(capped, i16, K, f0_fact))


def _matches_jax(route, c):
    """fused_setup_fft_reference against the JAX package's setup `route`
    on the case c, outputs mapped back by ct_perm_np."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))
    got = sdft.fused_setup_fft_reference(
        t(c["x"]), t(c["mr"][:, :c["nh"]]), t(c["mi"][:, :c["nh"]]),
        f0_fact=c["f0_fact"], w=t(c["w"]), scale=t(c["scale"]))
    want = _jax(route, c)
    tol = 1e-4 if route == "pallas_direct" else 1e-5
    Gr, Gi, sd, gsr, gsi = (np.asarray(a) for a in want)
    Gr, Gi = unpermute(Gr, c["kvec"]), unpermute(Gi, c["kvec"])
    gsr, gsi = unpermute(gsr, c["kvec"]), unpermute(gsi, c["kvec"])
    assert got[0].shape == (B, NCHAN, c["nh"]) and got[0].dtype == \
        torch.float32 and got[3].shape == (B, c["w"].shape[-1], c["nh"])
    gmax = max(np.abs(Gr).max(), np.abs(Gi).max())
    smax = max(np.abs(gsr).max(), np.abs(gsi).max())
    for g, r, scale in ((got[0], Gr, gmax), (got[1], Gi, gmax),
                        (got[2], sd, np.abs(sd).max()), (got[3], gsr, smax),
                        (got[4], gsi, smax)):
        assert np.abs(g.numpy() - r).max() <= tol * scale


@pytest.mark.parametrize("nbin,route,capped,i16,K,f0_fact", [
    (768, "direct", True, False, 2, False),
    (768, "ct", True, True, 2, False),
    (768, "ct", False, False, 1, True),
    (1280, "direct", True, True, 1, False),
    (1280, "ct", True, False, 2, False),
    (1280, "ct", False, True, 2, False),
])
def test_fft_reference_matches_jax_setups_mixed_radix(nbin, route, capped,
                                                      i16, K, f0_fact):
    """At widths that are not a power of two (6 and 10 x 128: the radix-3
    and radix-5 plans), against the JAX package's f32-class setups:
    direct_capped_setup and ct_setup (interpret mode), 1e-5."""
    _matches_jax(route, _case(capped, i16, K, f0_fact, nbin=nbin))


@pytest.mark.parametrize("nbin,nchan,i16,f0_fact", [
    (64, 5, False, False), (64, 33, True, False), (64, 20, False, True),
    (8192, 5, False, False), (8192, 9, True, False), (8192, 4, False, True),
])
def test_fft_reference_matches_jax_make_setup(nbin, nchan, i16, f0_fact):
    """At 64 and 8192 bins the JAX package sets up outside its TPU kernels
    (_use_ct_setup is false there: fit_portrait_full_batch runs
    stats.make_setup, rfft and the cross-spectrum in XLA); in float64 both
    sides: Gr, Gi and the per-channel data power within 1e-12 of their
    largest magnitude (int16 rows dequantized first on the JAX side, as
    its non-CT fallback does)."""
    from pulseportraiture_tpu.fitters import stats as jstats

    x, mr, mi, _, scale = _inputs(nbin, nchan, False, i16, 0, f0_fact)
    got = sdft.fused_setup_fft_reference(x, mr, mi, f0_fact, scale=scale)
    xd = x.double() if scale is None else x.double() * scale[..., None]
    errs = np.full(nchan, (nbin / 2.0) ** -0.5)   # Fourier noise 1: w = 1
    freqs = np.linspace(1100.0, 1900.0, nchan)
    for b in range(x.shape[0]):
        want = jstats.make_setup(xd[b].numpy(), None, errs, 1.0, freqs,
                                 1500.0, 1500.0, 1500.0, f0_fact=f0_fact,
                                 model_ft_ri=(mr.numpy(), mi.numpy()))
        gr, gi, sd = (np.asarray(a) for a in (want.Gr, want.Gi,
                                              want.sd_chan))
        gmax = max(np.abs(gr).max(), np.abs(gi).max())
        assert got[0][b].shape == gr.shape == (nchan, nbin // 2 + 1)
        assert np.abs(got[0][b].numpy() - gr).max() <= 1e-12 * gmax
        assert np.abs(got[1][b].numpy() - gi).max() <= 1e-12 * gmax
        assert np.abs(got[2][b].numpy() - sd).max() <= \
            1e-12 * np.abs(sd).max()


@pytest.mark.parametrize("nbin,nchan,capped,i16,K,f0_fact", [
    (255, 5, False, False, 2, False),
    (255, 9, True, False, 0, True),
    (1000, 7, True, False, 2, False),
    (1000, 5, False, True, 1, False),
    (4352, 4, False, True, 2, False),
    (4352, 6, True, False, 0, True),
    (16384, 3, False, False, 2, False),
    (16384, 4, True, True, 2, False),
    (16384, 3, False, False, 0, True),
])
def test_epilogue_reference_matches_jax_make_setup(nbin, nchan, capped, i16,
                                                   K, f0_fact):
    """The rfft route's widths (odd, 8 x 125, 256 x 17, above 8192), where
    the JAX package sets up with stats.make_setup (rfft and the
    cross-spectrum in XLA): setup_epilogue_reference on torch.fft.rfft of
    the rows, in float64 both sides, against it within 1e-12 of the
    largest magnitude of Gr/Gi (the prefix nbin/8 where capped), of the
    per-channel data power (every harmonic: no Nyquist term at odd nbin)
    and of the seed sums formed from the JAX package's cross-spectrum.
    int16 rows: scale after the transform here, the rows dequantized
    first on the JAX side.  Tiles of 2 channels of one class c mod 4, as
    the kernel's: the seed sums added tile by tile."""
    from pulseportraiture_tpu.fitters import stats as jstats

    x, mr, mi, w, scale = _inputs(nbin, nchan, capped, i16, K, f0_fact)
    nh = mr.shape[-1]
    X = torch.fft.rfft(x.double(), dim=-1)
    got = sdft.setup_epilogue_reference(X, mr, mi, f0_fact, w, scale,
                                        rows=2)
    assert len(got) == (5 if K else 3)
    xd = x.double() if scale is None else x.double() * scale[..., None]
    errs = np.full(nchan, (nbin / 2.0) ** -0.5)   # Fourier noise 1: w = 1
    freqs = np.linspace(1100.0, 1900.0, nchan)
    mf = np.fft.rfft(template(nchan, nbin), axis=-1)
    mfull = (mf.real.astype(np.float32).astype(np.float64),
             mf.imag.astype(np.float32).astype(np.float64))
    mfull[0][:, :nh], mfull[1][:, :nh] = mr.numpy(), mi.numpy()
    for b in range(x.shape[0]):
        want = jstats.make_setup(xd[b].numpy(), None, errs, 1.0, freqs,
                                 1500.0, 1500.0, 1500.0, f0_fact=f0_fact,
                                 model_ft_ri=mfull)
        gr, gi, sd = (np.asarray(a) for a in (want.Gr, want.Gi,
                                              want.sd_chan))
        assert gr.shape == (nchan, nbin // 2 + 1)
        gr, gi = gr[:, :nh], gi[:, :nh]
        gmax = max(np.abs(gr).max(), np.abs(gi).max())
        assert got[0][b].shape == gr.shape
        assert np.abs(got[0][b].numpy() - gr).max() <= 1e-12 * gmax
        assert np.abs(got[1][b].numpy() - gi).max() <= 1e-12 * gmax
        assert np.abs(got[2][b].numpy() - sd).max() <= \
            1e-12 * np.abs(sd).max()
        if K:
            wb = w[b].numpy()
            gsr, gsi = wb.T @ gr, wb.T @ gi
            smax = max(np.abs(gsr).max(), np.abs(gsi).max())
            assert np.abs(got[3][b].numpy() - gsr).max() <= 1e-12 * smax
            assert np.abs(got[4][b].numpy() - gsi).max() <= 1e-12 * smax


@pytest.mark.parametrize("nbin,i16", [(512, False), (2048, False),
                                      (2048, True), (1280, False),
                                      (1280, True), (64, False), (64, True),
                                      (8192, True)])
def test_fft_reference_is_float32_class(nbin, i16):
    """In float32 the factored transform is no worse than the float32
    rfft twin (x2): both are eps log2(nbin) algorithms."""
    x, mr, mi, _, scale = _inputs(nbin, 16, False, i16, 0, False)
    ref = sdft.fused_setup_reference(x, mr, mi, scale=scale)
    sc32 = None if scale is None else scale.float()
    errs = {}
    for name, fn in (("fft", sdft.fused_setup_fft_reference),
                     ("rfft", sdft.fused_setup_reference)):
        got = fn(x, mr.float(), mi.float(), scale=sc32)
        assert got[0].dtype == torch.float32
        errs[name] = max(float((g.double() - r).abs().max())
                         for g, r in zip(got[:2], ref[:2]))
    assert 0.0 < errs["fft"] <= 2.0 * errs["rfft"]


@pytest.mark.parametrize("nbin", [128, 2048, 4096, 1536, 3840, 64, 8192])
def test_twiddle_table(nbin):
    tw = sdft._twiddles_np(nbin)
    assert tw.dtype == np.complex128 and tw.shape == (nbin,)
    q = nbin // 4
    assert tw[0] == 1.0 and tw[q] == -1.0j and tw[2 * q] == -1.0 and \
        tw[3 * q] == 1.0j
    want = np.exp(-2j * np.pi * np.arange(nbin) / nbin)
    for got, ref in ((tw.real, want.real), (tw.imag, want.imag)):
        g32, r32 = got.astype(np.float32), ref.astype(np.float32)
        # (np.exp leaves ~6e-17 where the table holds an exact 0)
        assert np.all(np.abs(g32 - r32) <= np.spacing(np.maximum(
            np.abs(r32), np.float32(2.0 ** -24))))
    # the kernel's table: runs r = 1 .. R-1 of each twiddled pass (R, p),
    # then W^k for k <= nbin/4, every entry one of tw; a mixed-radix plan
    # (nbin/2 = m 2^a, m odd) closes with the pass (m, 2^a)
    tb = sdft._fft_tables_np(nbin)
    nz = nbin // 2
    passes = sdft._fft_passes(nz)
    m = nz // (nz & -nz)
    assert passes[0] == (16, 1) and passes[1][1] == 16
    assert int(np.prod([R for R, _ in passes])) == nz
    pow2 = passes[:-1] if m > 1 else passes
    assert all(R in (2, 4, 8, 16) for R, _ in pow2) and len(pow2) <= 3
    if m > 1:
        assert passes[-1] == (m, nz // m)
    off = 0
    for R, p in passes[1:]:
        k = np.arange(p)
        for r in range(1, R):
            assert np.array_equal(tb[off:off + p],
                                  tw[(r * k * (nbin // (R * p))) % nbin])
            off += p
    assert len(tb) == off + nz // 2 + 1
    assert np.array_equal(tb[off:], tw[:nz // 2 + 1])
    assert tb[-1] == -1.0j                          # W^(nbin/4), exact


@pytest.mark.parametrize("nbin,want", [
    (128, "fft"), (256, "fft"), (512, "fft"), (1024, "fft"), (2048, "fft"),
    (4096, "fft"), (64, "fft"), (8192, "fft"), (255, "rfft"),
    (768, "fft"), (1280, "fft"), (0, "rfft"), (1536, "fft"),
    (3840, "fft"), (1000, "rfft"), (384, "rfft"), (4352, "rfft"),
    (4608, "rfft"), (16384, "rfft"),
])
def test_setup_route(nbin, want):
    assert sdft.setup_route(nbin) == want


def test_fft_route_takes_every_width_the_band_cap_takes():
    """The TPU setup kernels' domain (the band cap's nbin = NQ*128, NQ
    even in 2..32: 256 q, q = 1..16) is the FFT route's, with the powers
    of two 64, 128 and 8192 beside it, and each of its widths has a plan
    (odd factor <= 15 over a power of two >= 128, or a power of two)."""
    widths = [n for n in range(1, 16385) if sdft.cap_supported(n)]
    assert widths == [256 * q for q in range(1, 17)]
    fft = [n for n in range(1, 16385) if sdft.setup_route(n) == "fft"]
    assert set(fft) == {64, 128, 8192} | set(widths)
    for nbin in fft:
        nz = nbin // 2
        m = nz // (nz & -nz)
        assert m <= 15 and (m == 1 or nz // m >= 128)
        assert sdft.FFT_MIN_NBIN <= nbin <= sdft.FFT_MAX_NBIN


def test_fft_blocks_per_sm():
    """Two blocks an SM wherever their shared memory fits (float32 rows);
    one at 3840 (15 x 128), 4096 and 8192: what the kernel's launch
    bounds say, and the tile rule fills the card by it."""
    got = {n: sdft._fft_layout(n)[3] for n in [64, 128, 8192] +
           [256 * q for q in range(1, 17)]}
    assert {n for n, b in got.items() if b == 1} == {3840, 4096, 8192}
    assert set(got.values()) == {1, 2}
    assert sdft._fft_rows(1, 4096, 132, 1) == 32
    assert sdft._fft_rows(1, 4096, 132, 2) == 16


@pytest.mark.parametrize("nbin,want", [
    (64, (256, 2, 128, 2)), (128, (256, 4, 64, 2)), (256, (256, 8, 32, 2)),
    (512, (256, 16, 16, 2)), (1024, (256, 32, 8, 2)),
    (768, (256, 32, 8, 2)), (4096, (256, 128, 2, 1)),
    (8192, (512, 256, 2, 1)),
])
def test_fft_layout(nbin, want):
    """csrc/setup_fft.cu's block at nbin: (threads a block, threads a
    worker, workers a block, blocks an SM).  A worker is nbin/32 threads:
    several to a warp below 1024 bins (a power of two), rounded up to a
    warp at 768 (24 threads), two of 256 in a 512-thread block at 8192."""
    assert sdft._fft_layout(nbin) == want


@pytest.mark.parametrize("B,nchan,wpb,want", [
    (64, 4096, 128, 1024), (4, 4096, 128, 64), (1, 4096, 128, 16),
    (64, 4096, 16, 128), (4, 4096, 2, 64),
])
def test_fft_rows_scale_with_the_group(B, nchan, wpb, want):
    """132 SMs, two blocks each: tiles up to 8 groups of wpb rows (at
    least 64 rows), halved while the card would be less than nine tenths
    full."""
    assert sdft._fft_rows(B, nchan, 132, 2, wpb) == want


@pytest.mark.parametrize("B,nchan,want", [
    (64, 4096, 64), (4, 4096, 64), (1, 4096, 16), (1, 512, 8), (3, 70, 8),
])
def test_fft_rows_per_block_fill_the_card(B, nchan, want):
    """132 SMs: the largest tile of 8..64 channels with >= 238 blocks."""
    rows = sdft._fft_rows(B, nchan, 132)
    assert rows == want
    assert rows == 8 or B * -(-nchan // rows) >= 1.8 * 132
    assert rows == 64 or B * -(-nchan // (2 * rows)) < 1.8 * 132


@pytest.mark.parametrize("nhf,nh,want", [
    (2, 2, (32, 8, 1, 1, 1, 1)), (128, 128, (32, 8, 1, 32, 32, 1)),
    (129, 128, (64, 4, 1, 33, 33, 1)), (501, 501, (128, 2, 1, 126, 126, 1)),
    (501, 125, (128, 2, 1, 126, 126, 1)), (502, 502, (128, 2, 1, 126, 126, 1)),
    (2177, 2177, (288, 1, 2, 273, 545, 1)),
    (2305, 2305, (320, 1, 2, 289, 577, 1)),
    (3841, 3841, (512, 1, 2, 481, 961, 1)),
    (8193, 8193, (352, 1, 3, 342, 1025, 2)),
    (16385, 16385, (480, 1, 3, 456, 1366, 3)),
])
def test_epilogue_shape(nhf, nh, want):
    """csrc/setup_epilogue.cu's row geometry: every group of 4 harmonics
    a row can need (its head offset r nh mod 4 puts the first group up
    to 3 harmonics before 0) falls in a slice; slices and a slice's steps
    as even as can be (no nearly empty slice or step, the last step of a
    slice keeps all but `steps` lanes busy); at most 512 threads a row, a
    warp's multiple; at least 256 threads a block (rows at once); the
    seed slots under 100 KB of shared memory at K = 2."""
    got = sdft._epilogue_shape(nhf, nh, 4096)
    assert got == want
    tpr, groups, steps, lanes, slice_, nslice = got
    ng = (nhf + max(r * nh % 4 for r in range(4)) + 3) // 4
    assert slice_ * nslice >= ng > (slice_ - 1) * nslice
    assert lanes * steps >= slice_ > (lanes - 1) * steps
    assert slice_ - lanes * (steps - 1) >= lanes - steps
    assert lanes <= tpr < lanes + 32 and tpr % 32 == 0
    assert 256 <= tpr * groups <= 512
    assert groups * steps * 2 * 2 * lanes * 16 <= 100 * 1024
    # one row: its head offset is 0
    one = sdft._epilogue_shape(nhf, nh, 1)
    assert one[4] * one[5] >= (nhf + 3) // 4


@pytest.mark.parametrize("nchan,rows", [(1, 8), (3, 2), (7, 2), (300, 8),
                                        (4096, 128), (4097, 32)])
def test_epilogue_tiles(nchan, rows):
    """The kernel's tiles cover every channel once; a tile holds at most
    `rows` channels of one class c mod 4, four channels apart (one
    alignment); _epilogue_ntile counts them."""
    tiles = sdft._epilogue_tile_channels(nchan, rows)
    assert len(tiles) == sdft._epilogue_ntile(nchan, rows)
    assert sorted(torch.cat(tiles).tolist()) == list(range(nchan))
    for t in tiles:
        assert 1 <= len(t) <= rows
        assert bool(torch.all(torch.diff(t) == 4))
    classes = [int(t[0]) % 4 for t in tiles]
    assert classes == sorted(classes)


@pytest.mark.parametrize("B,nchan,nhf,per_sm,want", [
    (4, 4096, 8193, 2, 128), (4, 4096, 2305, 3, 46), (4, 4096, 2305, 2, 73),
    (4, 4096, 128, 4, 35), (1, 512, 501, 4, 8), (64, 4096, 2305, 3, 128),
    (3, 70, 501, 4, 8), (4, 4096, 3841, 2, 73),
])
def test_epilogue_rows_fill_the_card(B, nchan, nhf, per_sm, want):
    """132 SMs holding per_sm blocks each: the largest tile of 8..128
    channels whose blocks (items x tiles x slices) still fill nine
    tenths of the slots."""
    geo = sdft._epilogue_geometry(B, nchan, nhf, nhf, 2, 132,
                                  lambda t, m: per_sm)
    assert geo.rows == want
    slots = 0.9 * 132 * per_sm

    def blocks(r):
        return B * sdft._epilogue_ntile(nchan, r) * geo.nslice

    assert blocks(geo.rows) == B * geo.ntile * geo.nslice
    assert geo.rows == 8 or blocks(geo.rows) >= slots
    assert geo.rows == 128 or blocks(geo.rows + 1) < slots
    assert geo.threads == geo.tpr * geo.groups
    assert geo.smem == geo.groups * geo.steps * 2 * 2 * geo.lanes * 16


def test_cpu_tensors_take_the_twin_and_count_nothing():
    x, mr, mi, w, _ = _inputs(256, 5, False, False, 2, False)
    before = (sdft.fused_setup.launches, dict(sdft.fused_setup.routes))
    got = sdft.fused_setup(x, mr, mi, w=w)
    want = sdft.fused_setup_reference(x, mr, mi, w=w)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert (sdft.fused_setup.launches, sdft.fused_setup.routes) == before
    assert set(sdft.fused_setup.routes) == {"fft", "rfft"}
    with pytest.raises(ValueError):      # the FFT version states its range
        sdft.fused_setup_fft_reference(x[..., :255], mr, mi)
