"""Port parity: ops.setup_dft (the fused setup's plain twin) against the
JAX package's setup functions, outputs mapped back from the TPU's
Cooley-Tukey order by ct_perm_np.

float32, both sides from the same f32 inputs:
  * direct_capped_setup and ct_setup (interpret mode) at precision
    "highest" are f32-class DFTs: <= 1e-5 of max|G| (and of max sd, max
    |gs|);
  * pallas_direct_setup (interpret mode) is a 3-pass split-bf16 DFT, only
    the HIGH class: <= 1e-4.
float64: the twin against a numpy rfft transcription at 1e-12.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.io.native import quantize_i2  # noqa: E402
from pulseportraiture_tpu.ops import ct_dft as jct  # noqa: E402
from pulseportraiture_tpu_torch.ops import setup_dft as sdft  # noqa: E402

from torch_parity_utils import template, unpermute  # noqa: E402

torch.set_num_threads(2)

NBIN, NCHAN, B = 256, 20, 2


def _case(capped, i16, K, f0_fact, seed=11, nbin=NBIN):
    rng = np.random.default_rng(seed)
    model = template(NCHAN, nbin)
    data = np.stack([np.roll(model, int(s), axis=-1) for s in
                     rng.integers(-9, 9, B)]) + \
        rng.normal(0.0, 0.1, (B, NCHAN, nbin))
    data = data.astype(np.float32)
    mf = np.fft.rfft(model, axis=-1)
    mr, mi, mh = jct.band_cap_model_ft(mf.real, mf.imag, nbin,
                                       f0_fact=f0_fact)
    if not capped:
        mh = None
        mr, mi = mf.real.astype(np.float32), mf.imag.astype(np.float32)
        if not f0_fact:
            mr[:, 0] = mi[:, 0] = 0.0
    kvec = jct.ct_perm_np(nbin, mh)
    nh = len(kvec)
    x, scale = data, None
    if i16:
        x, scale, _ = quantize_i2(data)
        scale = scale.astype(np.float32)
    w = rng.uniform(0.5, 2.0, (B, NCHAN, K)).astype(np.float32)
    if K == 2:
        w[:, : NCHAN // 2, 1] = 0.0
    return dict(x=x, scale=scale, w=w, mr=mr, mi=mi, mh=mh, kvec=kvec,
                nh=nh, f0_fact=f0_fact, nbin=nbin)


def _port(c, dtype=torch.float32):
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))
    return sdft.fused_setup(
        t(c["x"]), t(c["mr"][:, :c["nh"]]).to(dtype),
        t(c["mi"][:, :c["nh"]]).to(dtype), f0_fact=c["f0_fact"],
        w=t(c["w"]), scale=t(c["scale"]))


def _jax(route, c):
    mrp, mip = jct.permute_spectrum(c["mr"], c["mi"], c["nbin"],
                                    mharm=c["mh"])
    kw = dict(f0_fact=c["f0_fact"], w=jnp.asarray(c["w"]),
              scale=None if c["scale"] is None else jnp.asarray(c["scale"]),
              mharm=c["mh"])
    x = jnp.asarray(c["x"])
    if route == "direct":
        return jct.direct_capped_setup(x, mrp, mip, dft_precision="highest",
                                       **kw)
    if route == "ct":
        return jct.ct_setup(x, mrp, mip, dft_precision="highest",
                            interpret=True, **kw)
    return jct.pallas_direct_setup(x, mrp, mip, npass=3, interpret=True,
                                   **kw)


@pytest.mark.parametrize("route,capped,i16,K,f0_fact", [
    ("direct", True, False, 2, False),
    ("direct", True, True, 1, False),
    ("direct", True, False, 1, True),
    ("ct", True, False, 2, False),
    ("ct", False, True, 2, False),
    ("ct", False, False, 1, True),
    ("pallas_direct", True, False, 2, False),
    ("pallas_direct", True, True, 1, False),
])
def test_setup_twin_matches_jax_setups(route, capped, i16, K, f0_fact):
    c = _case(capped, i16, K, f0_fact)
    got = _port(c)
    want = _jax(route, c)
    tol = 1e-4 if route == "pallas_direct" else 1e-5
    Gr, Gi, sd, gsr, gsi = (np.asarray(a) for a in want)
    Gr, Gi = unpermute(Gr, c["kvec"]), unpermute(Gi, c["kvec"])
    gsr, gsi = unpermute(gsr, c["kvec"]), unpermute(gsi, c["kvec"])
    assert got[0].shape == (B, NCHAN, c["nh"]) and got[3].shape == \
        (B, K, c["nh"])
    gmax = max(np.abs(Gr).max(), np.abs(Gi).max())
    smax = max(np.abs(gsr).max(), np.abs(gsi).max())
    for g, w, scale in ((got[0], Gr, gmax), (got[1], Gi, gmax),
                        (got[2], sd, np.abs(sd).max()), (got[3], gsr, smax),
                        (got[4], gsi, smax)):
        assert np.abs(g.numpy() - w).max() <= tol * scale


@pytest.mark.parametrize("capped,i16,f0_fact", [(True, True, False),
                                                (False, False, True)])
def test_setup_twin_float64_matches_numpy(capped, i16, f0_fact):
    c = _case(capped, i16, 2, f0_fact, seed=12)
    Gr, Gi, sd, gsr, gsi = (a.numpy() for a in _port(c, torch.float64))
    x = np.asarray(c["x"], np.float64)
    X = np.fft.rfft(x, axis=-1)
    if c["scale"] is not None:
        X = X * np.asarray(c["scale"], np.float64)[..., None]
    pw = np.abs(X) ** 2
    sd_want = pw[..., 1:].sum(-1) + (pw[..., 0] if f0_fact else 0.0)
    M = np.asarray(c["mr"], np.float64) + 1j * np.asarray(c["mi"],
                                                         np.float64)
    G = X[..., :c["nh"]] * np.conj(M[:, :c["nh"]])
    if not f0_fact:
        G[..., 0] = 0.0
    gs = np.einsum("bck,bch->bkh", np.asarray(c["w"], np.float64), G)
    for g, w in ((Gr, G.real), (Gi, G.imag), (sd, sd_want),
                 (gsr, gs.real), (gsi, gs.imag)):
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()


def test_band_cap_helpers_match_jax():
    model = template(NCHAN, 512)
    mf = np.fft.rfft(model, axis=-1)
    got = sdft.band_cap_model_ft(mf.real, mf.imag, 512)
    want = jct.band_cap_model_ft(mf.real, mf.imag, 512)
    assert got[2] == want[2] and got[2] is not None
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert sdft.cap_nharm(512, got[2]) == len(jct.ct_perm_np(512, got[2]))
    for nbin in (200, 256, 384, 512, 4096, 8192):
        assert sdft.cap_supported(nbin) == jct.ct_supported(nbin)
    assert sdft.suggest_mharm(mf.real, mf.imag, 512) is None


def test_setup_kernel_wrapper_requires_int16_scale_and_f0_zeroing():
    x = torch.zeros((1, 4, 64), dtype=torch.int16)
    m = torch.zeros((4, 33))
    with pytest.raises(ValueError):
        sdft.fused_setup(x, m, m, f0_fact=True, scale=torch.ones(1, 4))
