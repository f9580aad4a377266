"""Port parity: parallel.mesh (batch- and channel-sharded fits) and
GetTOAs.get_TOAs(mesh=...), float64 on the CPU.

The port's meshes lay repeated CPU devices (["cpu"] * 8) out as the JAX
tests' 8 virtual CPU devices are laid out (tests/conftest.py): the same
logic (channel slabs, a thread per batch shard, what crosses between
devices), not a speed-up.

- The sharded fit against the port's single-device fit: every field of
  the result bitwise equal with seed_phase=False (per-row results do not
  depend on the split), on even, uneven and channel-only meshes, int16
  with scales, packed; with the brute seed, whose band sums are added
  over the slabs in another order, within 1e-9 of the errors (measured:
  2.4e-13 sigma at most).
- Against the JAX package's three sharded fits on the meshes of
  tests/test_parallel.py: fit_portrait_full_sharded (float64 GSPMD)
  within test_torch_fit.py's tolerances for its float64 fits (parameters
  1e-6 of their errors, the rest 1e-8 relative; the scattering fit 1e-5
  and 1e-6), _ct and _direct (float32 setups) within the tolerances
  tests/test_parallel.py holds them to against the float64 single-device
  fit (5e-6 in phi and DM, chi2 1e-4 relative; the int16 ingest 2e-4).
- What crosses devices each Newton iteration is (B, nchan_i)-sized: the
  port's counterpart of test_parallel.py's HLO audit.
- GetTOAs(mesh=...) on test_parallel.py's campaign against the unsharded
  port and the JAX mesh run: TOAs within 1e-10 s, DMs within 1e-9, also
  with fit_GM and fit_scat.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters.portrait import \
    fit_portrait_full_batch as jfit  # noqa: E402
from pulseportraiture_tpu.fitters.portrait import \
    unpack_result as junpack  # noqa: E402
from pulseportraiture_tpu.parallel import mesh as jmesh  # noqa: E402
from pulseportraiture_tpu_torch.fitters import stats  # noqa: E402
from pulseportraiture_tpu_torch.fitters.portrait import (  # noqa: E402
    _fit_batch, fit_portrait_full_batch, template_spectrum, unpack_result)
from pulseportraiture_tpu_torch.ops.setup_dft import (  # noqa: E402
    band_cap_model_ft, cap_nharm)
from pulseportraiture_tpu_torch.parallel.mesh import (  # noqa: E402
    fit_portrait_full_sharded, make_mesh, shard_fit_inputs)

from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)
CPU8 = ["cpu"] * 8
FLAGS = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30)


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem: 4 items x 16 channels x 128 bins,
    one Gaussian template with a power-law spectrum, white noise."""
    rng = np.random.default_rng(0)
    B, nchan, nbin = 4, 16, 128
    freqs = np.linspace(1100.0, 1900.0, nchan)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.03) ** 2)
    model = prof[None, :] * (freqs[:, None] / 1500.0) ** -1.3
    data = np.broadcast_to(model, (B, nchan, nbin)) + \
        rng.normal(0, 0.02, (B, nchan, nbin))
    return dict(data=data, model=model, init=np.zeros((B, 5)),
                Ps=np.full(B, 0.003), freqs=freqs,
                errs=np.full((B, nchan), 0.02))


def _args(p, data=None, mft=None):
    return (torch.from_numpy(p["data"] if data is None else data),
            template_spectrum(p["model"]) if mft is None else mft,
            p["init"], p["Ps"], p["freqs"], p["errs"])


def _assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is None:
            assert y is None, name
            continue
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), name


@pytest.mark.parametrize("shape", [(4, 2), (1, 8), (2, 3), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_fit_is_bitwise_the_single_device_fit(problem, shape):
    """Even (4x2, 1x8) and uneven meshes: 16 channels in 3 slabs of 6, 5
    and 5; 4 items in 3 batch shards of 2, 1 and 1."""
    want = fit_portrait_full_batch(*_args(problem), seed_phase=False,
                                   **FLAGS)
    mesh = make_mesh(*shape, devices=CPU8)
    got = fit_portrait_full_sharded(mesh, *_args(problem), seed_phase=False,
                                    **FLAGS)
    _assert_equal(got, want)
    packed = fit_portrait_full_sharded(mesh, *_args(problem),
                                       seed_phase=False, packed=True,
                                       **FLAGS)
    assert packed.device.type == "cpu" and packed.shape[0] == 4
    for name, x, y in zip(want._fields, unpack_result(packed, 16), want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)


def test_seeded_sharded_fit_within_1e9_sigma(problem):
    """The brute seed's band sums are added over the slabs in slab order:
    the start moves by rounding, the optimum by far less than 1e-9 of
    the errors (measured: 1.9e-13, 3.8e-16 and 2.4e-13 sigma)."""
    data = problem["data"].copy()
    data[1] = np.roll(data[1], 40, axis=-1)          # a far-off phase
    want = fit_portrait_full_batch(*_args(problem, data), seed_phase=True,
                                   **FLAGS)
    for shape in ((4, 2), (1, 8), (2, 3)):
        got = fit_portrait_full_sharded(make_mesh(*shape, devices=CPU8),
                                        *_args(problem, data),
                                        seed_phase=True, **FLAGS)
        z = (got.params - want.params).abs()[:, :2] / want.param_errs[:, :2]
        assert float(z.max()) <= 1e-9, (shape, z)
        assert float((got.param_errs / want.param_errs - 1)[:, :2].abs()
                     .max()) <= 1e-9


def test_int16_scales_sharded_is_bitwise(problem):
    """int16 data with per-channel scales, shipped to each slab as int16
    and dequantized in its setup: bitwise the single-device int16 fit."""
    q = np.clip(np.round(problem["data"] / 2e-4), -32767,
                32767).astype(np.int16)
    sc = np.full(q.shape[:2], 2e-4)
    x, mft, *rest = _args(problem, q)
    kw = dict(FLAGS, scales=sc, dtype=torch.float64, seed_phase=False)
    want = fit_portrait_full_batch(x, mft, *rest, **kw)
    got = fit_portrait_full_sharded(make_mesh(2, 3, devices=CPU8), x, mft,
                                    *rest, **kw)
    _assert_equal(got, want)
    d = fit_portrait_full_batch(*_args(problem), seed_phase=False, **FLAGS)
    assert float(((got.params - d.params).abs() / d.param_errs)[:, :2]
                 .max()) < 0.05                   # the quantization


def test_only_per_channel_operands_cross_devices(problem):
    """The port's counterpart of test_parallel.py's HLO audit: the slabs
    keep Gr, Gi and M2 (ChanSlabs on the setup), and every operand that
    crosses between the lead and a slab in the Newton loop is
    (B, nchan_i)-sized: phases out, 3 moments per channel back."""
    seen = []
    real = stats._per_slab

    def spy(fn, rows, slabs):
        out = real(fn, rows, slabs)
        widths = [p.shape[-2] for p in slabs[0].parts]
        seen.append(([tuple(r.shape) for r in rows],
                     [tuple(o.shape) for o in out], widths))
        return out

    stats._per_slab = spy
    try:
        res, setup, newton_res = _fit_batch(
            *_args(problem), seed_phase=True, chan_devices=CPU8[:3],
            **FLAGS)
    finally:
        stats._per_slab = real
    assert isinstance(setup.Gr, stats.ChanSlabs)
    assert [p.shape for p in setup.Gr.parts] == [(4, 6, 65), (4, 5, 65),
                                                 (4, 5, 65)]
    assert len(seen) >= int(newton_res.niter.max())
    for rows, outs, widths in seen:
        assert widths == [6, 5, 5]
        assert rows == [(4, 16)] and outs == [(4, 16)] * 3


def test_exception_on_a_shard_reraises(problem):
    x, (mr, mi), *rest = _args(problem)
    per_item = (np.broadcast_to(mr, (4,) + mr.shape),
                np.broadcast_to(mi, (4,) + mi.shape))
    with pytest.raises(ValueError, match="seed_phase=False"):
        fit_portrait_full_sharded(make_mesh(2, 2, devices=CPU8), x, per_item,
                                  *rest, seed_phase=True, **FLAGS)


def test_shard_fit_inputs_and_mesh_shapes(problem):
    mesh = make_mesh(n_chan=2, devices=CPU8)
    assert mesh.shape == {"batch": 4, "chan": 2}
    assert mesh.devices[3] == [torch.device("cpu")] * 2
    shards = shard_fit_inputs(make_mesh(3, 1, devices=CPU8), *_args(problem))
    assert [s[2] for s in shards] == [(0, 2), (2, 3), (3, 4)]
    assert shards[1][3]["freqs"].shape == (1, 16)
    with pytest.raises(ValueError):
        make_mesh(3, 3, devices=CPU8)


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a CUDA-less box")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(devices=["cuda:0"])


def _jax_args(p, model=None):
    B = p["data"].shape[0]
    return (jnp.asarray(p["data"]),
            jnp.asarray(np.broadcast_to(p["model"], (B,) + p["model"].shape)
                        if model is None else model),
            jnp.zeros((B, 5)), jnp.full(B, 0.003), jnp.asarray(p["freqs"]),
            jnp.asarray(p["errs"]))


def _close(got, want, tol_p, tol_r, cols=5):
    errs = np.asarray(want.param_errs)
    dp = np.abs(np.asarray(got.params) - np.asarray(want.params))[:, :cols]
    assert np.all(dp <= tol_p * errs[:, :cols]), dp / errs[:, :cols]
    for name in ("param_errs", "scales", "chi2", "snr", "nu_DM"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert np.max(np.abs(g - w)) <= tol_r * np.max(np.abs(w)), name


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_jax_sharded_float64(problem, shape):
    want = jmesh.fit_portrait_full_sharded(jmesh.make_mesh(*shape),
                                           *_jax_args(problem), **FLAGS)
    got = fit_portrait_full_sharded(make_mesh(*shape, devices=CPU8),
                                    *_args(problem), seed_phase=False,
                                    **FLAGS)
    _close(got, want, 1e-6, 1e-8)


def _capped_problem(seed=3, width=0.06, nbin=256, B=4, nchan=16):
    """test_parallel.py's _ct_problem: width 0.06 keeps the template band
    at mharm=8, so the JAX direct capped setup dispatches."""
    rng = np.random.default_rng(seed)
    fr = np.linspace(1100.0, 1900.0, nchan)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / width) ** 2)
    model = prof[None] * (fr[:, None] / 1500.0) ** -1.3
    data = np.broadcast_to(model, (B, nchan, nbin)) + \
        rng.normal(0, 0.02, (B, nchan, nbin))
    mf = np.fft.rfft(model, axis=-1)
    mr, mi, mh = band_cap_model_ft(mf.real, mf.imag, nbin)
    return dict(data=data, model=model, init=np.zeros((B, 5)),
                Ps=np.full(B, 0.003), freqs=fr,
                errs=np.full((B, nchan), 0.02), cap=(mr, mi, mh))


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_matches_jax_ct_and_direct(shape):
    """The JAX package's float32-setup sharded fits, seeded and packed,
    against the port's float64 sharded fit on the same (capped for
    _direct) template, and the port's int16 ingest against _direct's."""
    p = _capped_problem()
    mr, mi, mh = p["cap"]
    nh = cap_nharm(256, mh)
    f32 = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
               scattering=False, seed_phase=True)
    jm = jmesh.make_mesh(*shape)
    jargs = (jnp.asarray(p["data"], jnp.float32),
             jnp.asarray(p["model"], jnp.float32), jnp.zeros((4, 5)),
             jnp.full(4, 0.003, jnp.float32),
             jnp.asarray(p["freqs"], jnp.float32),
             jnp.full((4, 16), 0.02, jnp.float32))
    ct = junpack(np.asarray(jmesh.fit_portrait_full_sharded_ct(
        jm, *jargs, packed=True, **f32)), 16)
    direct = junpack(np.asarray(jmesh.fit_portrait_full_sharded_direct(
        jm, *jargs, packed=True, model_ft_ri=(mr, mi), mharm=mh, **f32)), 16)
    mesh = make_mesh(*shape, devices=CPU8)
    kw = dict(FLAGS, seed_phase=True, packed=True)
    full = unpack_result(fit_portrait_full_sharded(mesh, *_args(p), **kw), 16)
    capped = unpack_result(fit_portrait_full_sharded(
        mesh, *_args(p, mft=(mr[:, :nh], mi[:, :nh])), **kw), 16)
    for got, want in ((full, ct), (capped, direct)):
        assert np.abs(got.params[:, :2] - want.params[:, :2]).max() < 5e-6
        assert np.allclose(got.chi2, want.chi2, rtol=1e-4)
    q = np.clip(np.round(p["data"] / 2e-4), -32767, 32767).astype(np.int16)
    sc = np.full((4, 16), 2e-4)
    j16 = junpack(np.asarray(jmesh.fit_portrait_full_sharded_direct(
        jm, jnp.asarray(q), *jargs[1:], packed=True, model_ft_ri=(mr, mi),
        mharm=mh, scales=jnp.asarray(sc, jnp.float32), **f32)), 16)
    x, mft, *rest = _args(p, q, mft=(mr[:, :nh], mi[:, :nh]))
    p16 = unpack_result(fit_portrait_full_sharded(
        mesh, x, mft, *rest, scales=sc, dtype=torch.float64, **kw), 16)
    assert np.abs(p16.params[:, :2] - j16.params[:, :2]).max() < 2e-4
    assert np.abs(p16.params[:, :2] - capped.params[:, :2]).max() < 2e-4


def test_scattering_fit_matches_single_device_and_jax():
    """tests/test_parallel.py's scattering recipe (tau 12 bins at 1500
    MHz, alpha -4, fit (phi, DM, tau, alpha) in linear tau) on the 4x2
    mesh: bitwise the port's single-device fit; against the JAX sharded
    fit within test_torch_fit.py's scattering tolerances."""
    from pulseportraiture_tpu_torch.ops.scattering import \
        scattering_portrait_FT_np

    rng = np.random.default_rng(21)
    B, nchan, nbin = 4, 16, 256
    fr = np.linspace(1100.0, 1900.0, nchan)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.04) ** 2)
    model = prof[None, :] * (fr[:, None] / 1500.0) ** -1.3
    tau0, alpha, nu_r = 12.0, -4.0, 1500.0
    taus = tau0 * (fr / nu_r) ** alpha / nbin
    data = np.fft.irfft(np.fft.rfft(model, axis=-1) *
                        scattering_portrait_FT_np(taus, nbin), n=nbin,
                        axis=-1)
    data = np.broadcast_to(data, (B, nchan, nbin)) + \
        rng.normal(0, 0.01, (B, nchan, nbin))
    init = np.zeros((B, 5))
    init[:, 3], init[:, 4] = tau0 / nbin * 0.5, -4.0
    errs = np.full((B, nchan), 0.01)
    kw = dict(fit_flags=(1, 1, 0, 1, 1), log10_tau=False, max_iter=60,
              scattering=True)
    args = (torch.from_numpy(data), template_spectrum(model), init,
            np.full(B, 0.003), fr, errs)
    single = fit_portrait_full_batch(*args, seed_phase=False, **kw)
    got = fit_portrait_full_sharded(make_mesh(4, 2, devices=CPU8), *args,
                                    seed_phase=False, **kw)
    _assert_equal(got, single)
    want = jmesh.fit_portrait_full_sharded(
        jmesh.make_mesh(4, 2), jnp.asarray(data),
        jnp.asarray(np.broadcast_to(model, (B, nchan, nbin))),
        jnp.asarray(init), jnp.full(B, 0.003), jnp.asarray(fr),
        jnp.asarray(errs), **kw)
    _close(got, want, 1e-5, 1e-6)
    assert np.isfinite(got.params.numpy()).all()


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """tests/test_parallel.py's campaign: one archive of 4 subints x 16
    channels x 128 bins from a one-Gaussian .gmodel, dDM 2e-4."""
    from pulseportraiture_tpu.io.mjd import MJD
    from pulseportraiture_tpu.models.gmodel_io import write_model
    from pulseportraiture_tpu.sim.fake import make_fake_pulsar

    d = tmp_path_factory.mktemp("torch_mesh")
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
    make_fake_pulsar(gmodel, par, outfile=path, nsub=4, npol=1, nchan=16,
                     nbin=128, nu0=1500.0, bw=800.0, tsub=60.0, phase=0.0,
                     dDM=2e-4, start_MJD=MJD(57202.0), noise_stds=0.3,
                     dedispersed=False, scint=False, quiet=True,
                     rng=np.random.default_rng(7))
    return path, gmodel


@pytest.mark.parametrize("kw", [{}, {"fit_GM": True}, {"fit_scat": True}],
                         ids=["phi_DM", "fit_GM", "fit_scat"])
def test_get_toas_mesh_matches_unsharded_and_jax(campaign, kw):
    from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    path, gmodel = campaign
    runs = []
    for mesh in (None, make_mesh(2, 4, devices=CPU8),
                 make_mesh(1, 3, devices=CPU8)):
        gt = GetTOAs([path], gmodel, device="cpu", dtype=torch.float64,
                     quiet=True)
        gt.get_TOAs(quiet=True, mesh=mesh, **kw)
        runs.append(gt.TOA_list)
    jt = JGetTOAs([path], gmodel, quiet=True)
    jt.get_TOAs(quiet=True, mesh=jmesh.make_mesh(n_batch=2, n_chan=4), **kw)
    assert len(jt.TOA_list) == 4 and all(len(r) == 4 for r in runs)
    for other in runs[1:] + [jt.TOA_list]:
        for a, b in zip(other, runs[0]):
            assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-10
            assert abs(a.DM - b.DM) < 1e-9
            for flag in ("gm", "scat_time"):
                if flag in b.flags:
                    assert abs(a.flags[flag] - b.flags[flag]) <= \
                        1e-9 * max(1.0, abs(b.flags[flag]))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_shard_tallies_its_launches(problem, monkeypatch, shape):
    """mesh.launches: each shard's setup and moments launches, counted
    where a kernel would launch (ops.launches.counted).  The CPU twins
    count nothing, so the wrappers are wrapped here to count as the card
    path does: one setup a shard and chunk, moments on every shard."""
    from pulseportraiture_tpu_torch.fitters import portrait
    from pulseportraiture_tpu_torch.ops import moments as mom
    from pulseportraiture_tpu_torch.ops import setup_dft as sdft
    from pulseportraiture_tpu_torch.ops.launches import counted

    def counting(fn, twin):
        def wrapper(*a, **k):
            counted(fn)
            return twin(*a, **k)
        return wrapper

    monkeypatch.setattr(portrait, "fused_setup",
                        counting(sdft.fused_setup, sdft.fused_setup))
    monkeypatch.setattr(mom, "phase_moments",
                        counting(mom.phase_moments, mom.phase_moments))
    n0 = sdft.fused_setup.launches
    mesh = make_mesh(*shape, devices=CPU8)
    for _ in range(2):
        fit_portrait_full_sharded(mesh, *_args(problem), seed_phase=True,
                                  **FLAGS)
    assert sdft.fused_setup.launches - n0 == 2 * shape[0] * shape[1]
    assert set(mesh.launches) == {(b, c) for b in range(shape[0])
                                  for c in range(shape[1])}
    for shard, counts in mesh.launches.items():
        assert counts["fused_setup"] == 2, (shard, counts)
        assert counts["phase_moments"] >= 2, (shard, counts)
    mesh.reset_launches()
    assert all(not c for c in mesh.launches.values())
