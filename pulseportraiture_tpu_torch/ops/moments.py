"""Per-channel harmonic moments of the Newton loop: CUDA kernels + twins.

Phase moments, for each (item, channel) row of the cross-spectrum
G = Gr + i Gi under the phase ramp P_k = e^{2 pi i phi k}:

    C   =          sum_k Re(G_k P_k)
    Cp  = -2 pi    sum_k k   Im(G_k P_k)
    Cpp = -4 pi^2  sum_k k^2 Re(G_k P_k)

Scattering moments add the scattering FT B_k = 1/(1 + 2 pi i k tau) of
the row's tau, its tau derivatives f = -2 pi i k B^2 and g2 = -8 pi^2 k^2
B^3, and the template power M2 (shared by every item of a batch): the
9 reductions C, S, Cp, Rf, S1, Cpp, If1, Rg, S2 of
pulseportraiture_tpu/ops/pallas_moments.py `_scat_terms_ref`.

Kernel notes:
  * csrc/moments.cu `pp_phase_moments` replaces the Pallas kernels
    `_phase_moments_impl`/`_phase_kernel` (natural order),
    `_phase_moments_kvec_impl` and `_phase_moments_ct_impl` (the permuted
    TPU layouts, which natural order makes unnecessary).
  * csrc/scat_moments.cu `pp_scat_moments` replaces
    `_scattering_moments_impl`, `_scattering_moments_kvec_impl` and
    `_scattering_moments_ct_impl` the same way.
  * csrc/moments_merged.cu `pp_phase_moments_merged` replaces the merged
    single-stream kernel of scripts/tpu_moments_layout.py
    (`make_merged_kernel`): the phase moments read from one buffer
    g = [Gr | Gi] of shape (rows, 2 nharm).  The narrowband fits build
    their cross-spectrum once in that layout and launch it once per
    Newton step; with nharm a multiple of 4 each half is read by 128-bit
    loads.
  * moments.cu and moments_merged.cu: one warp per row strides over the
    harmonics (coalesced reads, each element of Gr/Gi read once), the
    double-single phasor of fitters.stats._phase_trig per element
    (csrc/phase_trig.cuh, rounded non-contracted f32 steps, precise
    sincosf), f32 accumulators and one warp-shuffle reduction.
  * scat_moments.cu: the nine sums in closed form (one reciprocal a
    harmonic, no division), 8, 16 or 32 lanes a row by shape
    (scat_geometry), groups of 4 harmonics read by 128-bit loads on each
    row's aligned body, and a factored phasor F_l E_m S_j whose factors'
    angles are rounded once (_phase_trig_rn): no sincosf in the harmonic
    loop.  scattering_moments_factored_reference walks its steps on the
    CPU.
  * The plain torch forms materialize (B, nchan, nharm) temporaries; the
    kernels none.  Bound on the H100: the 8 bytes of Gr/Gi per harmonic
    (M2 rows come from L2 across items).  The merged kernel at one
    narrowband subint (4096 rows, 1025 harmonics: 34 MB) is
    launch-latency sized.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pulseportraiture_tpu_torch.fitters.stats import TWO_PI, _phase_trig
from pulseportraiture_tpu_torch.ops.launches import counted
from pulseportraiture_tpu_torch.ops.launches import stream as _stream

# what the kernels take: harmonic indices exact in f32 (the phasors form
# k as a float; _phase_trig reduces it mod 8192, exact up to 2^24) and a
# one-dimensional grid of at most 2^31 - 1 blocks
MAX_NHARM, MAX_BLOCKS = 2 ** 24, 2 ** 31 - 1
# rows a block of csrc/moments.cu and csrc/moments_merged.cu (one warp each)
PHASE_ROWS_PER_BLOCK = 8
# constant factors of the 9 scattering sums (C, S, Cp, Rf, S1, Cpp, If1,
# Rg, S2)
_SCAT_FACTORS = (1.0, 1.0, -TWO_PI, 1.0, 1.0, -TWO_PI * TWO_PI, -TWO_PI,
                 1.0, 1.0)
# csrc/scat_moments.cu: harmonics a lane reads at once (float4), lanes a
# row it takes, threads a block at most
SCAT_VEC, SCAT_LANES, SCAT_MAX_THREADS = 4, (8, 16, 32), 256
# scat_geometry: the harmonics a lane holds and the warps an SM it fills
# before it widens a row's lanes, and its threads a block
SCAT_LANE_HARMONICS, SCAT_FILL_WARPS, SCAT_BLOCK_THREADS = 128, 8, 64
# and the M2 rows a tile of rows when they are taken item by item
SCAT_TILE = 16


def phase_moments_reference(phis, Gr, Gi):
    """Plain torch (C, Cp, Cpp), each (..., nchan), in Gr's dtype."""
    nharm = Gr.shape[-1]
    k = torch.arange(nharm, dtype=Gr.dtype, device=Gr.device)
    c, s = _phase_trig(phis, k)
    zr = Gr * c - Gi * s
    zi = Gr * s + Gi * c
    C = torch.sum(zr, dim=-1)
    Cp = (-TWO_PI) * torch.sum(k * zi, dim=-1)
    Cpp = (-TWO_PI * TWO_PI) * torch.sum(k * k * zr, dim=-1)
    return C, Cp, Cpp


def phase_moments(phis, Gr, Gi):
    """(C, Cp, Cpp), each (..., nchan), from phis (..., nchan) and Gr/Gi
    (..., nchan, nharm).

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if Gr.device.type == "cpu":
        return phase_moments_reference(phis, Gr, Gi)
    if Gr.device.type != "cuda":
        raise ValueError(f"phase_moments: unsupported device {Gr.device}")
    return _launch(phis, Gr, Gi)


phase_moments.launches = 0


def _launch(phis, Gr, Gi):
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("phase_moments", (("phis", phis), ("Gr", Gr), ("Gi", Gi)),
               Gr.device)
    if Gi.shape != Gr.shape or phis.shape != Gr.shape[:-1]:
        raise ValueError(f"phase_moments: shapes phis {tuple(phis.shape)}, "
                         f"Gr {tuple(Gr.shape)}, Gi {tuple(Gi.shape)}")
    nharm = Gr.shape[-1]
    rows = phis.numel()
    _check_limits("phase_moments", nharm, rows, PHASE_ROWS_PER_BLOCK)
    phis = phis.contiguous()
    if not (Gr.is_contiguous() and Gi.is_contiguous()):
        raise ValueError("phase_moments kernel: Gr/Gi must be contiguous")
    out = torch.empty((3,) + tuple(phis.shape), dtype=torch.float32,
                      device=Gr.device)
    if rows:
        lib = load_kernels()
        with torch.cuda.device(Gr.device):
            err = lib.pp_phase_moments(
                ctypes.c_void_p(phis.data_ptr()),
                ctypes.c_void_p(Gr.data_ptr()),
                ctypes.c_void_p(Gi.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(rows),
                ctypes.c_int(nharm), _stream(Gr.device))
        if err != 0:
            raise RuntimeError(f"pp_phase_moments launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        counted(phase_moments)
    return out[0], out[1], out[2]


def phase_moments_merged_reference(phis, g):
    """Plain torch (C, Cp, Cpp), each (...,), from phis (...,) and the
    merged stream g (..., 2 nharm) = [Gr | Gi]: the split twin on the two
    halves."""
    nharm = g.shape[-1] // 2
    return phase_moments_reference(phis, g[..., :nharm], g[..., nharm:])


def phase_moments_merged(phis, g):
    """(C, Cp, Cpp), each (...,), from phis (...,) and one merged stream
    g (..., 2 nharm) with g[..., :nharm] = Gr and g[..., nharm:] = Gi.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if g.shape[-1] % 2:
        raise ValueError(f"phase_moments_merged: g must hold [Gr | Gi], got "
                         f"an odd last axis {g.shape[-1]}")
    if g.device.type == "cpu":
        return phase_moments_merged_reference(phis, g)
    if g.device.type != "cuda":
        raise ValueError(f"phase_moments_merged: unsupported device "
                         f"{g.device}")
    return _launch_merged(phis, g)


phase_moments_merged.launches = 0


def _launch_merged(phis, g):
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("phase_moments_merged", (("phis", phis), ("g", g)), g.device)
    if phis.shape != g.shape[:-1]:
        raise ValueError(f"phase_moments_merged: shapes phis "
                         f"{tuple(phis.shape)}, g {tuple(g.shape)}")
    nharm = g.shape[-1] // 2
    rows = phis.numel()
    _check_limits("phase_moments_merged", nharm, rows, PHASE_ROWS_PER_BLOCK)
    phis = phis.contiguous()
    if not g.is_contiguous():
        raise ValueError("phase_moments_merged kernel: g must be contiguous")
    out = torch.empty((3,) + tuple(phis.shape), dtype=torch.float32,
                      device=g.device)
    if rows:
        lib = load_kernels()
        with torch.cuda.device(g.device):
            err = lib.pp_phase_moments_merged(
                ctypes.c_void_p(phis.data_ptr()),
                ctypes.c_void_p(g.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(rows),
                ctypes.c_int(nharm), _stream(g.device))
        if err != 0:
            raise RuntimeError(f"pp_phase_moments_merged launch failed: CUDA "
                               f"error {err} "
                               f"({lib.pp_error_string(err).decode()})")
        counted(phase_moments_merged)
    return out[0], out[1], out[2]


def scattering_moments_reference(phis, taus, Gr, Gi, M2, absolute=False):
    """Plain torch (C, S, Cp, Rf, S1, Cpp, If1, Rg, S2), each (..., nchan),
    in Gr's dtype; M2 (nchan, nharm) or (..., nchan, nharm).

    absolute=True sums the magnitudes of the summands instead (with the
    constant factors' magnitudes): the scale of each sum's rounding error,
    for tolerances.  Written from pallas_moments._scat_terms_ref.
    """
    nharm = Gr.shape[-1]
    k = torch.arange(nharm, dtype=Gr.dtype, device=Gr.device)
    c, s = _phase_trig(phis, k)
    ct = TWO_PI * k * taus[..., None]
    Bden = 1.0 + ct * ct
    Br = 1.0 / Bden
    Bi = -ct / Bden
    del ct, Bden
    Ar = Gr * Br + Gi * Bi
    Ai = Gi * Br - Gr * Bi
    zr = Ar * c - Ai * s
    zi = Ar * s + Ai * c
    del Ar, Ai
    cb2r = Br * Br - Bi * Bi
    cb2i = -2.0 * Br * Bi
    cfr = TWO_PI * k * (-cb2i)
    cfi = TWO_PI * k * cb2r
    GPr = Gr * c - Gi * s
    GPi = Gr * s + Gi * c
    del c, s
    zfr = GPr * cfr - GPi * cfi
    zfi = GPr * cfi + GPi * cfr
    u1 = 2.0 * (Br * cfr - Bi * cfi)
    cb3r = cb2r * Br + cb2i * Bi
    cb3i = -cb2r * Bi + cb2i * Br
    del cb2r, cb2i
    w2k2 = -(TWO_PI ** 2) * 2.0 * k * k
    cgr = w2k2 * cb3r
    cgi = w2k2 * cb3i
    del cb3r, cb3i
    zgr = GPr * cgr - GPi * cgi
    u2 = 2.0 * ((cfr * cfr + cfi * cfi) + (Br * cgr - Bi * cgi))
    B2 = Br * Br + Bi * Bi
    terms = (zr, B2 * M2, k * zi, zfr, u1 * M2, k * k * zr, k * zfi, zgr,
             u2 * M2)
    if absolute:
        return tuple(abs(f) * torch.sum(torch.abs(t), dim=-1)
                     for f, t in zip(_SCAT_FACTORS, terms))
    return tuple(f * torch.sum(t, dim=-1)
                 for f, t in zip(_SCAT_FACTORS, terms))


def scat_geometry(rows: int, nh: int, nsm: int = 132, m2_rows=None,
                  l2_bytes: int = 50 * 2 ** 20):
    """(lanes per row, rows per block, M2 rows a tile) of
    csrc/scat_moments.cu, for `rows` rows of nh harmonics reading m2_rows
    M2 rows (default: one each), on nsm SMs sharing l2_bytes of L2.

    Lanes: 8 (a row's setup and its 3-level reduction shared by 4 rows a
    warp), widened while a lane would hold SCAT_LANE_HARMONICS harmonics or
    more, or the grid would hold fewer than SCAT_FILL_WARPS warps an SM,
    as long as a row has a group of SCAT_VEC harmonics for every new lane.
    Rows per block: SCAT_BLOCK_THREADS threads, halved while the grid would
    have fewer than two blocks an SM.  Tile: row order (m2_rows) for one
    item, or while an item's pass over its rows (Gr, Gi and M2: 12 nh
    bytes a row) fits in half the L2, so that each M2 row is still there
    for the next item; else SCAT_TILE M2 rows, item by item.
    scripts/torch_scat_tune.py measures the choices against the others.
    """
    lanes, groups = 8, -(-nh // SCAT_VEC)
    while 2 * lanes <= min(32, groups) and (
            nh >= SCAT_LANE_HARMONICS * lanes or
            rows * lanes < SCAT_FILL_WARPS * 32 * nsm):
        lanes *= 2
    rpb = SCAT_BLOCK_THREADS // lanes
    while rpb * lanes > 32 and -(-rows // rpb) < 2 * nsm:
        rpb //= 2
    m2_rows = rows if m2_rows is None else m2_rows
    tile = m2_rows
    if m2_rows < rows and 12 * nh * m2_rows > l2_bytes // 2:
        tile = min(SCAT_TILE, m2_rows)
    return lanes, rpb, tile


def _phase_trig_rn(p, k):
    """cos/sin(2 pi p k) of wrapped phases p (...,) at k (..., n), as
    csrc/phase_trig.cuh phase_trig_rn forms them: float32 rounds the angle
    once (p k and its reduction mod 1 are exact in float64); float64 is
    fitters.stats._phase_trig's plain product."""
    if p.dtype == torch.float64:
        return _phase_trig(p, k)
    x = p.double()[..., None] * k.double()
    ang = (TWO_PI * (x - torch.round(x))).to(p.dtype)
    return torch.cos(ang), torch.sin(ang)


def _scat_phasor(p, h0, lanes, vec, steps):
    """(Re, Im) of e^{2 pi i p k}, (rows, steps, lanes, vec), at k = h0 +
    vec (l + lanes j) + m, formed as the kernel forms it: F_l E_m S_j with
    F_l = e^{2 pi i p (h0 + vec l)}, E_m = e^{2 pi i p m}, S_j =
    e^{2 pi i p vec lanes j}; F_l E_m first, then one complex product.
    p (rows,) wrapped phases, h0 (rows,) integers."""
    dev, dt = p.device, p.dtype

    def ar(n):
        return torch.arange(n, device=dev)
    fc, fs = _phase_trig_rn(p, (h0[:, None] + vec * ar(lanes)).to(dt))
    ec, es = _phase_trig_rn(p, ar(vec).to(dt))
    sc, ss = _phase_trig_rn(p, (vec * lanes * ar(steps)).to(dt))
    ler = fc[:, :, None] * ec[:, None, :] - fs[:, :, None] * es[:, None, :]
    lei = fc[:, :, None] * es[:, None, :] + fs[:, :, None] * ec[:, None, :]
    ler, lei = ler[:, None], lei[:, None]
    sc, ss = sc[:, :, None, None], ss[:, :, None, None]
    return ler * sc - lei * ss, ler * ss + lei * sc


def scattering_moments_factored_reference(phis, taus, Gr, Gi, M2, lanes,
                                          vec=SCAT_VEC, base=0):
    """The nine scattering sums by csrc/scat_moments.cu's own steps, in
    Gr's dtype (tests only; the wrapper's CPU path is the twin).

    Row r starts at offset o = (base + r nharm) mod vec of a vec-aligned
    storage (base: Gr's own offset, in elements); h0 = -o.  Lane l of
    `lanes` takes the groups g = l + lanes j of vec harmonics h0 + vec g ..
    + vec - 1 (zero outside 0..nharm-1) under the factored phasor
    (_scat_phasor), sums the closed forms over its groups, and the lanes
    are added by the kernel's butterfly; then the constant factors.
    """
    nh = Gr.shape[-1]
    rows = phis.numel()
    dev, dt = Gr.device, Gr.dtype
    p = phis.reshape(rows)
    p = p - torch.round(p)
    tau = taus.reshape(rows)
    m2 = M2.reshape(-1, nh)
    idx = torch.arange(rows, device=dev)
    m2 = m2[idx % m2.shape[0]]
    h0 = -((base + idx * nh) % vec)
    steps = -(-((nh + 2 * (vec - 1)) // vec) // lanes)
    k = (h0[:, None, None, None] + vec * (
        torch.arange(lanes, device=dev)[None, None, :, None] + lanes *
        torch.arange(steps, device=dev)[None, :, None, None]) +
        torch.arange(vec, device=dev))
    ok = (k >= 0) & (k < nh)
    kc = k.clamp(0, nh - 1).reshape(rows, -1)

    def take(t):
        return torch.where(ok, t.reshape(rows, nh).gather(1, kc).reshape(
            k.shape), torch.zeros((), dtype=dt, device=dev))
    x, y, mm = take(Gr), take(Gi), take(m2)
    pr, pi = _scat_phasor(p, h0, lanes, vec, steps)
    kf = k.to(dt)
    c = (TWO_PI * tau).to(dt)[:, None, None, None] * kf
    br = 1.0 / (c * c + 1.0)
    bi = -c * br
    gpr = x * pr - y * pi
    gpi = x * pi + y * pr
    zr = gpr * br + gpi * bi
    zi = gpi * br - gpr * bi
    wr = zr * br + zi * bi
    wi = zi * br - zr * bi
    vr = wr * br + wi * bi
    k2 = kf * kf
    t = br * mm
    u = k2 * (br * t)
    terms = (zr, t, kf * zi, kf * wi, u, k2 * zr, k2 * wr, k2 * vr,
             u * br * (3.0 * c * c - 1.0))
    lane_ix = torch.arange(lanes, device=dev)
    sums = []
    for term in terms:
        a = term.sum(dim=(1, 3))                       # (rows, lanes)
        o = lanes // 2
        while o:
            a = a + a[:, lane_ix ^ o]
            o //= 2
        sums.append(a[:, 0])
    C, S, Cp, Rf, S1, Cpp, If1, Rg, S2 = sums
    f2, f4, f8 = -TWO_PI, -TWO_PI * TWO_PI, -2.0 * TWO_PI * TWO_PI
    out = (C, S, f2 * Cp, f2 * Rf, (f8 * tau) * S1, f4 * Cpp, f4 * If1,
           f8 * Rg, -f8 * S2)
    return tuple(v.reshape(phis.shape) for v in out)


def scattering_moments(phis, taus, Gr, Gi, M2):
    """(C, S, Cp, Rf, S1, Cpp, If1, Rg, S2), each (..., nchan), from phis
    and taus (..., nchan), Gr/Gi (..., nchan, nharm) and M2 (nchan, nharm)
    shared by every item, or (..., nchan, nharm).

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if Gr.device.type == "cpu":
        return scattering_moments_reference(phis, taus, Gr, Gi, M2)
    if Gr.device.type != "cuda":
        raise ValueError(f"scattering_moments: unsupported device "
                         f"{Gr.device}")
    return _launch_scat(phis, taus, Gr, Gi, M2)


scattering_moments.launches = 0


def _check_f32(name, ts, dev):
    for tname, t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, Gr on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; {tname} is "
                            f"{t.dtype}")


def _check_limits(name, nharm, rows, rows_per_block):
    """Raise on what the kernels cannot index: nharm outside 1..MAX_NHARM
    (harmonic numbers exact in f32) or more than MAX_BLOCKS blocks of
    rows_per_block rows."""
    if not 0 < nharm <= MAX_NHARM:
        raise ValueError(f"{name} kernel: nharm={nharm} outside "
                         f"1..{MAX_NHARM} (harmonic numbers exact in f32)")
    if -(-rows // rows_per_block) > MAX_BLOCKS:
        raise ValueError(f"{name} kernel: {rows} rows need more than "
                         f"{MAX_BLOCKS} blocks of {rows_per_block}")


@functools.lru_cache(maxsize=None)
def _card(device):
    """(SMs, L2 bytes) of a card."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.L2_cache_size


def scat_launch_geometry(phis, M2):
    """The geometry scattering_moments launches csrc/scat_moments.cu with
    for these CUDA tensors (scat_geometry on their card)."""
    nh = M2.shape[-1]
    nsm, l2 = _card(M2.device)
    return scat_geometry(phis.numel(), nh, nsm, M2.numel() // nh, l2)


def _launch_scat(phis, taus, Gr, Gi, M2, geometry=None):
    """csrc/scat_moments.cu; geometry (lanes per row, rows per block, M2
    rows a tile), default scat_geometry (scripts/torch_scat_tune.py sweeps
    it)."""
    from pulseportraiture_tpu_torch._build import load_kernels

    _check_f32("scattering_moments", (("phis", phis), ("taus", taus),
                                      ("Gr", Gr), ("Gi", Gi), ("M2", M2)),
               Gr.device)
    if Gi.shape != Gr.shape or phis.shape != Gr.shape[:-1] or \
            taus.shape != phis.shape or M2.dim() < 2 or \
            Gr.shape[-M2.dim():] != M2.shape:
        raise ValueError(f"scattering_moments: shapes phis "
                         f"{tuple(phis.shape)}, taus {tuple(taus.shape)}, "
                         f"Gr {tuple(Gr.shape)}, Gi {tuple(Gi.shape)}, "
                         f"M2 {tuple(M2.shape)}")
    nharm = Gr.shape[-1]
    rows = phis.numel()
    # a block takes at least one row at any geometry: the grid's bound
    _check_limits("scattering_moments", nharm, rows, 1)
    phis = phis.contiguous()
    taus = taus.contiguous()
    if not (Gr.is_contiguous() and Gi.is_contiguous() and
            M2.is_contiguous()):
        raise ValueError("scattering_moments kernel: Gr/Gi/M2 must be "
                         "contiguous")
    m2_rows = M2.numel() // nharm          # row r reads M2 row r % m2_rows
    out = torch.empty((9,) + tuple(phis.shape), dtype=torch.float32,
                      device=Gr.device)
    if rows:
        lanes, rpb, tile = geometry or scat_launch_geometry(phis, M2)
        lib = load_kernels()
        with torch.cuda.device(Gr.device):
            err = lib.pp_scat_moments(
                ctypes.c_void_p(phis.data_ptr()),
                ctypes.c_void_p(taus.data_ptr()),
                ctypes.c_void_p(Gr.data_ptr()), ctypes.c_void_p(Gi.data_ptr()),
                ctypes.c_void_p(M2.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                ctypes.c_longlong(rows), ctypes.c_longlong(m2_rows),
                ctypes.c_int(nharm), ctypes.c_int(lanes), ctypes.c_int(rpb),
                ctypes.c_longlong(tile), _stream(Gr.device))
        if err != 0:
            raise RuntimeError(f"pp_scat_moments launch failed: CUDA error "
                               f"{err} ({lib.pp_error_string(err).decode()})")
        counted(scattering_moments)
    return tuple(out[j] for j in range(9))
