"""Fused fit setup (DFT + cross-spectrum + data power + seed sums).

fused_setup(x, mr, mi) builds, per item b and channel c, over the first
nh = mr.shape[-1] harmonics (natural order):

    X = rfft(x)[..., :nh] (x dequantized by `scale` after the DFT)
    Gr + i Gi = X conj(M),  harmonic 0 zeroed unless f0_fact
    sd = sum_{k >= 1} |X_k|^2 over ALL harmonics (+ |X_0|^2 with f0_fact)
    gs[b, kk] = sum_c w[b, c, kk] G[b, c]    (with stacked seed weights)

Two hand-written CUDA routes compute it on the card, chosen by shape
(setup_route); the FFT route replaces the Pallas TPU kernels
pulseportraiture_tpu/ops/ct_dft.py `pallas_direct_setup`
(`_direct_kernel_factory`, the capped route) and `ct_setup`
(`_ct_setup_kernel_factory`, the full band): with natural-order
harmonics the capped set is a prefix, so one kernel serves both with
nh = NQ*M' or nbin/2 + 1.

Kernel note (csrc/setup_fft.cu, `pp_fused_setup_fft`; nbin = 64, 128,
8192 and every nbin = 256 q, q = 1..16: the band cap's widths and the
powers of two around them; at most 2 seed columns):
  * Bound on the H100: bytes.  An FFT needs 2.5 nbin log2(nbin) flops
    per row against nbin * itemsize bytes read, so the data read (once)
    and Gr/Gi written set the least time; tensor cores are not used.
  * Design: a block takes a tile of consecutive channels of one item,
    a group of rows at a time; each group arrives in one cp.async.bulk
    into a two-slot shared-memory ring (completion on an mbarrier).  A
    worker of nbin/32 threads transforms each row there as an
    nbin/2-point complex Stockham FFT of the packed row z_j = x_2j + i
    x_2j+1, 16 points a thread in registers, in passes of radix 16, 16
    and 2, 4, 8 or 16 over the power-of-two factor of nbin/2 and, when
    nbin/2 = m 2^a with m odd (nbin 768, 1280, ..., 3840), a closing
    pass of radix m (csrc/fft_passes.cuh).  Below a warp (nbin 64 ..
    512) several workers share a warp (the packed worker, a __syncwarp
    of its lanes between passes); from a warp up a worker is rounded up
    to a power of two; at 8192 two 256-thread workers make a 512-thread
    block that reads its twiddle table through L1 (_fft_layout).  sd is
    the power of the packed spectrum (which is sum |X_k|^2), summed from
    those registers in a fixed order.  The block then untangles its
    rows into the real transform's harmonics where the model has them
    and writes Gr/Gi (several rows at once where a row has fewer pairs
    than the block threads); seed partial sums stay in registers over
    the tile, and a second, fixed-order pass adds the tiles (no float
    atomics: the same bits on every run).  Twiddles come from a host
    float64 -> float32 table (_fft_tables_np), never from sincosf.
  * fused_setup_fft_reference is the plain torch version of this
    algorithm (same passes, same table, same sd), for the tests.

Kernel note (the "rfft" route, `_launch_rfft`; every other nbin: odd,
1000, 256 q for q in 17..31, above 8192):
  * At these widths the JAX package runs no Pallas kernel (its TPU setup
    kernels take 256 q, q <= 16, only; elsewhere stats.make_setup runs
    on a plain XLA transform).  The port transforms with torch.fft.rfft
    (cuFFT) and launches one hand-written kernel after it,
    csrc/setup_epilogue.cu `pp_setup_epilogue`: the cross-spectrum over
    the prefix, the int16 scale, sd over every harmonic and the seed
    partial sums, fused into one pass over the spectrum X.
  * Bound on the H100: bytes.  The route reads x (cuFFT), writes and
    reads X, writes Gr/Gi; the fused minimum (x read, Gr/Gi written) is
    the FFT route's.
  * Design (_epilogue_geometry): a thread owns groups of 4 harmonics on
    the 16-byte boundaries of its Gr row (128-bit model loads and Gr/Gi
    stores; X by 128-bit loads where aligned too; a masked head and
    tail); a block takes a tile of the channels c = a mod 4 of one item
    (one alignment for all its rows) and a slice of each row, sized to
    the row, and walks the tile's rows, two or three blocks an SM (64
    registers a thread); sd in a register, reduced once a row (slice);
    seed partial sums in each thread's own shared-memory slots over the
    tile, then a second, fixed-order pass over the tiles (no float
    atomics).
  * setup_epilogue_reference walks the kernel's tiles on a spectrum;
    fused_setup_reference (rfft + the same cross-spectrum) stays the CPU
    path.

Host helpers band_cap_model_ft / suggest_mharm keep the JAX package's
cap rule (NH = NQ*M', M' a multiple of 8), so both packages keep the
same harmonics.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading

import numpy as np
import torch

from pulseportraiture_tpu_torch.ops.launches import counted
from pulseportraiture_tpu_torch.ops.launches import stream as _stream

_LANES = 128


def cap_supported(nbin: int) -> bool:
    """The band cap applies when nbin = NQ*128 with NQ even in [2, 32]
    (the JAX package's ct_supported: keeps the same cap set)."""
    NQ = nbin // _LANES
    return nbin % _LANES == 0 and 2 <= NQ <= 32 and NQ % 2 == 0


def cap_nharm(nbin: int, mharm: int) -> int:
    """Stored harmonics NH = NQ*M' of the cap M' (harmonics k < NH)."""
    return (nbin // _LANES) * int(mharm)


def suggest_mharm(mr, mi, nbin):
    """Smallest cap M' (a multiple of 8) with every harmonic k >= NQ*M'
    identically zero in f32 across all channels, or None when capping
    does not apply (port of ct_dft.suggest_mharm)."""
    if not cap_supported(nbin):
        return None
    NQ = nbin // _LANES
    M0 = nbin // 2 // NQ
    a = (np.abs(np.asarray(mr, np.float32)) +
         np.abs(np.asarray(mi, np.float32)))
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    nz = np.nonzero(a)[0]
    if len(nz) == 0:
        return None
    k_last = int(nz[-1])
    mh = -(-(k_last + 1) // NQ)
    mh += (-mh) % 8
    if mh >= M0:
        return None
    return mh


def band_cap_model_ft(mr, mi, nbin, rel_floor=1e-6, f0_fact=None):
    """Clean + cap a host natural-order split-real model spectrum:
    returns (mr2, mi2, mharm) as f32 numpy (port of
    ct_dft.band_cap_model_ft).  Harmonics whose amplitude across every
    channel is below rel_floor * max are zeroed; DC is zeroed unless
    f0_fact (default config.F0_FACT)."""
    if f0_fact is None:
        from pulseportraiture_tpu_torch.config import F0_FACT
        f0_fact = F0_FACT
    mr = np.asarray(mr, np.float32).copy()
    mi = np.asarray(mi, np.float32).copy()
    if not f0_fact:
        mr[..., 0] = 0.0
        mi[..., 0] = 0.0
    a = np.abs(mr) + np.abs(mi)
    if a.ndim > 1:
        a = a.max(axis=tuple(range(a.ndim - 1)))
    dead = a < rel_floor * a.max()
    mr[..., dead] = 0.0
    mi[..., dead] = 0.0
    return mr, mi, suggest_mharm(mr, mi, nbin)


def _cross_spectrum(X, mr, mi, f0_fact, w, scale):
    """The setup's outputs from the data spectrum X (..., nbin/2 + 1)."""
    dt = mr.dtype
    nh = mr.shape[-1]
    if scale is not None:
        X = X * scale.to(dt)[..., None]
    Xr, Xi = X.real, X.imag
    pw = Xr * Xr + Xi * Xi
    sd = torch.sum(pw[..., 1:], dim=-1)
    if f0_fact:
        sd = sd + pw[..., 0]
    Xr, Xi = Xr[..., :nh], Xi[..., :nh]
    Gr = Xr * mr + Xi * mi
    Gi = Xi * mr - Xr * mi
    if not f0_fact:
        Gr[..., 0] = 0.0
        Gi[..., 0] = 0.0
    if w is None:
        return Gr, Gi, sd
    w = w.to(dt)
    gsr = torch.einsum("bcs,bck->bsk", w, Gr)
    gsi = torch.einsum("bcs,bck->bsk", w, Gi)
    return Gr, Gi, sd, gsr, gsi


def fused_setup_reference(x, mr, mi, f0_fact=False, w=None, scale=None):
    """Plain torch twin of the setup kernels, in mr's dtype (rfft based)."""
    X = torch.fft.rfft(x.to(mr.dtype), dim=-1)
    return _cross_spectrum(X, mr, mi, f0_fact, w, scale)


def setup_epilogue_reference(X, mr, mi, f0_fact=False, w=None, scale=None,
                             rows=None):
    """Plain torch version of csrc/setup_epilogue.cu on a spectrum X (B,
    nchan, nhf), in mr's dtype, by the kernel's steps: X dequantized by
    scale, the cross-spectrum over the prefix k < nh, sd from the whole
    spectrum, and the seed sums as partial sums over the kernel's tiles
    (_epilogue_tile_channels: `rows` channels of one class c mod 4 a
    tile; default: one tile of every channel) added tile by tile in
    order."""
    dt = mr.dtype
    X = X.to(torch.complex128 if dt == torch.float64 else torch.complex64)
    Gr, Gi, sd = _cross_spectrum(X, mr, mi, f0_fact, None, scale)
    if w is None:
        return Gr, Gi, sd
    B, nchan, nh = Gr.shape
    w = w.to(dt)
    tiles = [torch.arange(nchan)] if rows is None else \
        _epilogue_tile_channels(nchan, rows)
    gsr = torch.zeros((B, w.shape[-1], nh), dtype=dt, device=Gr.device)
    gsi = torch.zeros_like(gsr)
    for tile in tiles:
        tile = tile.to(Gr.device)
        gsr = gsr + torch.einsum("bcs,bck->bsk", w[:, tile], Gr[:, tile])
        gsi = gsi + torch.einsum("bcs,bck->bsk", w[:, tile], Gi[:, tile])
    return Gr, Gi, sd, gsr, gsi


# what csrc/setup_fft.cu takes: nbin = 64, 128, 8192 or 256 q (q = 1..16,
# so nbin/2 = m 2^a with m odd in 1..15); one block holds rows of nbin
# samples, their nbin/2-point work buffers and (where they fit) the
# twiddle tables in shared memory, and keeps the seed sums of at most 2
# weight columns (the fit's seed stacks two) in registers
FFT_MIN_NBIN, FFT_MAX_NBIN, FFT_MAX_SEEDS = 64, 8192, 2
_NT, _SM_SMEM, _BLOCK_SMEM, _BLOCK_RESERVED = 256, 233472, 232448, 1024


def _fft_rows(B: int, nchan: int, nsm: int, per_sm: int = 2,
              wpb: int = 1) -> int:
    """Channels per block of csrc/setup_fft.cu (the tile of the seed
    partial sums): the largest power of two in 8..max(64, 8 wpb) that
    still fills nine tenths of the card's block slots, per_sm to an SM
    (wpb: rows a block transforms at once; _fft_layout).  A larger tile
    spreads a block's start-up over more rows; a card left half empty
    costs more."""
    rows = max(64, 8 * wpb)
    while rows > 8 and B * -(-nchan // rows) < 0.9 * per_sm * nsm:
        rows //= 2
    return rows


def _fft_layout(nbin: int):
    """(threads a block, threads a worker, workers a block, blocks an SM)
    of csrc/setup_fft.cu at this nbin, its Layout: a worker of nbin/32
    threads, several to a warp below a warp and else rounded up to a
    power of two; 256 threads a block, 512 (two workers) at 8192; the
    twiddle tables in shared memory where they fit beside the float32 ring
    (two groups of rows) and the work buffers; two blocks an SM where two
    blocks' shared memory fits, else one (nbin 3840, 4096 and 8192)."""
    nz = nbin // 2
    na = nz // 16
    wt = na if na < 32 and na & (na - 1) == 0 else \
        max(32, 1 << (na - 1).bit_length())
    nt = 2 * wt if wt > 128 else _NT
    wpb, hp = nt // wt, nz // 2
    rc = min(nt // hp, wpb) if hp < nt else 1
    work = 8 * max(wpb * (nz + nz // 16),
                   2 * FFT_MAX_SEEDS * nt if rc > 1 else 0)
    table = 8 * len(_fft_tables_np(nbin))
    ring = 2 * wpb * nbin * 4
    static = 2 * 8 + wpb * max(1, wt // 32) * 4 + rc * FFT_MAX_SEEDS * 8
    if ring + work + table + static <= _BLOCK_SMEM:
        work += table
    blocks = 2 if 2 * (ring + work + static + _BLOCK_RESERVED) <= \
        _SM_SMEM else 1
    return nt, wt, wpb, blocks


def setup_route(nbin: int) -> str:
    """Which hand-written kernel fused_setup launches on a CUDA tensor:
    "fft" (csrc/setup_fft.cu) for nbin = 64, 128, 8192 and every nbin =
    256 q, q = 1..16 (every nbin cap_supported takes), else "rfft"
    (torch.fft.rfft, then csrc/setup_epilogue.cu: odd nbin, 1000, 256 q for
    q in 17..31, every nbin above 8192)."""
    if nbin in (64, 128, FFT_MAX_NBIN) or (nbin % 256 == 0 and
                                          256 <= nbin <= 4096):
        return "fft"
    return "rfft"


# what csrc/setup_epilogue.cu takes: at most 2 seed columns, tiles of at
# most 128 channels, blocks of at most 512 threads; a row slice spans at
# most 1536 groups of 4 harmonics (its seed slots, 64 bytes a group at
# K = 2, stay under 100 KB of shared memory: two blocks an SM)
EPI_MAX_SEEDS, EPI_MAX_ROWS, EPI_MAX_THREADS, EPI_MAX_SLICE = 2, 128, 512, 1536
EPI_MIN_THREADS = 256

EpilogueGeometry = collections.namedtuple(
    "EpilogueGeometry",
    "tpr groups steps lanes slice nslice rows ntile threads smem")


def _epilogue_shape(nhf: int, nh: int, rows: int):
    """(tpr, groups, steps, lanes, slice, nslice) of csrc/setup_epilogue.cu
    for `rows` rows of nhf harmonics, nh of them in Gr (16-byte aligned,
    as _outputs allocates it): row r's groups of 4 harmonics start at its
    head offset (r nh mod 4), so a row needs up to (nhf + head + 3) // 4
    of them; they are cut into nslice slices of `slice` groups, as even as
    can be, each taken by `lanes` threads in `steps` steps (lanes at most
    512); tpr is lanes rounded up to a warp, and a block works on `groups`
    rows at once, so that it has at least 256 threads."""
    head = max((r * nh) % 4 for r in range(min(4, rows)))
    ng = (nhf + head + 3) // 4
    nslice = -(-ng // EPI_MAX_SLICE)
    slice_ = -(-ng // nslice)
    steps = -(-slice_ // EPI_MAX_THREADS)
    lanes = -(-slice_ // steps)
    tpr = 32 * -(-lanes // 32)
    groups = max(1, EPI_MIN_THREADS // tpr)
    return tpr, groups, steps, lanes, slice_, nslice


def _epilogue_tile_channels(nchan: int, rows: int):
    """The channels of each tile of csrc/setup_epilogue.cu, in the tiles'
    order: for each class a = 0..3 the channels c = a mod 4 in runs of
    `rows` (rows four channels apart start at one offset mod 16 bytes)."""
    tiles = []
    for a in range(min(4, nchan)):
        cls = torch.arange(a, nchan, 4)
        tiles += list(torch.split(cls, rows))
    return tiles


def _epilogue_ntile(nchan: int, rows: int) -> int:
    return sum(-(-len(range(a, nchan, 4)) // rows)
               for a in range(min(4, nchan)))


@functools.lru_cache(maxsize=64)
def _epilogue_rows(B: int, nchan: int, nslice: int, slots: int) -> int:
    """Channels a tile of csrc/setup_epilogue.cu: the largest count in
    8..128 whose blocks (items x tiles x slices) still fill nine tenths
    of the card's `slots` blocks at once.  A larger tile writes fewer
    seed partial sums (K / rows of the Gr/Gi bytes); any count will do,
    so the blocks come close to one whole wave (scripts/
    torch_epilogue_variants.py --rows times others)."""
    rows = EPI_MAX_ROWS
    while rows > 8 and B * _epilogue_ntile(nchan, rows) * nslice < \
            0.9 * slots:
        rows -= 1
    return rows


def _epilogue_geometry(B: int, nchan: int, nhf: int, nh: int, kseed: int,
                       nsm: int, per_sm) -> EpilogueGeometry:
    """csrc/setup_epilogue.cu's launch for B x nchan rows of nhf harmonics
    (nh of them in Gr) and kseed seed columns on a card of nsm SMs:
    _epilogue_shape, and _epilogue_rows for the blocks the card holds at
    once (per_sm(threads, smem): the blocks an SM holds)."""
    tpr, groups, steps, lanes, slice_, nslice = _epilogue_shape(
        nhf, nh, B * nchan)
    threads = tpr * groups
    smem = groups * steps * kseed * 2 * lanes * 16
    rows = _epilogue_rows(B, nchan, nslice, nsm * per_sm(threads, smem))
    return EpilogueGeometry(tpr, groups, steps, lanes, slice_, nslice, rows,
                            _epilogue_ntile(nchan, rows), threads, smem)


@functools.lru_cache(maxsize=64)
def _epilogue_blocks_per_sm(device_index: int, kseed: int, threads: int,
                            smem: int) -> int:
    from pulseportraiture_tpu_torch._build import load_kernels

    with torch.cuda.device(device_index):
        n = load_kernels().pp_setup_epilogue_blocks_per_sm(kseed, threads,
                                                           smem)
    if n < 1:
        raise RuntimeError(f"setup epilogue: no block of {threads} threads "
                           f"and {smem} bytes fits an SM ({n})")
    return n


def epilogue_geometry(B: int, nchan: int, nhf: int, nh: int, kseed: int,
                      device) -> EpilogueGeometry:
    """_epilogue_geometry on the card `device` (its SMs, and the blocks
    an SM holds as the CUDA occupancy calculator gives them)."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _epilogue_geometry(
        B, nchan, nhf, nh, kseed,
        torch.cuda.get_device_properties(index).multi_processor_count,
        lambda threads, smem: _epilogue_blocks_per_sm(index, kseed, threads,
                                                      smem))


@functools.lru_cache(maxsize=8)
def _twiddles_np(nbin: int):
    """e^{-2 pi i j/nbin} for j < nbin, complex128, exact at the multiples
    of nbin/4 (nbin a multiple of 4)."""
    ang = 2.0 * np.pi * np.arange(nbin, dtype=np.float64) / nbin
    tw = np.cos(ang) - 1j * np.sin(ang)
    tw[::nbin // 4] = (1.0, -1.0j, -1.0, 1.0j)
    return tw


def _fft_passes(nz: int):
    """(radix, p) of each pass of csrc/fft_passes.cuh's nz-point Stockham
    FFT, nz = m n2 with m odd and n2 a power of two, p the product of the
    earlier radices: radix 16, radix 16 again while 16 divides what is
    left of n2, then one pass of radix 2, 4 or 8; then, when m > 1, the
    odd pass (m, n2)."""
    n2 = nz & -nz
    passes, p = [], 1
    while n2 // p >= 16 and len(passes) < 2:
        passes.append((16, p))
        p *= 16
    if p < n2:
        passes.append((n2 // p, p))
    if nz > n2:
        passes.append((nz // n2, n2))
    return passes


@functools.lru_cache(maxsize=8)
def _fft_tables_np(nbin: int):
    """The twiddles of csrc/setup_fft.cu, complex128, in its order: for
    each pass (R, p) with p > 1 the runs r = 1 .. R-1 of e^{-2 pi i r
    k/(R p)}, k < p; then W^k = e^{-2 pi i k/nbin} for k <= nbin/4.  Every
    entry is one of _twiddles_np(nbin): the index is reduced mod nbin in
    integers, the value built in float64 (the kernel's copy is its
    float32 cast)."""
    tw = _twiddles_np(nbin)
    nz = nbin // 2
    runs = []
    for R, p in _fft_passes(nz):
        k = np.arange(p, dtype=np.int64)
        for r in range(1, R if p > 1 else 1):
            runs.append(tw[(r * k * (nbin // (R * p))) % nbin])
    runs.append(tw[:nz // 2 + 1])
    return np.concatenate(runs)


# each device keeps its own most recent tables: several cards and several
# nbin do not evict each other
_PER_DEVICE = 4
_device_tables = {}
_tables_lock = threading.Lock()


def _on_device(make, key, device):
    """make(*key), a host array, as a float32 tensor on `device`, cached
    per device (the _PER_DEVICE most recent keys of each)."""
    with _tables_lock:            # the shards of a mesh run in threads
        cache = _device_tables.setdefault(
            (str(torch.device(device)), make.__name__),
            collections.OrderedDict())
        t = cache.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(make(*key))).to(device)
            cache[key] = t
            while len(cache) > _PER_DEVICE:
                cache.popitem(last=False)
        else:
            cache.move_to_end(key)
        return t


def _fft_table_pairs_np(nbin: int):
    """_fft_tables_np(nbin) as float32 (re, im) pairs, the kernel's copy."""
    t = _fft_tables_np(nbin)
    return np.stack([t.real, t.imag], axis=-1).astype(np.float32)


def _fft_tables(nbin: int, device):
    return _on_device(_fft_table_pairs_np, (nbin,), device)


def _stockham_fft(z, tables):
    """The kernel's nz-point complex FFT of z (..., nz), pass by pass:
    butterfly i < nz/R of a pass (R, p) takes the points i + r nz/R,
    twiddles point r by tables' e^{-2 pi i r k/(R p)} (k = i mod p),
    transforms them and writes result m to (i - k) R + k + m p.  tables:
    _fft_tables_np(2 nz) in z's dtype."""
    nz = z.shape[-1]
    lead = z.shape[:-1]
    tw = _twiddles_np(2 * nz)
    off = 0
    for R, p in _fft_passes(nz):
        T = nz // R
        i = torch.arange(T)
        k = i & (p - 1)
        u = z.reshape(*lead, R, T)
        if p > 1:
            t = tables[off:off + (R - 1) * p].reshape(R - 1, p)[:, k]
            u = torch.cat([u[..., :1, :], u[..., 1:, :] * t], dim=-2)
            off += (R - 1) * p
        m = np.arange(R)
        dft = torch.from_numpy(tw[(np.outer(m, m) * (2 * nz // R)) %
                                  (2 * nz)]).to(z.dtype)
        y = torch.einsum("mr,...rt->...mt", dft, u)
        j = (i - k) * R + k
        out = torch.empty_like(z)
        for mm in range(R):
            out[..., j + mm * p] = y[..., mm, :]
        z = out
    return z


def fused_setup_fft_reference(x, mr, mi, f0_fact=False, w=None, scale=None):
    """Plain torch version of csrc/setup_fft.cu's own algorithm, in mr's
    dtype: the packed row's half-length Stockham FFT, the untangling step
    on the pairs (k, nbin/2 - k) with the kernel's twiddle table, the
    kernel's sd from the packed spectrum, then the twin's cross-spectrum
    and seed sums.  For the tests (packing, indices, table, int16)."""
    dt = mr.dtype
    nbin = x.shape[-1]
    if setup_route(nbin) != "fft":
        raise ValueError(f"the FFT route does not take nbin={nbin}")
    nz = nbin // 2
    ct = torch.complex128 if dt == torch.float64 else torch.complex64
    tb = _fft_tables_np(nbin)
    tables = torch.complex(torch.from_numpy(tb.real.copy()).to(dt),
                           torch.from_numpy(tb.imag.copy()).to(dt))
    xx = x.to(dt).contiguous()
    Z = _stockham_fft(torch.view_as_complex(
        xx.reshape(*xx.shape[:-1], nz, 2)), tables)
    k = torch.arange(nz // 2)
    zk, zq = Z[..., k], Z[..., (nz - k) % nz].conj()
    E, O = 0.5 * (zk + zq), 0.5 * (zk - zq)
    Tw = tables[len(tb) - (nz // 2 + 1):][k] * O
    X = torch.empty(Z.shape[:-1] + (nz + 1,), dtype=ct)
    X[..., k] = E - 1j * Tw
    X[..., nz - k] = E.conj() - 1j * Tw.conj()
    X[..., nz // 2] = Z[..., nz // 2].conj()
    out = list(_cross_spectrum(X, mr, mi, f0_fact, w, scale))
    # the kernel's data power, from the packed spectrum: the pair (X_k,
    # X_{nz-k}) carries the power of (Z_k, Z_{nz-k}); Z_0 = a + i b holds
    # X_0 = a + b and the Nyquist term a - b
    sd = torch.sum(Z[..., 1:].real ** 2 + Z[..., 1:].imag ** 2, dim=-1) + \
        (Z[..., 0].real - Z[..., 0].imag) ** 2
    if f0_fact:
        sd = sd + (Z[..., 0].real + Z[..., 0].imag) ** 2
    if scale is not None:
        sd = sd * scale.to(dt) ** 2
    out[2] = sd
    return tuple(out)


def fused_setup(x, mr, mi, f0_fact=False, w=None, scale=None):
    """(Gr, Gi, sd[, gsr, gsi]) for data x (B, nchan, nbin) against the
    shared model spectrum mr/mi (nchan, nh).

    scale: (B, nchan) dequantization for int16 x (requires f0_fact
    falsy: per-channel offsets only feed the dropped DC harmonic).
    w: stacked seed weights (B, nchan, K); gsr/gsi are (B, K, nh).  Both
    routes take K <= 2 (FFT_MAX_SEEDS, EPI_MAX_SEEDS) and raise above.
    CPU tensors take the plain twin; CUDA tensors launch the kernel that
    setup_route names for their shape (or raise): no fallback between
    the routes or to the twin.  fused_setup.launches counts the
    launches, fused_setup.routes each route's.
    """
    if scale is not None and f0_fact:
        raise ValueError("int16 ingest drops per-channel offsets into the "
                         "DC harmonic; it requires F0_FACT zeroing")
    if x.device.type == "cpu":
        return fused_setup_reference(x, mr, mi, f0_fact, w, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_setup: unsupported device {x.device}")
    _check(x, mr, mi, w, scale)
    if setup_route(x.shape[-1]) == "fft":
        return _launch_fft(x, mr, mi, bool(f0_fact), w, scale)
    return _launch_rfft(x, mr, mi, bool(f0_fact), w, scale)


fused_setup.launches = 0
fused_setup.routes = {"fft": 0, "rfft": 0}


def _check(x, mr, mi, w, scale):
    """Raise on what neither kernel takes; returns the seed column count."""
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"fused_setup: x must be (B, nchan, nbin), got "
                         f"{tuple(x.shape)}")
    B, nchan, nbin = x.shape
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"fused_setup kernel takes float32 or int16 data, "
                        f"got {x.dtype}")
    if (x.dtype == torch.int16) != (scale is not None):
        raise ValueError("fused_setup: int16 data need a scale, and only "
                         "int16 data take one")
    if mr.dim() != 2 or mr.shape[0] != nchan or mi.shape != mr.shape:
        raise ValueError(f"fused_setup: model spectrum must be (nchan, nh); "
                         f"got {tuple(mr.shape)}, {tuple(mi.shape)}")
    nh = mr.shape[-1]
    if not 0 < nh <= nbin // 2 + 1:
        raise ValueError(f"fused_setup: nh={nh} outside 1..nbin/2+1")
    args = [("mr", mr), ("mi", mi)]
    if scale is not None:
        if scale.shape != (B, nchan):
            raise ValueError(f"fused_setup: scale must be (B, nchan), got "
                             f"{tuple(scale.shape)}")
        args.append(("scale", scale))
    kseed = 0
    if w is not None:
        if w.dim() != 3 or w.shape[:2] != (B, nchan):
            raise ValueError(f"fused_setup: w must be (B, nchan, K), got "
                             f"{tuple(w.shape)}")
        kseed = w.shape[-1]
        args.append(("w", w))
    for name, t in args:
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"fused_setup kernel: {name} must be float32 on "
                            f"{dev}, got {t.dtype} on {t.device}")
    for name, t in [("x", x)] + args:
        if not t.is_contiguous():
            raise ValueError(f"fused_setup kernel: {name} must be "
                             "contiguous")
    return kseed


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _outputs(x, nh, kseed):
    B, nchan, _ = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    out = [torch.empty((B, nchan, nh), **f32),
           torch.empty((B, nchan, nh), **f32), torch.empty((B, nchan), **f32)]
    if kseed:
        out += [torch.empty((B, kseed, nh), **f32),
                torch.empty((B, kseed, nh), **f32)]
    return out


def _launched(err, lib, entry, route):
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({lib.pp_error_string(err).decode()})")
    counted(fused_setup, route)


def _launch_rfft(x, mr, mi, f0_fact, w, scale):
    """The "rfft" route on checked arguments (_check): torch.fft.rfft of
    the rows (int16 cast to float32 first; scale dequantizes after the
    transform), then csrc/setup_epilogue.cu."""
    X = torch.fft.rfft(x.float(), dim=-1)
    out = _launch_epilogue(X, mr, mi, f0_fact, w, scale)
    if x.shape[0] * x.shape[1]:
        counted(fused_setup, "rfft")
    return out


def _launch_epilogue(X, mr, mi, f0_fact, w, scale):
    """csrc/setup_epilogue.cu on a contiguous complex64 spectrum X and
    checked arguments (_check), with epilogue_geometry's launch."""
    from pulseportraiture_tpu_torch._build import load_kernels

    B, nchan, nhf = X.shape
    nh = mr.shape[-1]
    kseed = 0 if w is None else w.shape[-1]
    if kseed > EPI_MAX_SEEDS:
        raise ValueError(f"the setup epilogue takes at most {EPI_MAX_SEEDS} "
                         f"seed columns, got {kseed}")
    out = _outputs(X, nh, kseed)
    if B * nchan == 0:
        return tuple(out)
    geo = epilogue_geometry(B, nchan, nhf, nh, kseed, X.device)
    if geo.ntile > 65535 or (kseed and B > 65535):
        raise ValueError(f"setup epilogue: {geo.ntile} tiles of {geo.rows} "
                         f"channels or B={B} items outside the grid")
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty((B, geo.ntile, kseed, 2, nh), **f32) if kseed \
        else None
    sdpart = torch.empty((B, nchan, geo.nslice), **f32) \
        if geo.nslice > 1 else None
    lib = load_kernels()
    with torch.cuda.device(X.device):
        err = lib.pp_setup_epilogue(
            _ptr(X), ctypes.c_int(nhf), _ptr(mr), _ptr(mi), _ptr(scale),
            _ptr(w), ctypes.c_int(kseed), *map(_ptr, out[:3]), _ptr(sdpart),
            _ptr(part), *map(_ptr, out[3:] or (None, None)), ctypes.c_int(B),
            ctypes.c_int(nchan), ctypes.c_int(nh), ctypes.c_int(int(f0_fact)),
            *map(ctypes.c_int, (geo.rows, geo.tpr, geo.groups, geo.steps,
                                geo.lanes, geo.slice, geo.nslice)),
            _stream(X.device))
    if err != 0:
        raise RuntimeError(f"pp_setup_epilogue launch failed: CUDA error "
                           f"{err} ({lib.pp_error_string(err).decode()})")
    return tuple(out)


def _launch_fft(x, mr, mi, f0_fact, w, scale, rows=None):
    """csrc/setup_fft.cu on checked arguments (_check): rows channels per
    block (default: _fft_rows; scripts/torch_setup_tune.py sweeps it).  The
    bulk copies need a 16-byte aligned x (a row of the FFT route's nbin,
    a multiple of 64, is a multiple of 16 bytes)."""
    from pulseportraiture_tpu_torch._build import load_kernels

    B, nchan, nbin = x.shape
    if setup_route(nbin) != "fft":
        raise ValueError(f"the FFT setup kernel does not take nbin={nbin}")
    if rows is None:
        _, _, wpb, per_sm = _fft_layout(nbin)
        rows = _fft_rows(B, nchan, torch.cuda.get_device_properties(
            x.device).multi_processor_count, per_sm, wpb)
    nh = mr.shape[-1]
    kseed = 0 if w is None else w.shape[-1]
    if kseed > FFT_MAX_SEEDS:
        raise ValueError(f"the FFT setup kernel takes at most "
                         f"{FFT_MAX_SEEDS} seed columns, got {kseed}")
    if x.data_ptr() % 16:
        raise ValueError("fused_setup kernel: x must start on a 16-byte "
                         "boundary (an offset view does not)")
    if B > 65535:
        raise ValueError(f"fused_setup kernel: B={B} above 65535 items")
    tw = _fft_tables(nbin, x.device)
    out = _outputs(x, nh, kseed)
    part = None
    if kseed:
        part = torch.empty((B, -(-nchan // rows), kseed, 2, nh),
                           dtype=torch.float32, device=x.device)
    if B * nchan:
        lib = load_kernels()
        # with x's device current: the entry sets the kernel's shared
        # memory attribute (per-device state) and launches in its context
        with torch.cuda.device(x.device):
            err = lib.pp_fused_setup_fft(
                _ptr(x), ctypes.c_int(int(x.dtype == torch.int16)), _ptr(tw),
                ctypes.c_int(tw.shape[0]), _ptr(mr), _ptr(mi), _ptr(scale),
                _ptr(w), ctypes.c_int(kseed), *map(_ptr, out[:3]), _ptr(part),
                *map(_ptr, out[3:] or (None, None)), ctypes.c_int(B),
                ctypes.c_int(nchan), ctypes.c_int(nbin), ctypes.c_int(nh),
                ctypes.c_int(int(f0_fact)), ctypes.c_int(rows),
                _stream(x.device))
        _launched(err, lib, "pp_fused_setup_fft", "fft")
    return tuple(out)
