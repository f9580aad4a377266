"""The Newton loop's trust-region subproblem: CUDA kernel + plain twin.

For each item of a batch, the exact step argmin g.p + 0.5 p H p over
|p| <= radius (Moré–Sorensen on the n x n Hessian, n <= 8), solved in
float64 whatever the working dtype, on a scale-normalized copy (H/s, g/s
with s = max(max|H|, 1)): the same minimizer, and the secular iteration
stays conditioned for objectives whose curvatures reach ~1e13.  (A
float32 eigh resolves eigenvalues only to ~1e-7 of the largest: the fits'
weakest directions, alpha and tau, lie below that, and their steps come
out several times too short.)

Kernel notes:
  * csrc/tr_solve.cu `pp_tr_solve` replaces no TPU kernel: the JAX
    package's fitters/newton.py `_tr_solve` is plain jnp, which XLA fuses.
    Its eager form here (tr_solve_reference) is 676 launches a solve on
    the card and a host sync in torch.linalg.eigh's error check, twice a
    Newton iteration; the kernel is one launch and no sync.
  * One thread an item: cyclic Jacobi on the normalized matrix in
    registers (n a template argument), to exact zero off the diagonal,
    then tr_solve_reference's formulas: the interior test, 25 secular
    steps from mu = floor + 1, the boundary step clamped to the radius,
    the hard case.  Latency-bound: a batch of 64 5 x 5 items is ~8 kB.
  * The kernel reads g, H and radius in the working dtype (float32 or
    float64) through their strides: one solve is one launch, with no
    casts or copies around it.
"""

from __future__ import annotations

import ctypes

import torch

from pulseportraiture_tpu_torch.ops.launches import counted
from pulseportraiture_tpu_torch.ops.launches import stream as _stream

# what the kernel takes: n x n Hessians, n in 1..MAX_N (a template
# argument), and a one-dimensional grid of at most 2^31 - 1 blocks of
# THREADS items
MAX_N, THREADS, MAX_BLOCKS = 8, 32, 2 ** 31 - 1


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def tr_solve_reference(g, H, radius, hard_case=False):
    """Plain torch (p in g's dtype, hit = the step is not interior), batched
    over leading axes: torch.linalg.eigh and the secular iteration in
    float64.  hard_case: negative curvature that g barely sees gets the
    rest of the radius along the lowest eigenvector (Moré–Sorensen)."""
    dtype = g.dtype
    g, H, radius = g.double(), H.double(), radius.double()
    one = torch.ones((), dtype=H.dtype, device=H.device)
    s = torch.maximum(torch.amax(torch.abs(H), dim=(-2, -1)), one)
    g = g / s[..., None]
    H = H / s[..., None, None]
    lam, V = torch.linalg.eigh(H)
    gt = _mv(V.transpose(-1, -2), g)
    lam_min = lam[..., 0]
    eps = 10.0 * torch.finfo(g.dtype).eps
    zero = torch.zeros_like(lam_min)

    def p_of(mu):
        return gt / (lam + mu[..., None])

    def norm_of(mu):
        return torch.sqrt(torch.sum(p_of(mu) ** 2, dim=-1) + eps * eps)

    floor = torch.maximum(zero, -lam_min) + eps
    interior_ok = (lam_min > 0.0) & (norm_of(zero) <= radius)
    mu = floor + 1.0
    for _ in range(25):
        pn = norm_of(mu)
        phi = 1.0 / pn - 1.0 / radius
        dphi = torch.sum(gt ** 2 / (lam + mu[..., None]) ** 3,
                         dim=-1) / pn ** 3
        step = phi / torch.where(dphi > 0.0, dphi, torch.ones_like(dphi))
        mu = torch.maximum(mu - step, floor)
    p_boundary = -_mv(V, p_of(mu))
    pb_norm = torch.sqrt(torch.sum(p_boundary ** 2, dim=-1) + eps * eps)
    p_boundary = p_boundary * torch.clamp(radius / pb_norm,
                                          max=1.0)[..., None]
    if hard_case:
        # negative curvature that g barely sees: p(mu) at the floor stays
        # inside the region, so the rest of the radius goes along the
        # lowest eigenvector, downhill (Moré–Sorensen's hard case)
        short = (lam_min < 0.0) & (pb_norm < radius)
        v0 = V[..., :, 0]
        sgn = torch.where(gt[..., 0] > 0.0, -1.0, 1.0)
        t = torch.sqrt(torch.clamp(radius ** 2 - pb_norm ** 2, min=0.0))
        p_boundary = torch.where(short[..., None],
                                 p_boundary + (sgn * t)[..., None] * v0,
                                 p_boundary)
    p_interior = -_mv(V, p_of(zero))
    p = torch.where(interior_ok[..., None], p_interior, p_boundary)
    return p.to(dtype), ~interior_ok


def tr_solve(g, H, radius, hard_case=False):
    """(p (..., n) in g's dtype, hit (...,) bool) from g (..., n), H
    (..., n, n) and radius (...,): the trust-region step of each item and
    whether it is not interior.

    CPU tensors take the plain twin; CUDA tensors launch the kernel (or
    raise): there is no fallback between the two.
    """
    if g.device.type == "cpu":
        return tr_solve_reference(g, H, radius, hard_case=hard_case)
    if g.device.type != "cuda":
        raise ValueError(f"tr_solve: unsupported device {g.device}")
    return _launch(g, H, radius, hard_case)


tr_solve.launches = 0


def _launch(g, H, radius, hard_case):
    from pulseportraiture_tpu_torch._build import load_kernels

    for name, t in (("H", H), ("radius", radius)):
        if t.device != g.device:
            raise ValueError(f"tr_solve: {name} is on {t.device}, g on "
                             f"{g.device}")
        if t.dtype != g.dtype:
            raise TypeError(f"tr_solve kernel: {name} is {t.dtype}, g "
                            f"{g.dtype}")
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tr_solve kernel takes float32 or float64; g is "
                        f"{g.dtype}")
    n = g.shape[-1] if g.dim() else 0
    lead = tuple(g.shape[:-1])
    if not 0 < n <= MAX_N:
        raise ValueError(f"tr_solve kernel: n={n} outside 1..{MAX_N}")
    if H.shape != g.shape + (n,) or radius.shape != lead:
        raise ValueError(f"tr_solve: shapes g {tuple(g.shape)}, H "
                         f"{tuple(H.shape)}, radius {tuple(radius.shape)}")
    items = g.numel() // n
    if -(-items // THREADS) > MAX_BLOCKS:
        raise ValueError(f"tr_solve kernel: {items} items need more than "
                         f"{MAX_BLOCKS} blocks of {THREADS}")
    try:
        # one batch axis, as views: the kernel reads through the strides
        g2, H2 = g.view(items, n), H.view(items, n, n)
        r1 = radius.view(items)
    except RuntimeError as e:
        raise ValueError(f"tr_solve kernel: the leading axes of g, H and "
                         f"radius must flatten to one axis as views ({e})")
    p = torch.empty((items, n), dtype=g.dtype, device=g.device)
    hit = torch.empty((items,), dtype=torch.bool, device=g.device)
    if items:
        lib = load_kernels()
        with torch.cuda.device(g.device):
            err = lib.pp_tr_solve(
                ctypes.c_void_p(g2.data_ptr()), g2.stride(0), g2.stride(1),
                ctypes.c_void_p(H2.data_ptr()), H2.stride(0), H2.stride(1),
                H2.stride(2), ctypes.c_void_p(r1.data_ptr()), r1.stride(0),
                ctypes.c_void_p(p.data_ptr()),
                ctypes.c_void_p(hit.data_ptr()), items, n,
                int(g.dtype == torch.float64), int(bool(hard_case)),
                _stream(g.device))
        if err != 0:
            raise RuntimeError(f"pp_tr_solve launch failed: CUDA error {err} "
                               f"({lib.pp_error_string(err).decode()})")
        counted(tr_solve)
    return p.view(g.shape), hit.view(lead)
